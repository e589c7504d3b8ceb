"""The PyTorch port's front-end ops against the JAX package, on the CPU.

The same numpy inputs (fixed seeds) go through the JAX function and the
port's plain PyTorch version (the version a kernel wrapper runs for CPU
tensors; the CUDA kernels are held to these on the card by chip_smoke.py).
Integer ops (pyramid K2, FAST + mask K4/K6, grid ops K5/K8) must match
exactly; float ops carry a stated tolerance.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from uav_airvision_tpu.models.frontend import pipeline as jpipe
from uav_airvision_tpu.ops import camera as jcam
from uav_airvision_tpu.ops import extract as jext
from uav_airvision_tpu.ops import fast as jfast
from uav_airvision_tpu.ops import gridops as jgrid
from uav_airvision_tpu.ops import lk as jlk
from uav_airvision_tpu.ops import pyramid as jpyr
from uav_airvision_tpu_torch.ops import camera as tcam
from uav_airvision_tpu_torch.ops import fast as tfast
from uav_airvision_tpu_torch.ops import gridops as tgrid
from uav_airvision_tpu_torch.ops import lk as tlk
from uav_airvision_tpu_torch.ops import pyramid as tpyr


def textured(H, W, seed=0, cell=8):
    """Smooth random texture + sensor noise, uint8 (numpy only)."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(0, 255, (H // cell + 2, W // cell + 2))
    ys = np.arange(H) / cell
    xs = np.arange(W) / cell
    y0, x0 = np.floor(ys).astype(int), np.floor(xs).astype(int)
    ay, ax = (ys - y0)[:, None], (xs - x0)[None, :]
    img = ((1 - ay) * (1 - ax) * base[y0][:, x0] + (1 - ay) * ax * base[y0][:, x0 + 1]
           + ay * (1 - ax) * base[y0 + 1][:, x0] + ay * ax * base[y0 + 1][:, x0 + 1])
    return np.clip(img + rng.normal(0, 2, (H, W)), 0, 255).astype(np.uint8)


def shifted(img, dx, dy):
    """Bilinear sub-pixel shift (REFLECT_101 borders), uint8."""
    H, W = img.shape
    ys = np.arange(H)[:, None] - dy
    xs = np.arange(W)[None, :] - dx
    y0, x0 = np.floor(ys).astype(int), np.floor(xs).astype(int)
    ay, ax = ys - y0, xs - x0

    def r(i, n):
        i = np.abs(i)
        return np.where(i >= n, 2 * (n - 1) - i, i)

    f = img.astype(np.float64)
    out = ((1 - ay) * (1 - ax) * f[r(y0, H), r(x0, W)] + (1 - ay) * ax * f[r(y0, H), r(x0 + 1, W)]
           + ay * (1 - ax) * f[r(y0 + 1, H), r(x0, W)] + ay * ax * f[r(y0 + 1, H), r(x0 + 1, W)])
    return np.clip(np.round(out), 0, 255).astype(np.uint8)


@pytest.mark.parametrize("H,W", [(96, 128), (480, 752)])
def test_pyramid_levels_exact(H, W):
    img = textured(H, W, seed=H)
    want = jpyr.build_pyramid_padded(jnp.asarray(img), 3)
    got = tpyr.build_pyramid_padded(torch.as_tensor(img), 3)
    assert got.n_levels == 4
    for L in range(4):
        np.testing.assert_array_equal(got.levels[L].numpy(), np.asarray(want[L]),
                                      err_msg=f"level {L}")


def _mask_points(rng, H, W, n=30):
    pts = rng.uniform([0, 0], [W - 1, H - 1], (n, 2)).astype(np.float32)
    pts[:4] = [[1.5, 40.0], [60.2, 2.7], [0.3, 0.9], [2.99, 3.0]]  # x<3 or y<3
    valid = rng.uniform(size=n) < 0.8
    return pts, valid


@pytest.mark.parametrize("masked", [False, True])
def test_fast_masked_exact(masked):
    H, W = 120, 160
    img = textured(H, W, seed=3, cell=4)
    rng = np.random.default_rng(4)
    pts, valid = _mask_points(rng, H, W)
    if masked:
        jmask = jpipe._detection_mask((H, W), jnp.asarray(pts), jnp.asarray(valid))
        jkeep, jscore = jfast.detect_fast(jnp.asarray(img), 15, mask=jmask)
        tkeep, tscore = tfast.detect_fast(torch.as_tensor(img), 15, torch.as_tensor(pts),
                                          torch.as_tensor(valid))
        np.testing.assert_array_equal(
            tfast.detection_mask((H, W), torch.as_tensor(pts), torch.as_tensor(valid)).numpy(),
            np.asarray(jmask))
    else:
        jkeep, jscore = jfast.detect_fast(jnp.asarray(img), 15)
        tkeep, tscore = tfast.detect_fast(torch.as_tensor(img), 15)
    assert np.asarray(jkeep).sum() > 20
    np.testing.assert_array_equal(tkeep.numpy(), np.asarray(jkeep))
    np.testing.assert_array_equal(tscore.numpy(), np.asarray(jscore))


def test_gridops_exact_on_ties():
    rng = np.random.default_rng(5)
    # dense top-k with heavy ties (scores from a small range)
    score = rng.integers(-1, 6, (480, 752)).astype(np.int32)
    for k in (5, 8):
        want = jgrid.dense_grid_topk(jnp.asarray(score), 4, 5, k)
        got = tgrid.dense_grid_topk(torch.as_tensor(score), 4, 5, k)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    n, n_cells = 208, 20
    cell = rng.integers(0, n_cells, n).astype(np.int32)
    primary = rng.integers(0, 4, n).astype(np.float32)
    arrival = rng.integers(0, 50, n).astype(np.int32)
    valid = rng.uniform(size=n) < 0.7
    j_rank, j_perm = jgrid.rank_in_cell(jnp.asarray(cell), jnp.asarray(primary),
                                        jnp.asarray(arrival), jnp.asarray(valid), n_cells)
    t_rank, t_perm = tgrid.rank_in_cell(torch.as_tensor(cell), torch.as_tensor(primary),
                                        torch.as_tensor(arrival), torch.as_tensor(valid),
                                        n_cells)
    np.testing.assert_array_equal(t_rank.numpy(), np.asarray(j_rank))
    np.testing.assert_array_equal(t_perm.numpy(), np.asarray(j_perm))
    keep = valid & (np.asarray(j_rank) < 3)
    for w, g in zip(jgrid.kept_order_stats(j_perm, jnp.asarray(keep), jnp.asarray(cell),
                                           jnp.asarray(valid), n_cells),
                    tgrid.kept_order_stats(t_perm, torch.as_tensor(keep),
                                           torch.as_tensor(cell), torch.as_tensor(valid),
                                           n_cells)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for w, g in zip(jgrid.compact_kept(j_perm, jnp.asarray(keep), 104),
                    tgrid.compact_kept(t_perm, torch.as_tensor(keep), 104)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    key = rng.integers(0, 30, 256).astype(np.int32)
    for k in (16, 64):
        np.testing.assert_array_equal(
            tgrid.smallest_k_indices(torch.as_tensor(key), k).numpy(),
            np.asarray(jgrid.smallest_k_indices(jnp.asarray(key), k)))
    np.testing.assert_array_equal(
        tgrid.stable_compact_indices(torch.as_tensor(valid), n).numpy(),
        np.asarray(jgrid.stable_compact_indices(jnp.asarray(valid), n)))
    pts = rng.uniform([0, 0], [752, 480], (100, 2)).astype(np.float32)
    np.testing.assert_array_equal(
        tgrid.cell_of_points(torch.as_tensor(pts), 4, 5, 480, 752).numpy(),
        np.asarray(jgrid.cell_of_points(jnp.asarray(pts), 4, 5, 480, 752)))


@pytest.mark.parametrize("model,coeffs", [
    ("radtan", (-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05)),
    ("equidistant", (-0.0113, 0.0052, -0.0021, 0.0005)),
])
def test_camera_model_matches(model, coeffs):
    """float32 on both sides.  Undistorted (normalized) points within 1e-6;
    pixel outputs within one float32 ulp at 752 px (6.1e-5 px; float32
    cannot resolve 1e-6 px there): radtan is bit-equal, the equidistant
    model's arctan/tan round differently in the two frameworks."""
    px_ulp = float(np.spacing(np.float32(752.0)))
    rng = np.random.default_rng(6)
    intr = np.array([458.654, 457.296, 367.215, 248.375], np.float32)
    co = np.array(coeffs, np.float32)
    pts = rng.uniform([5, 5], [747, 475], (208, 2)).astype(np.float32)
    R = np.array([[0.9998, -0.0175, 0.0087], [0.0174, 0.9998, 0.0087],
                  [-0.0089, -0.0085, 0.9999]], np.float32)
    jintr, jco = jnp.asarray(intr), jnp.asarray(co)
    tintr, tco = torch.as_tensor(intr), torch.as_tensor(co)
    und_j = jcam.undistort_points(jnp.asarray(pts), jintr, model, jco, rectification=jnp.asarray(R))
    und_t = tcam.undistort_points(torch.as_tensor(pts), tintr, model, tco,
                                  rectification=torch.as_tensor(R))
    np.testing.assert_allclose(und_t.numpy(), np.asarray(und_j), atol=1e-6, rtol=0)
    dis_j = jcam.distort_points(und_j, jintr, model, jco)
    dis_t = tcam.distort_points(torch.as_tensor(np.array(und_j)), tintr, model, tco)
    np.testing.assert_allclose(dis_t.numpy(), np.asarray(dis_j), atol=px_ulp, rtol=0)
    war_j = jcam.homography_warp_points(jnp.asarray(pts), jnp.asarray(R), jintr)
    war_t = tcam.homography_warp_points(torch.as_tensor(pts), torch.as_tensor(R), tintr)
    np.testing.assert_allclose(war_t.numpy(), np.asarray(war_j), atol=px_ulp, rtol=0)


def _lk_points(rng, H, W):
    """~40 points: interior, near the image border, and far enough from
    their start to reach the search-window freeze bound."""
    pts = np.concatenate([
        rng.uniform([20, 20], [W - 20, H - 20], (28, 2)),
        np.array([[2.0, 60.0], [W - 3.0, 50.0], [80.0, 1.5], [70.0, H - 2.5],
                  [-1.0, 30.0], [5.5, 5.5]]),
        rng.uniform([30, 30], [W - 30, H - 30], (6, 2)),
    ]).astype(np.float32)
    init = pts.copy()
    init[-6:] += rng.uniform(-14, 14, (6, 2)).astype(np.float32)  # far seeds
    valid = np.ones(len(pts), bool)
    valid[3] = False
    return pts, init, valid


@pytest.mark.parametrize("n_levels,max_iter_upper", [(2, 5), (4, 5), (1, None)],
                         ids=["two-level-seeded", "four-level", "level0-only"])
def test_lk_matches_jax(n_levels, max_iter_upper):
    """Status agrees on >= 99% of points and agreeing points lie within
    1e-3 px.  The tolerance is needed because JAX samples the window with
    one-hot matmuls over 48-px bands while the port reads four bilinear taps,
    so sums run in another order; a point near a convergence or freeze
    threshold can then end one iteration apart."""
    H, W = 120, 160
    img0 = textured(H, W, seed=7, cell=6)
    img1 = shifted(img0, 2.6, -1.7)
    rng = np.random.default_rng(8)
    pts, init, valid = _lk_points(rng, H, W)
    jp0 = jext.band_pyramid(jpyr.build_pyramid_padded(jnp.asarray(img0), 3), dtype=jnp.bfloat16)
    jp1 = jext.band_pyramid(jpyr.build_pyramid_padded(jnp.asarray(img1), 3), dtype=jnp.bfloat16)
    jlk_call = jax.jit(functools.partial(
        jlk.pyramidal_lk_banded, win=15, max_iter=10, eps=0.01, min_eig_threshold=1e-4,
        n_levels=n_levels, static_iters=True, max_iter_upper=max_iter_upper))
    jn, js = jlk_call(jp0, jp1, jnp.asarray(pts), jnp.asarray(init), jnp.asarray(valid))
    tp0 = tpyr.build_pyramid_padded(torch.as_tensor(img0), 3)
    tp1 = tpyr.build_pyramid_padded(torch.as_tensor(img1), 3)
    tn, ts = tlk.pyramidal_lk(tp0, tp1, torch.as_tensor(pts), torch.as_tensor(init),
                              torch.as_tensor(valid), win=15, max_iter=10, eps=0.01,
                              min_eig_threshold=1e-4, n_levels=n_levels,
                              max_iter_upper=max_iter_upper)
    jn, js = np.asarray(jn), np.asarray(js)
    tn, ts = tn.numpy(), ts.numpy()
    assert (ts == js).mean() >= 0.99
    both = ts & js
    assert both.sum() >= 20
    np.testing.assert_allclose(tn[both], jn[both], atol=1e-3, rtol=0)


def _score_map(case, H, W):
    """int32 score maps as the NMS leaves them: mostly zero, with ties."""
    rng = np.random.default_rng(len(case))
    if case == "heavy_ties":
        return rng.integers(-1, 6, (H, W)).astype(np.int32)
    score = np.zeros((H, W), np.int32)
    n = H * W // 200
    score[rng.integers(0, H, n), rng.integers(0, W, n)] = rng.integers(1, 4, n)
    if case == "empty_cells":  # whole cells without a corner, one with fewer than k
        score[: H // 2] = 0
        score[H // 2:, : W // 5] = 0
        score[H - 3, 5] = 7
    return score


@pytest.mark.parametrize("case,H,W", [("heavy_ties", 480, 752), ("sparse", 480, 752),
                                      ("empty_cells", 480, 752), ("sparse", 97, 131)])
@pytest.mark.parametrize("k", [5, 8])
def test_dense_grid_topk_exact(case, H, W, k):
    """K5's plain version (what the wrapper runs on CPU tensors) against the
    JAX function, exactly: ties by in-cell index, cells padded with -1
    (neither 752 nor 131 is a multiple of 5), empty cells."""
    score = _score_map(case, H, W)
    want = jgrid.dense_grid_topk(jnp.asarray(score), 4, 5, k)
    got = tgrid.dense_grid_topk(torch.as_tensor(score), 4, 5, k)
    for w, g in zip(want, got):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if case == "empty_cells":
        assert (got[2].numpy() <= 0).any()


@pytest.mark.parametrize("n", [20, 100, 160, 204, 256])
def test_k8_ranking_exact(n):
    """K8's plain versions against the JAX functions, exactly, with heavy
    ties in every key, invalid entries and the sizes the main path uses."""
    rng = np.random.default_rng(n)
    n_cells = 20
    cell = rng.integers(0, n_cells, n).astype(np.int32)
    primary = rng.integers(0, 3, n).astype(np.float32)
    arrival = rng.integers(0, 6, n).astype(np.int32)
    valid = rng.uniform(size=n) < 0.7
    j_rank, j_perm = jgrid.rank_in_cell(jnp.asarray(cell), jnp.asarray(primary),
                                        jnp.asarray(arrival), jnp.asarray(valid), n_cells)
    t_rank, t_perm = tgrid.rank_in_cell(torch.as_tensor(cell), torch.as_tensor(primary),
                                        torch.as_tensor(arrival), torch.as_tensor(valid),
                                        n_cells)
    np.testing.assert_array_equal(t_rank.numpy(), np.asarray(j_rank))
    np.testing.assert_array_equal(t_perm.numpy(), np.asarray(j_perm))
    assert t_rank.dtype == t_perm.dtype == torch.int32
    keep = valid & (np.asarray(j_rank) < 2)
    for w, g in zip(jgrid.kept_order_stats(j_perm, jnp.asarray(keep), jnp.asarray(cell),
                                           jnp.asarray(valid), n_cells),
                    tgrid.kept_order_stats(t_perm, torch.as_tensor(keep),
                                           torch.as_tensor(cell), torch.as_tensor(valid),
                                           n_cells)):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for slots in (104, max(int(keep.sum()), 1)):
        for w, g in zip(jgrid.compact_kept(j_perm, jnp.asarray(keep), slots),
                        tgrid.compact_kept(t_perm, torch.as_tensor(keep), slots)):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    key = rng.integers(0, 9, n).astype(np.int32)
    key[::5] = np.iinfo(np.int32).max  # the back-end's "not a candidate" key
    for k in (16, 64, 128):
        np.testing.assert_array_equal(
            tgrid.smallest_k_indices(torch.as_tensor(key), k).numpy(),
            np.asarray(jgrid.smallest_k_indices(jnp.asarray(key), k)))
    for mask in (valid, np.zeros(n, bool), np.ones(n, bool)):
        np.testing.assert_array_equal(
            tgrid.stable_compact_indices(torch.as_tensor(mask), n).numpy(),
            np.asarray(jgrid.stable_compact_indices(jnp.asarray(mask), n)))


@pytest.mark.parametrize("rectify", [False, True], ids=["plain", "rectified"])
@pytest.mark.parametrize("model,coeffs", [
    ("radtan", (-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05)),
    ("equidistant", (-0.0113, 0.0052, -0.0021, 0.0005)),
])
def test_camera_k7_forms_match(model, coeffs, rectify):
    """K7's plain versions against the JAX functions in the forms the main
    path calls them: one camera's values for all points and one set per
    point (the two-camera publish), and the fused stereo prologue against
    the JAX package's two calls.  Normalized points within 1e-6, pixels
    within one float32 ulp at 752 px, as test_camera_model_matches."""
    px_ulp = float(np.spacing(np.float32(752.0)))
    rng = np.random.default_rng(9)
    intr0 = np.array([458.654, 457.296, 367.215, 248.375], np.float32)
    intr1 = np.array([457.587, 456.134, 379.999, 255.238], np.float32)
    co0 = np.array(coeffs, np.float32)
    co1 = (co0 * 0.9).astype(np.float32)
    F = 104
    pts = rng.uniform([5, 5], [747, 475], (2 * F, 2)).astype(np.float32)
    R = np.array([[0.9998, -0.0175, 0.0087], [0.0174, 0.9998, 0.0087],
                  [-0.0089, -0.0085, 0.9999]], np.float32) if rectify else None
    jR = None if R is None else jnp.asarray(R)
    tR = None if R is None else torch.as_tensor(R)
    # per-point values: cam0's for the first F points, cam1's for the rest
    per_pt = [np.concatenate([np.full(F, a), np.full(F, b)]).astype(np.float32)
              for a, b in zip(np.concatenate([intr0, co0]), np.concatenate([intr1, co1]))]
    want = jcam.undistort_points(jnp.asarray(pts), tuple(map(jnp.asarray, per_pt[:4])), model,
                                 tuple(map(jnp.asarray, per_pt[4:])), rectification=jR)
    got = tcam.undistort_points(torch.as_tensor(pts), torch.as_tensor(np.stack(per_pt[:4])),
                                model, torch.as_tensor(np.stack(per_pt[4:])), rectification=tR)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)
    if rectify:
        und_j = jcam.undistort_points(jnp.asarray(pts), jnp.asarray(intr0), model,
                                      jnp.asarray(co0), rectification=jR)
        dis_j = jcam.distort_points(und_j, jnp.asarray(intr0), model, jnp.asarray(co0))
        und_t, dis_t = tcam.undistort_distort_points(
            torch.as_tensor(pts), torch.as_tensor(intr0), model, torch.as_tensor(co0), tR)
        np.testing.assert_allclose(und_t.numpy(), np.asarray(und_j), atol=1e-6, rtol=0)
        # the port's undistorted points differ by an ulp of the normalized
        # coordinate, which fx carries into the pixel: two ulp here
        np.testing.assert_allclose(dis_t.numpy(), np.asarray(dis_j), atol=2 * px_ulp, rtol=0)
    else:
        new = (460.0, 459.0, 370.0, 240.0)
        want = jcam.undistort_points(jnp.asarray(pts), jnp.asarray(intr0), model,
                                     jnp.asarray(co0), new_intrinsics=new)
        got = tcam.undistort_points(torch.as_tensor(pts), torch.as_tensor(intr0), model,
                                    torch.as_tensor(co0), new_intrinsics=new)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=px_ulp, rtol=0)
