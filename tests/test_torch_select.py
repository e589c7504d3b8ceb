"""The fused front-end entry points' plain versions against the JAX package,
on the CPU: the per-cell selection of a tracked frame (``select_track``, K8),
the IMU-rotation prediction with its warp (``predict_warp_points``, K7) and
the stereo matcher's cuts after the backward LK (``stereo_gate``, K7).

The same numpy inputs (fixed seeds) go through the JAX expressions that
these functions replace (built here from the JAX package's functions, as
its front-end composes them) and through the port's wrapper on CPU tensors,
which runs the plain version.  The card's kernels are held to these plain
versions in tests/test_torch_cuda.py and chip_smoke.py.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from uav_airvision_tpu.config import euroc_config as jax_euroc_config
from uav_airvision_tpu.models.frontend import pipeline as jpipe
from uav_airvision_tpu.models.frontend.params import make_frontend_params as jax_params
from uav_airvision_tpu.ops import camera as jcam
from uav_airvision_tpu.ops import gridops as jgrid
from uav_airvision_tpu.utils import quaternion as jquat
from uav_airvision_tpu_torch.config import euroc_config
from uav_airvision_tpu_torch.models.frontend import pipeline as tpipe
from uav_airvision_tpu_torch.models.frontend.params import make_frontend_params
from uav_airvision_tpu_torch.ops import camera as tcam
from uav_airvision_tpu_torch.ops import gridops as tgrid
from tests.torch_select_inputs import CASES, select_inputs
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

PX_ULP = float(np.spacing(np.float32(752.0)))  # one float32 ulp at 752 px
ONE_ULP = float(np.spacing(np.float32(1.0)))


def _jax_select(curr, cam1_curr, tracked, ids, lifetime, apts, ascore, aarrival, ainlier, acam1,
                next_id, gr, gc, H, W, gmin, gmax):
    """uav_airvision_tpu/models/frontend/pipeline.py:388-440, verbatim."""
    n_cells = gr * gc
    F = curr.shape[0]
    tr_cell = jgrid.cell_of_points(curr, gr, gc, H, W)
    tr_life = lifetime + 1
    acell = jgrid.cell_of_points(apts, gr, gc, H, W)
    arank, aperm = jgrid.rank_in_cell(acell, ascore.astype(jnp.float32), aarrival, ainlier,
                                      n_cells)
    akeep = ainlier & (arank < gmin)
    a_grank, a_crank, a_kept = jgrid.kept_order_stats(aperm, akeep, acell, ainlier, n_cells)
    aids = jnp.where(akeep, next_id + a_grank, -1)
    C = apts.shape[0]
    all_cell = jnp.concatenate([tr_cell, acell])
    all_life = jnp.concatenate([tr_life, jnp.ones((C,), jnp.int32)])
    all_valid = jnp.concatenate([tracked, akeep])
    all_ids = jnp.concatenate([ids, aids])
    all_cam0 = jnp.concatenate([curr, apts])
    all_cam1 = jnp.concatenate([cam1_curr, acam1])
    arrival = jnp.concatenate([jnp.arange(F, dtype=jnp.int32), F + a_crank.astype(jnp.int32)])
    onehot = (all_cell[:, None] == jnp.arange(n_cells)[None, :]) & all_valid[:, None]
    overflow = jnp.sum(onehot.astype(jnp.int32), axis=0) > gmax
    of_this = jnp.where(all_valid, overflow[jnp.clip(all_cell, 0, n_cells - 1)], False)
    sort_life = jnp.where(of_this, all_life, 0)
    prank, pperm = jgrid.rank_in_cell(all_cell, sort_life.astype(jnp.float32), arrival,
                                      all_valid, n_cells)
    keep = all_valid & (prank < gmax)
    sel, selm = jgrid.compact_kept(pperm, keep, F)
    return (jnp.where(selm, all_ids[sel], -1), jnp.where(selm, all_life[sel], 0),
            jnp.where(selm[:, None], all_cam0[sel], 0.0),
            jnp.where(selm[:, None], all_cam1[sel], 0.0), selm,
            (next_id + a_kept).astype(jnp.int32))


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("F,C", [(104, 100), (100, 100), (1300, 200)])
def test_select_track_matches_jax(F, C, case):
    """The per-cell selection on the CPU equals the JAX package's
    composition exactly, on all six outputs, with heavy ties in score,
    arrival and lifetime, overflowing cells, all-invalid groups and, in
    the ``full`` case at F = C, every slot kept; at the main path's F = 104,
    C = 100, at F = C = 100 and at 1,300 slots."""
    arrays, statics = select_inputs(F + C + len(case), F, C, case)
    want = _jax_select(*map(jnp.asarray, arrays), *statics)
    got = tgrid.select_track(*map(torch.as_tensor, arrays), *statics)
    for g, w, dtype in zip(got, want, (torch.int32, torch.int32, torch.float32, torch.float32,
                                       torch.bool, torch.int32)):
        assert g.dtype == dtype
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    n_kept = int(got[4].sum())
    if case == "invalid":
        assert n_kept == 0 and int(got[5]) == int(arrays[-1])
    if case == "full":
        assert n_kept == min(F, C)


@pytest.mark.parametrize("w,dt", [((0.0, 0.0, 0.0), 0.05), ((0.3, -0.2, 0.1), 0.05),
                                  ((2.0, 1.0, -3.0), 0.05), ((0.3, -0.2, 0.1), 0.0)],
                         ids=["zero", "hover", "fast", "dt0"])
def test_predict_warp_matches_jax(w, dt):
    """The rotation prediction and warp of the previous frame's points
    against JAX ``predicted_rotations`` (cam0's) and
    ``homography_warp_points``: the rotation within 4 float32 ulps of 1.0,
    the points within 4 float32 ulps at 752 px (the bars the kernel meets
    against this plain version on the card); zero rotation and dt = 0 give
    the identity.  The port's ``predicted_rotations`` gives both cameras'
    rotations as JAX does."""
    rng = np.random.default_rng(12)
    pts = rng.uniform([5, 5], [747, 475], (104, 2)).astype(np.float32)
    wv, dtv = np.asarray(w, np.float32), np.float32(dt)
    jp = jax_params(jax_euroc_config())
    tp = make_frontend_params(euroc_config(), "cpu")
    jR0, jR1 = jpipe.predicted_rotations(jnp.asarray(wv), jnp.asarray(dtv), jp)
    jwarp = jcam.homography_warp_points(jnp.asarray(pts), jR0, jp.cam0_intrinsics)
    got, R = tcam.predict_warp_points(torch.as_tensor(pts), torch.as_tensor(wv),
                                      torch.as_tensor(dtv), tp.R_cam0_imu, tp.cam0_intrinsics)
    assert got.dtype == R.dtype == torch.float32
    np.testing.assert_allclose(R.numpy(), np.asarray(jR0), atol=4 * ONE_ULP, rtol=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(jwarp), atol=4 * PX_ULP, rtol=0)
    if not np.any(wv * dtv):
        np.testing.assert_array_equal(R.numpy(), np.eye(3, dtype=np.float32))
    tR0, tR1 = tpipe.predicted_rotations(torch.as_tensor(wv), torch.as_tensor(dtv), tp)
    assert torch.equal(tR0, R)
    np.testing.assert_allclose(tR1.numpy(), np.asarray(jR1), atol=4 * ONE_ULP, rtol=0)


def _jax_gate(cam0, p1, p0r, proj1, valid, st_fwd, jp, model, fe, h, w):
    """uav_airvision_tpu/models/frontend/stereo.py:97-125; returns the
    decisions and the epipolar residual."""
    err = jnp.linalg.norm(cam0 - p0r, axis=-1)
    disp = jnp.abs(proj1[:, 1] - p1[:, 1])
    inlier = (valid & st_fwd & (err < fe.fwd_bwd_error_px)
              & (disp < fe.max_vertical_disparity_px))
    inlier = inlier & (p1[:, 0] >= 0) & (p1[:, 0] < w) & (p1[:, 1] >= 0) & (p1[:, 1] < h)
    R0to1 = jp.R_cam1_imu.T @ jp.R_cam0_imu
    t01 = jp.R_cam1_imu.T @ (jp.t_cam0_imu - jp.t_cam1_imu)
    E = jquat.skew(t01) @ R0to1
    und_both = jcam.undistort_points(jnp.concatenate([cam0, p1]), jp.cam0_intrinsics, model,
                                     jp.cam0_coeffs)
    und0, und1 = und_both[: cam0.shape[0]], und_both[cam0.shape[0]:]
    fx, fy = jp.cam0_intrinsics[0], jp.cam0_intrinsics[1]
    norm_unit = 4.0 / (2.0 * fx + 2.0 * fy)
    ones = jnp.ones((und0.shape[0], 1), und0.dtype)
    line = jnp.concatenate([und0, ones], axis=-1) @ E.T
    err_epi = (jnp.abs(jnp.concatenate([und1, ones], axis=-1)[:, 0] * line[:, 0])
               / jnp.linalg.norm(line[:, :2], axis=-1))
    return inlier & (err_epi <= fe.stereo_threshold * norm_unit), err_epi


def stereo_gate_inputs(seed, B, H=480, W=752):
    """cam0 points, their cam1 match (disparity 0-40 px, vertical offset
    within +-3 px, some outside the image), the backward-tracked points (a
    2 px spread about the 3 px fwd/bwd bar), valid and forward status."""
    rng = np.random.default_rng(seed)
    cam0 = rng.uniform([5, 5], [W - 5, H - 5], (B, 2)).astype(np.float32)
    p1 = (cam0 - np.stack([rng.uniform(0, 40, B), rng.uniform(-3, 3, B)], 1)).astype(np.float32)
    p1[:8] = [[-0.5, 100], [0, 100], [W - 0.01, 50], [W, 50], [100, -0.25], [100, 0],
              [100, H - 0.5], [100, H]]
    p0r = (cam0 + rng.normal(0, 2, (B, 2))).astype(np.float32)
    return cam0, p1, p0r, rng.uniform(size=B) < 0.9, rng.uniform(size=B) < 0.9


@pytest.mark.parametrize("model", ["radtan", "equidistant"])
def test_stereo_gate_matches_jax(model):
    """The stereo gate's decisions equal the JAX expression's, its
    epipolar residual within 1e-6; both sides undistorted by the cam0
    model (the reference's quirk), on 204 points, with cam0's calibration
    (equidistant: cam0's intrinsics with equidistant coefficients)."""
    cfg, jcfg = euroc_config(), jax_euroc_config()
    fe = cfg.frontend
    tp = make_frontend_params(cfg, "cpu")
    jp = jax_params(jcfg)
    if model == "equidistant":
        co = np.array([-0.0113, 0.0052, -0.0021, 0.0005], np.float32)
        tp = tp._replace(cam0_coeffs=torch.as_tensor(co))
        jp = jp._replace(cam0_coeffs=jnp.asarray(co))
    cam0, p1, p0r, valid, st = stereo_gate_inputs(21, 204)
    _, proj1 = tcam.undistort_distort_points(torch.as_tensor(cam0), tp.cam0_intrinsics, model,
                                             tp.cam0_coeffs, tp.R0to1)
    proj1 = proj1.numpy()
    want, want_epi = _jax_gate(*map(jnp.asarray, (cam0, p1, p0r, proj1, valid, st)), jp, model,
                               fe, 480, 752)
    t = [torch.as_tensor(x) for x in (cam0, p1, p0r, proj1, valid, st)]
    got = tcam.stereo_gate(*t, tp.cam0_intrinsics, model, tp.cam0_coeffs, tp.E,
                           fe.fwd_bwd_error_px, fe.max_vertical_disparity_px,
                           fe.stereo_threshold, 480, 752)
    epi = tcam.epipolar_residual_plain(t[0], t[1], tp.cam0_intrinsics, model, tp.cam0_coeffs,
                                       tp.E)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(epi.numpy(), np.asarray(want_epi), atol=1e-6, rtol=0)
    assert 0 < int(got.sum()) < len(got)  # some points pass, some are cut


@pytest.mark.parametrize("kernel", ["K7 prediction", "K8 first frame"])
def test_fleet_frontend_plain_matches_jax(kernel):
    """The batched plain versions of K7's prediction and of K8's first-frame
    entries over four instances (inputs from a numpy seed) against
    ``jax.vmap`` of the JAX package's functions: K7 ``predicted_rotations``
    (cam0's) then ``homography_warp_points`` (the rotation within 4 float32
    ulps of 1.0, the points within 4 ulps at 752 px, as
    test_predict_warp_matches_jax), K8 ``rank_in_cell``, ``kept_order_stats``
    and ``compact_kept`` over 160 candidates each (exact)."""
    import jax

    rng = np.random.default_rng(41)
    B = 4
    if kernel.startswith("K7"):
        pts = rng.uniform([5, 5], [747, 475], (B, 104, 2)).astype(np.float32)
        wv = rng.normal(0, 1.0, (B, 3)).astype(np.float32)
        wv[0] = 0.0
        dtv = rng.uniform(0.04, 0.06, B).astype(np.float32)
        jp = jax_params(jax_euroc_config())
        tp = make_frontend_params(euroc_config(), "cpu")

        def jfn(p, w, d):
            R0, _ = jpipe.predicted_rotations(w, d, jp)
            return jcam.homography_warp_points(p, R0, jp.cam0_intrinsics), R0

        jwarp, jR = jax.vmap(jfn)(jnp.asarray(pts), jnp.asarray(wv), jnp.asarray(dtv))
        got, R = tcam.predict_warp_points_plain(torch.as_tensor(pts), torch.as_tensor(wv),
                                                torch.as_tensor(dtv), tp.R_cam0_imu,
                                                tp.cam0_intrinsics)
        np.testing.assert_allclose(R.numpy(), np.asarray(jR), atol=4 * ONE_ULP, rtol=0)
        np.testing.assert_allclose(got.numpy(), np.asarray(jwarp), atol=4 * PX_ULP, rtol=0)
        return
    n, n_cells = 160, 20
    cell = rng.integers(0, n_cells, (B, n)).astype(np.int32)
    pri = rng.integers(0, 3, (B, n)).astype(np.float32)
    arr = rng.integers(0, 6, (B, n)).astype(np.int32)
    valid = rng.uniform(size=(B, n)) < 0.7

    def jfn(c, p, a, v):
        rank, perm = jgrid.rank_in_cell(c, p, a, v, n_cells)
        keep = v & (rank < 3)
        return (rank, perm, *jgrid.kept_order_stats(perm, keep, c, v, n_cells),
                *jgrid.compact_kept(perm, keep, 104))

    want = jax.vmap(jfn)(*map(jnp.asarray, (cell, pri, arr, valid)))
    t = tuple(map(torch.as_tensor, (cell, pri, arr, valid)))
    rank, perm = tgrid.rank_in_cell_plain(*t, n_cells)
    keep = t[3] & (rank < 3)
    got = (rank, perm, *tgrid.kept_order_stats_plain(perm, keep, t[0], t[3], n_cells),
           *tgrid.compact_kept_plain(perm, keep, 104))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
