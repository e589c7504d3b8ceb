"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: every test skips without a CUDA device.  On a machine with
one (no JAX needed):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

The front-end kernels run at small shapes (chip_smoke.py repeats those
checks at the main path's shapes), the camera models, the per-cell top-k
and the ranking kernels at the main path's sizes on random inputs; the
back-end kernels run at the main path's shapes, on a filter state that the
port's plain back-end builds on the host from the oracle scenario (41
frames: a 19-camera window).
"""

import numpy as np
import pytest
import torch

# tests/ is on sys.path (pytest puts a test file's directory there); the
# oracle is imported from it directly because, run with --noconftest,
# another installed package named "tests" can shadow this directory
from oracle.synthetic import make_scenario, window_imu
from uav_airvision_tpu_torch import convert
from uav_airvision_tpu_torch.config import euroc_config
from uav_airvision_tpu_torch.models.msckf import (
    propagation, step, triangulation, update)
from uav_airvision_tpu_torch.models.msckf.state import init_state, make_params
from uav_airvision_tpu_torch.ops import camera, fast, gridops, lk, pyramid

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _image(H, W, seed):
    rng = np.random.default_rng(seed)
    base = rng.uniform(0, 255, (H // 6 + 2, W // 6 + 2))
    img = np.kron(base, np.ones((6, 6)))[:H, :W] + rng.normal(0, 2, (H, W))
    return np.clip(img, 0, 255).astype(np.uint8)


@pytest.mark.parametrize("H,W", [(96, 128), (121, 163)])
def test_pyramid_kernel_exact(dev, H, W):
    img = torch.as_tensor(_image(H, W, 1), device=dev)
    got = pyramid.build_pyramid_padded(img, 3)
    want = pyramid.build_pyramid_padded_plain(img, 3)
    for g, w in zip(got.levels, want.levels):
        assert torch.equal(g, w)


def test_fast_kernel_exact(dev):
    img = torch.as_tensor(_image(120, 160, 2), device=dev)
    rng = np.random.default_rng(3)
    pts = torch.as_tensor(rng.uniform([0, 0], [159, 119], (30, 2)), dtype=torch.float32,
                          device=dev)
    pts[:2] = torch.tensor([[1.0, 50.0], [40.0, 2.0]], device=dev)
    valid = torch.as_tensor(rng.uniform(size=30) < 0.8, device=dev)
    for args in ((), (pts, valid)):
        k, s = fast.detect_fast(img, 15, *args)
        pk, ps = fast.detect_fast_plain(img, 15, *args)
        assert torch.equal(k, pk) and torch.equal(s, ps)


@pytest.mark.parametrize("n_levels,upper", [(2, 5), (4, 5), (1, None)])
def test_lk_kernel_matches_plain(dev, n_levels, upper):
    """Status agrees on >= 99% of points, positions within 1e-3 px (the
    kernel's block reductions sum in another order)."""
    img0 = _image(120, 160, 4)
    img1 = np.roll(img0, (2, -3), axis=(0, 1))
    p0 = pyramid.build_pyramid_padded(torch.as_tensor(img0, device=dev), 3)
    p1 = pyramid.build_pyramid_padded(torch.as_tensor(img1, device=dev), 3)
    rng = np.random.default_rng(5)
    pts = torch.as_tensor(rng.uniform([1, 1], [158, 118], (40, 2)), dtype=torch.float32,
                          device=dev)
    valid = torch.ones(40, dtype=torch.bool, device=dev)
    args = dict(max_iter=10, n_levels=n_levels, max_iter_upper=upper)
    kn, ks = lk.pyramidal_lk(p0, p1, pts, pts, valid, **args)
    pn, ps = lk.pyramidal_lk_plain(p0, p1, pts, pts, valid, **args)
    assert (ks == ps).float().mean() >= 0.99
    both = ks & ps
    assert int(both.sum()) >= 20
    assert float((kn[both] - pn[both]).abs().max()) <= 1e-3


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_propagate_kernel_matches_plain(dev, dtype):
    cfg = euroc_config(dtype=dtype)
    params = make_params(cfg, dev)
    state = init_state(cfg, params, np.array([2e-3, -1e-3, 5e-4]), np.array([0.3, -0.2, 9.79]))
    rng = np.random.default_rng(6)
    D = cfg.capacity.state_dim
    A = torch.as_tensor(rng.normal(0, 0.05, (D, D)), device=dev)
    state = state._replace(cov=(A @ A.T + 0.01 * torch.eye(D, device=dev, dtype=A.dtype))
                           .to(state.cov.dtype))
    I, n = cfg.capacity.max_imu_per_frame, 11
    t = torch.zeros(I, dtype=state.cov.dtype, device=dev)
    t[:n] = 0.005 * torch.arange(1, n + 1, device=dev)
    w = torch.zeros((I, 3), dtype=state.cov.dtype, device=dev)
    w[:n] = torch.as_tensor(rng.normal(0, 0.3, (n, 3)), device=dev)
    a = torch.zeros((I, 3), dtype=state.cov.dtype, device=dev)
    a[:n] = torch.as_tensor(rng.normal([0, 0, 9.81], 0.5, (n, 3)), device=dev)
    mask = torch.arange(I, device=dev) < n
    got = propagation.propagate(state, params, t, w, a, mask)
    want = propagation.propagate_plain(state, params, t, w, a, mask)
    tol = 1e-5 if dtype == "float32" else 1e-12
    for g, ref in ((got.cov, want.cov), (got.imu.q, want.imu.q), (got.imu.p, want.imu.p),
                   (got.imu.v, want.imu.v)):
        assert float((g - ref).abs().max() / ref.abs().max()) <= tol


def _host_state(dtype, n_frames=41):
    """The port's plain back-end over the oracle scenario on the host, the
    frames windowed as tests/test_torch_backend.py windows them."""
    cfg = euroc_config(dtype=dtype)
    sc = make_scenario(cfg, duration=4.0, seed=3)
    cap = cfg.capacity
    cpu = torch.device("cpu")
    params = make_params(cfg, cpu)
    state = init_state(cfg, params, sc.gyro_bias, sc.acc_mean)
    tdt = state.cov.dtype
    active = [t >= sc.imu[cap.imu_init_msgs - 1][0] for t, _ in sc.frames]
    windows = window_imu(sc, active)
    I, K = cap.max_imu_per_frame, cap.max_features
    for k, (t, meas) in enumerate(sc.frames[:n_frames]):
        window = windows[k][1][:I]
        f = dict(imu_t=torch.zeros(I, dtype=tdt), imu_w=torch.zeros((I, 3), dtype=tdt),
                 imu_a=torch.zeros((I, 3), dtype=tdt), imu_mask=torch.zeros(I, dtype=torch.bool),
                 feat_ids=torch.full((K,), -1, dtype=torch.int32),
                 feat_uv=torch.zeros((K, 4), dtype=tdt),
                 feat_mask=torch.zeros(K, dtype=torch.bool))
        for j, (mt, w, a) in enumerate(window):
            f["imu_t"][j], f["imu_mask"][j] = mt, True
            f["imu_w"][j], f["imu_a"][j] = torch.as_tensor(w), torch.as_tensor(a)
        for j, (fid, u0, v0, u1, v1) in enumerate(meas[:K]):
            f["feat_ids"][j], f["feat_mask"][j] = fid, True
            f["feat_uv"][j] = torch.tensor([u0, v0, u1, v1])
        state, _ = step.backend_step(state, step.FrameInput(
            timestamp=torch.tensor(t, dtype=tdt), active=bool(active[k]), **f), params, cfg)
    return cfg, state, params


@pytest.fixture(scope="module")
def host_states():
    return {}


def _card_state(dev, host_states, dtype):
    """(config, state, params, sel) on the card: ``sel`` indexes the
    features with >= 3 observations."""
    if dtype not in host_states:
        host_states[dtype] = _host_state(dtype)
    cfg, state, params = host_states[dtype]
    state = convert.to_torch(convert.to_numpy(state), dev)
    params = convert.to_torch(convert.to_numpy(params), dev)
    t = state.features
    sel = torch.nonzero(t.valid & (t.obs_mask.sum(1) >= 3))[:, 0]
    assert len(sel) >= 8
    return cfg, state, params, sel


def _rel_err(got, want):
    return float((got - want).abs().max() / want.abs().max().clamp(min=1e-30))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("B", [16, 128])
def test_triangulate_kernel_matches_plain(dev, host_states, dtype, B):
    """K13: validity identical; in float32 positions within 1e-4 of
    max(|p|, 1) for 95% of the features and within 1e-3 for every one, in
    float64 within 1e-7 for every one.  The window is a real one and the
    features are its observed features, repeated to B, with ~1 px of noise
    on the repeats' observations so that each solve differs.  Five LM steps
    from such a start do not converge, and an unconverged iterate carries
    the rounding of the normal equations' sums; where two costs tie within
    rounding, the step is accepted on one side and refused on the other, so
    a few features end a step apart."""
    cfg, state, params, sel = _card_state(dev, host_states, dtype)
    c, t = state.cams, state.features
    idx = sel[torch.arange(B, device=dev) % len(sel)]
    rng = np.random.default_rng(B)
    obs = t.obs[idx] + torch.as_tensor(rng.normal(0, 2e-3, (B,) + t.obs.shape[1:]),
                                       device=dev).to(t.obs.dtype)
    obs[: len(sel)] = t.obs[idx[: len(sel)]]
    active = torch.as_tensor(rng.uniform(size=B) < 0.85, device=dev)
    args = (c.q, c.p, obs, t.obs_mask[idx], params.R_cam0_cam1, params.t_cam0_cam1,
            cfg.triangulation, active)
    n0 = triangulation.triangulate.launches
    pos, ok = triangulation.triangulate(*args)
    assert triangulation.triangulate.launches == n0 + 1
    ppos, pok = triangulation.triangulate_plain(*args)
    assert torch.equal(ok, pok)
    err = (pos - ppos).abs().max(1).values / ppos.abs().max(1).values.clamp(min=1.0)
    if dtype == "float32":
        assert float(err.max()) <= 1e-3 and float((err <= 1e-4).float().mean()) >= 0.95
    else:
        assert float(err.max()) <= 1e-7


def _blocks(dev, host_states, dtype, N, B):
    """feature_block arguments at N = 20 (lost features) or N = 2 (the
    prune's two cameras), B features."""
    cfg, state, params, sel = _card_state(dev, host_states, dtype)
    c, t = state.cams, state.features
    idx = sel[torch.arange(B, device=dev) % len(sel)]
    rm = torch.arange(N, device=dev) if N == 20 else torch.tensor([3, 7], device=dev)
    return state, params, (c.q[rm], c.p[rm], c.q_null[rm], c.p_null[rm], t.obs[idx][:, rm],
                           t.obs_mask[idx][:, rm], t.position[idx], state.gravity,
                           params.R_cam0_cam1, params.t_cam0_cam1, cfg.capacity.state_dim)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("N,B", [(20, 16), (20, 64), (2, 64)])
def test_feature_block_kernel_matches_plain(dev, host_states, dtype, N, B):
    """K9: H_proj and r_proj within 1e-5 (float32; 1e-4 for the prune's
    N = 2 blocks, whose reflections of two close views cancel) / 1e-10
    (float64) of each block's largest entry of [H_proj | r_proj] (the
    reflections sum in another order); rows_true exact; rows past
    4 n_obs - 3 exactly zero."""
    _, _, args = _blocks(dev, host_states, dtype, N, B)
    H, r, rows = update.feature_block(*args)
    pH, pr, prows = update.feature_block_plain(*args)
    assert torch.equal(rows, prows)
    tol = (1e-5 if N > 2 else 1e-4) if dtype == "float32" else 1e-10
    scale = torch.maximum(pH.abs().amax((1, 2)), pr.abs().amax(1)).clamp(min=1e-30)
    for got, want in ((H, pH), (r, pr)):
        err = (got - want).abs().flatten(1).amax(1)
        assert float((err / scale).max()) <= tol
    below = torch.arange(H.shape[1], device=dev)[None, :] >= rows[:, None]
    assert not bool(H.abs().amax(2)[below].any())


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_gate_kernels_match_plain(dev, host_states, dtype):
    """K10: gamma within 1e-4 (float32) / 1e-9 (float64) relative, and the
    gate's decisions identical except where gamma lies within 1e-4 of the
    threshold, at residual scales on the pass side, in the undecided band
    and on the fail side; the 77-row and the 32-row tier and the 5-row
    prune blocks."""
    state, params, args = _blocks(dev, host_states, dtype, 20, 16)
    H, r, rows = update.feature_block_plain(*args)
    H, r = H.contiguous(), r.contiguous()
    dof = args[5].sum(1).to(torch.int32) - 1
    _, _, args2 = _blocks(dev, host_states, dtype, 2, 64)
    H2, r2, rows2 = update.feature_block_plain(*args2)
    cols = torch.cat([21 + 6 * 3 + torch.arange(6, device=dev),
                      21 + 6 * 7 + torch.arange(6, device=dev)])
    H5 = torch.zeros((64, 5, H.shape[2]), dtype=H.dtype, device=dev).index_copy(
        2, cols, H2[:, :, 21:33])
    dof5 = torch.full((64,), 2, dtype=torch.int32, device=dev)
    rtol = 1e-4 if dtype == "float32" else 1e-9
    cases = [(H, r * s, rt, dof) for s in (1e-3, 1.0, 10.0, 30.0, 1e3)
             for rt in (rows, torch.full_like(rows, 77))]
    cases += [(H5, r2 * s, rows2, dof5) for s in (1e-3, 1.0, 30.0, 1e3)]
    n_b, n_g = update.gate_bounds.launches, update.gate_gamma.launches
    for Hc, rc, rt, d in cases:
        thresh = params.chi2_table[d.long()]
        got = update.gating_test_batch(Hc, rc, rt, state.cov, params.obs_noise,
                                       params.chi2_table, d)
        want = update.gating_test_batch_plain(Hc, rc, rt, state.cov, params.obs_noise,
                                              params.chi2_table, d)
        gamma = update.gate_gamma_plain(Hc, rc, state.cov, params.obs_noise)
        near = (gamma - thresh).abs() <= 1e-4 * thresh
        assert bool(((got == want) | near).all())
        for m in {min(Hc.shape[1], 32), Hc.shape[1]}:
            g = update.gate_gamma(Hc[:, :m], rc[:, :m], state.cov, params.obs_noise)
            w = update.gate_gamma_plain(Hc[:, :m], rc[:, :m], state.cov, params.obs_noise)
            assert _rel_err(g, w) <= rtol
        if Hc.shape[1] > 32:
            ps, fs = update.gate_bounds(Hc, rc, state.cov, params.obs_noise, thresh)
            pps, pfs = update.gate_bounds_plain(Hc, rc, state.cov, params.obs_noise, thresh)
            assert torch.equal(ps, pps) and torch.equal(fs, pfs)
    assert update.gate_bounds.launches > n_b and update.gate_gamma.launches > n_g
    # a factorisation that fails gives NaN, as the plain version's
    bad = -1e6 * torch.eye(H.shape[2], dtype=H.dtype, device=dev)
    assert bool(update.gate_gamma(H[:2], r[:2], bad, params.obs_noise).isnan().all())


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("singular", [False, True])
def test_rank12_kernel_matches_plain(dev, host_states, dtype, singular):
    """K12: the covariance and the state after the update within 1e-4
    (float32) / 1e-10 (float64) of the largest covariance entry.  The two
    12x12 solves of W = s2 I + B'B P12 round differently (LU in the kernel,
    the library's solver in the plain version), and W's conditioning
    carries that into the update.  ``singular``: the second camera is past
    the window's count, so its covariance block and P12 are exactly
    singular; W stays invertible."""
    cfg, state, params, _ = _card_state(dev, host_states, dtype)
    count = int(state.cams.count)
    r0, r1 = (count - 1, count) if singular else (4, 9)
    cols = torch.cat([21 + 6 * r0 + torch.arange(6, device=dev),
                      21 + 6 * r1 + torch.arange(6, device=dev)])
    P12 = state.cov[cols][:, cols]
    assert (int(torch.linalg.matrix_rank(P12.double())) < 12) == singular
    rng = np.random.default_rng(12)
    Bm = torch.as_tensor(rng.normal(0, 0.8, (320, 12)), device=dev).to(state.cov.dtype)
    Bm[25:35] = 0.0
    rr = torch.as_tensor(rng.normal(0, 0.02, 320), device=dev).to(state.cov.dtype)
    n0 = update.rank12_update.launches
    got, _ = update.apply_update_rank12(state, params, Bm, rr, cols)
    assert update.rank12_update.launches == n0 + 1
    want, _ = update.apply_update_rank12_plain(state, params, Bm, rr, cols)
    tol = 1e-4 if dtype == "float32" else 1e-10
    scale = float(want.cov.abs().max())
    assert torch.equal(got.cov, got.cov.T)
    for a, b in ((got.cov, want.cov), (got.imu.p, want.imu.p), (got.cams.p, want.cams.p)):
        assert float((a - b).abs().max()) <= tol * max(scale, 1.0)


@pytest.mark.parametrize("model,coeffs", [
    ("radtan", (-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05)),
    ("equidistant", (-0.0113, 0.0052, -0.0021, 0.0005))])
def test_camera_kernel_matches_plain(dev, model, coeffs):
    """K7: normalized outputs within 1e-6, pixel outputs within one float32
    ulp at 752 px (two for the fused prologue's re-distorted points, whose
    undistorted input already differs by an ulp of the normalized
    coordinate times fx, and for the warp); the fused prologue equals the
    kernel's two calls bit for bit; one camera's values and one set per
    point."""
    ulp = 2.0 ** -14
    rng = np.random.default_rng(7)
    pts = torch.as_tensor(rng.uniform([5, 5], [747, 475], (408, 2)), dtype=torch.float32,
                          device=dev)
    intr = torch.tensor([458.654, 457.296, 367.215, 248.375], device=dev)
    co = torch.tensor(coeffs, device=dev)
    R = torch.as_tensor(np.linalg.qr(np.eye(3) + 0.01 * rng.normal(size=(3, 3)))[0],
                        dtype=torch.float32, device=dev)
    R = R * torch.sign(torch.diagonal(R))[None, :]
    n0 = [fn.launches for fn in camera.WRAPPERS]
    for rect in (None, R):
        got = camera.undistort_points(pts, intr, model, co, rect)
        want = camera.undistort_points_plain(pts, intr, model, co, rect)
        assert float((got - want).abs().max()) <= 1e-6
    got = camera.undistort_points(pts, intr, model, co, None, (460.0, 459.0, 370.0, 240.0))
    want = camera.undistort_points_plain(pts, intr, model, co, None, (460.0, 459.0, 370.0, 240.0))
    assert float((got - want).abs().max()) <= ulp
    per_intr = torch.cat([intr[:, None].expand(4, 204), (intr * 1.01)[:, None].expand(4, 204)], 1)
    per_co = torch.cat([co[:, None].expand(4, 204), (co * 0.9)[:, None].expand(4, 204)], 1)
    got = camera.undistort_points(pts, per_intr, model, per_co)
    want = camera.undistort_points_plain(pts, per_intr, model, per_co)
    assert float((got - want).abs().max()) <= 1e-6
    und, dis = camera.undistort_distort_points(pts, intr, model, co, R)
    pund, pdis = camera.undistort_distort_points_plain(pts, intr, model, co, R)
    assert float((und - pund).abs().max()) <= 1e-6 and float((dis - pdis).abs().max()) <= 2 * ulp
    two = camera.undistort_points(pts, intr, model, co, R)
    assert torch.equal(und, two) and torch.equal(dis, camera.distort_points(two, intr, model, co))
    assert float((camera.distort_points(pund, intr, model, co)
                  - camera.distort_points_plain(pund, intr, model, co)).abs().max()) <= ulp
    # the plain version forms K R K^-1 by two library products (another
    # order, fused multiply-adds): two ulp at this test's ~1 degree rotation
    got = camera.homography_warp_points(pts, R, intr)
    assert float((got - camera.homography_warp_points_plain(pts, R, intr)).abs().max()) <= 2 * ulp
    assert all(fn.launches > n for fn, n in zip(camera.WRAPPERS, n0))


@pytest.mark.parametrize("H,W", [(480, 752), (97, 131)])
@pytest.mark.parametrize("k", [5, 8])
def test_grid_topk_kernel_exact(dev, H, W, k):
    """K5: exact, with heavy ties, an empty cell and cells padded with -1."""
    rng = np.random.default_rng(H + k)
    score = rng.integers(-1, 4, (H, W)).astype(np.int32)
    score[: H // 4, : W // 5] = 0
    score[H // 2, W // 2] = 2 ** 31 - 1
    score = torch.as_tensor(score, device=dev)
    n0 = gridops.dense_grid_topk.launches
    got = gridops.dense_grid_topk(score, 4, 5, k)
    assert gridops.dense_grid_topk.launches == n0 + 1
    for g, w in zip(got, gridops.dense_grid_topk_plain(score, 4, 5, k)):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.parametrize("n", [20, 100, 160, 204, 256, 1024])
def test_grid_ranking_kernels_exact(dev, n):
    """K8: every entry point exact, with heavy ties and invalid entries."""
    rng = np.random.default_rng(n)
    cell = torch.as_tensor(rng.integers(0, 20, n), dtype=torch.int32, device=dev)
    pri = torch.as_tensor(rng.integers(0, 3, n), dtype=torch.float32, device=dev)
    arr = torch.as_tensor(rng.integers(0, 6, n), dtype=torch.int32, device=dev)
    valid = torch.as_tensor(rng.uniform(size=n) < 0.7, device=dev)

    def same(got, want):
        return all(g.dtype == w.dtype and torch.equal(g, w) for g, w in zip(got, want))

    rank, perm = gridops.rank_in_cell(cell, pri, arr, valid, 20)
    assert same((rank, perm), gridops.rank_in_cell_plain(cell, pri, arr, valid, 20))
    keep = valid & (rank < 2)
    assert same(gridops.kept_order_stats(perm, keep, cell, valid, 20),
                gridops.kept_order_stats_plain(perm, keep, cell, valid, 20))
    for slots in (104, max(int(keep.sum()), 1)):
        assert same(gridops.compact_kept(perm, keep, slots),
                    gridops.compact_kept_plain(perm, keep, slots))
    key = arr.clone()
    key[::5] = 2 ** 31 - 1
    for k in (16, 128, n + 7):
        assert torch.equal(gridops.smallest_k_indices(key, k),
                           gridops.smallest_k_indices_plain(key, k))
    for mask in (valid, torch.zeros_like(valid), torch.ones_like(valid)):
        assert torch.equal(gridops.stable_compact_indices(mask, n),
                           gridops.stable_compact_indices_plain(mask, n))
    assert all(fn.launches > 0 for fn in gridops.K8_WRAPPERS)
    with pytest.raises(ValueError, match="float32"):
        gridops.rank_in_cell(cell, pri.double(), arr, valid, 20)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("n_rows", [60, 144, 250, 700], ids=["T1", "T1_full", "T2", "QR"])
def test_ekf_update_kernel_matches_plain(dev, host_states, dtype, n_rows):
    """K11 on a real covariance: float64 within 1e-10 of max(|P|, 1) and of
    max|delta|; float32 P within 1e-5 of max(|P|, 1) and delta within 1e-4 of
    max|delta| of the float64 plain version, or within 4 x the float32 plain
    version's own distance from it where that is larger (both feel S's
    condition number).  Zero rows inside the stack stay exact; P_new is
    exactly symmetric; a failed factorisation is NaN."""
    cfg, state, params, _ = _card_state(dev, host_states, dtype)
    D = state.cov.shape[0]
    rng = np.random.default_rng(n_rows)
    H = torch.zeros((1680, D), dtype=torch.float64, device=dev)
    H[:n_rows, 21:] = torch.as_tensor(rng.normal(0, 0.05, (n_rows, D - 21)), device=dev)
    r = torch.zeros(1680, dtype=torch.float64, device=dev)
    r[:n_rows] = torch.as_tensor(rng.normal(0, 0.01, n_rows), device=dev)
    H[7], r[7] = 0.0, 0.0
    want_d, want_P = update.ekf_update_plain(state.cov.double(), H, r, params.obs_noise.double(),
                                             n_rows)
    tdt = state.cov.dtype
    args = (state.cov, H.to(tdt), r.to(tdt), params.obs_noise, n_rows)
    n0 = update.ekf_update.launches
    d, Pn = update.ekf_update(*args)
    assert update.ekf_update.launches == n0 + 1
    pd, pPn = update.ekf_update_plain(*args)
    sc_d, sc_P = float(want_d.abs().max()), max(float(want_P.abs().max()), 1.0)
    e_d, e_P = float((d - want_d).abs().max()), float((Pn - want_P).abs().max())
    if dtype == "float64":
        assert e_d <= 1e-10 * sc_d and e_P <= 1e-10 * sc_P
    else:
        assert e_d <= max(1e-4 * sc_d, 4 * float((pd - want_d).abs().max()))
        assert e_P <= max(1e-5 * sc_P, 4 * float((pPn - want_P).abs().max()))
    assert torch.equal(Pn, Pn.T)
    got, _ = update.apply_update(state, params, *args[1:3], n_rows)
    assert torch.equal(got.cov, Pn)
    bad = -1e6 * torch.eye(D, dtype=tdt, device=dev)
    d, Pn = update.ekf_update(bad, *args[1:])
    assert bool(d.isnan().all()) and bool(Pn.isnan().all())
