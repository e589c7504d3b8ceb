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

import dataclasses

import numpy as np
import pytest
import torch

# tests/ is on sys.path (pytest puts a test file's directory there); the
# oracle is imported from it directly because, run with --noconftest,
# another installed package named "tests" can shadow this directory
from oracle.synthetic import make_scenario, window_imu
from torch_select_inputs import CASES, select_inputs
from uav_airvision_tpu_torch import convert, kernels
from uav_airvision_tpu_torch.config import euroc_config
from uav_airvision_tpu_torch.models.msckf import (
    propagation, step, triangulation, update)
from uav_airvision_tpu_torch.models.msckf.state import init_state, make_params
from uav_airvision_tpu_torch.ops import camera, extract, fast, gridops, lk, pyramid

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


@pytest.mark.parametrize("H,W", [(96, 128), (121, 163), (480, 752), (95, 131), (1024, 1280),
                                 (1080, 1440), (1536, 2048)])
def test_pyramid_kernel_exact(dev, H, W):
    """K2, one camera and the pair: every level equal to the plain version,
    one launch per call.  752 px rows are staged by the bulk copy, odd
    widths and an image at an odd address by byte loads.  1024x1280 is the
    largest of these whose band plan fits a block's shared memory at four
    levels; 1080x1440 (268,208 B) and 1536x2048 take the level passes."""
    img0 = torch.as_tensor(_image(H, W, 1), device=dev)
    img1 = torch.as_tensor(_image(H, W, 2), device=dev)
    n1, n2 = pyramid.build_pyramid_padded.launches, pyramid.build_pyramid_pair.launches
    got = pyramid.build_pyramid_padded(img0, 3)
    pair = pyramid.build_pyramid_pair(img0, img1, 3)
    assert pyramid.build_pyramid_padded.launches == n1 + 1
    assert pyramid.build_pyramid_pair.launches == n2 + 1
    want = pyramid.build_pyramid_pair_plain(img0, img1, 3)
    for g, w in zip(got.levels, want[0].levels):
        assert torch.equal(g, w)
    for g, w in zip(pair, want):
        assert all(torch.equal(a, b) for a, b in zip(g.levels, w.levels))
    odd = torch.empty(H * W + 1, dtype=torch.uint8, device=dev)[1:].view(H, W)
    odd.copy_(img1)
    got = pyramid.build_pyramid_pair(img0, odd, 3)[1]
    assert all(torch.equal(a, b) for a, b in zip(got.levels, want[1].levels))


@pytest.mark.parametrize("levels", [0, 1, 2, 5])
def test_pyramid_kernel_levels(dev, levels):
    """K2 at other level counts (the coarsest level's bands set every
    level's): equal to the plain version."""
    img0, img1 = (torch.as_tensor(_image(480, 752, s), device=dev) for s in (3, 4))
    pair = pyramid.build_pyramid_pair(img0, img1, levels)
    for g, w in zip(pair, pyramid.build_pyramid_pair_plain(img0, img1, levels)):
        assert g.n_levels == levels + 1
        assert all(torch.equal(a, b) for a, b in zip(g.levels, w.levels))


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


@pytest.mark.parametrize("n_levels,upper", [(2, 5), (4, 5), (1, None), (3, 5)])
def test_lk_kernel_matches_plain(dev, n_levels, upper):
    """Status agrees on >= 99% of points, positions within 1e-3 px (the
    kernel's block reductions sum in another order); 1 to 4 levels, every
    level's template built at the block's start."""
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


@pytest.mark.parametrize("F,n", [(104, 32), (208, 32), (128, 36)])
def test_extract_kernel_exact(dev, F, n):
    """P1 equals its plain version bit for bit, on a pyramid level view, with
    origins given as the strided columns of one (F, 2) tensor, some of them
    out of range (clamped by both)."""
    pyr = pyramid.build_pyramid_padded(torch.as_tensor(_image(480, 752, 9), device=dev), 3)
    rng = np.random.default_rng(F)
    for level in pyr.levels[:3]:
        HP, WP = level.shape
        des = torch.as_tensor(np.stack([rng.integers(-3, HP - n + 4, F),
                                        rng.integers(-3, WP - n + 4, F)], 1),
                              dtype=torch.int32, device=dev)
        got = extract.extract_windows(level, des[:, 0], des[:, 1], n)
        assert torch.equal(got, extract.extract_windows_plain(level, des[:, 0], des[:, 1], n))


def _compact_inputs(dev):
    img0 = _image(120, 160, 4)
    img1 = np.roll(img0, (2, -3), axis=(0, 1))
    p0 = pyramid.build_pyramid_padded(torch.as_tensor(img0, device=dev), 3)
    p1 = pyramid.build_pyramid_padded(torch.as_tensor(img1, device=dev), 3)
    rng = np.random.default_rng(5)
    pts = torch.as_tensor(rng.uniform([1, 1], [158, 118], (40, 2)), dtype=torch.float32,
                          device=dev)
    return p0, p1, pts, torch.ones(40, dtype=torch.bool, device=dev)


@pytest.mark.parametrize("L", [3, 1, 0])
def test_lk_level_kernel_matches_plain(dev, L):
    """K1's level entry against its plain version on the same windows: at
    level 0 status on >= 99% of points and positions within 1e-3 px; above
    it positions within 1e-3 px and the next level's origins on >= 99%."""
    p0, p1, pts, valid = _compact_inputs(dev)
    des = lk.compact_origin(pts, p1.levels[L], L)
    win = extract.extract_windows(p1.levels[L], des[:, 0], des[:, 1], 32)
    args = (p0, pts, pts, valid, win, des, L, 15, 10 if L == 0 else 5, 0.01, 1e-4)
    kp, kd, ks = lk.pyramidal_lk_level(*args)
    pp, pd, ps = lk.pyramidal_lk_level_plain(*args)
    if L == 0:
        assert kd is None and pd is None
        assert (ks == ps).float().mean() >= 0.99
        both = ks & ps
        assert int(both.sum()) >= 20
        assert float((kp[both] - pp[both]).abs().max()) <= 1e-3
    else:
        assert ks is None and ps is None
        assert ((kp - pp).abs().amax(1) <= 1e-3).float().mean() >= 0.99
        assert (kd == pd).all(1).float().mean() >= 0.99


def _compact_counts():
    return (extract.extract_windows.launches, lk.pyramidal_lk_level.launches,
            lk.pyramidal_lk.launches, lk.pyramidal_lk_compact.launches)


@pytest.mark.parametrize("n_levels,upper", [(2, 5), (4, 5), (1, None)])
def test_lk_compact_kernel_matches_plain(dev, n_levels, upper):
    """The compact-window tracker (one launch of K1's compact entry, which
    stages each level's window itself) against its plain version: K1's
    bars."""
    p0, p1, pts, valid = _compact_inputs(dev)
    args = dict(max_iter=10, n_levels=n_levels, max_iter_upper=upper, compact_windows=True)
    n0 = _compact_counts()
    kn, ks = lk.pyramidal_lk(p0, p1, pts, pts, valid, **args)
    assert tuple(b - a for a, b in zip(n0, _compact_counts())) == (0, 0, 0, 1)
    pn, ps = lk.pyramidal_lk_plain(p0, p1, pts, pts, valid, **args)
    assert (ks == ps).float().mean() >= 0.99
    both = ks & ps
    assert int(both.sum()) >= 20
    assert float((kn[both] - pn[both]).abs().max()) <= 1e-3


@pytest.mark.parametrize("n_levels", [1, 2, 4])
@pytest.mark.parametrize("win", [3, 15, 33])
def test_lk_compact_entry_bit_identical(dev, n_levels, win):
    """K1's compact entry (ONE launch: each level's des, its window staged
    in shared memory, the template and the steps) equals the route it
    replaced, P1's window extract and K1's level entry level by level, bit
    for bit: points, status and each level's window origin; side 33 takes
    the looped instantiation."""
    img0 = _image(240, 320, 4)
    img1 = np.roll(img0, (2, -3), axis=(0, 1))
    p0 = pyramid.build_pyramid_padded(torch.as_tensor(img0, device=dev), 3)
    p1 = pyramid.build_pyramid_padded(torch.as_tensor(img1, device=dev), 3)
    rng = np.random.default_rng(win + n_levels)
    pts = torch.as_tensor(rng.uniform([1, 1], [318, 238], (60, 2)), dtype=torch.float32,
                          device=dev)
    valid = torch.as_tensor(rng.uniform(size=60) < 0.9, device=dev)
    kw = dict(win=win, max_iter=10, n_levels=n_levels, max_iter_upper=5)
    des = torch.full((60, n_levels, 2), -1, dtype=torch.int32, device=dev)
    n0 = _compact_counts()
    (kn, ks), n_launch = _launches(lambda: lk.pyramidal_lk_compact(p0, p1, pts, pts, valid,
                                                                   des=des, **kw))
    assert n_launch == 1
    assert tuple(b - a for a, b in zip(n0, _compact_counts())) == (0, 0, 0, 1)
    wn, ws, wdes = lk.pyramidal_lk_compact_levels(p0, p1, pts, pts, valid, **kw)
    assert torch.equal(kn, wn) and torch.equal(ks, ws) and torch.equal(des, wdes)
    pn, ps = lk.pyramidal_lk_plain(p0, p1, pts, pts, valid, compact_windows=True, **kw)
    assert (ks == ps).float().mean() >= 0.99


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


PROP_HOLES = [4, 5, 6, 13, 20]


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("n_valid", [0, 1, 11, 40, 64, "holes"])
@pytest.mark.parametrize("N", [20, 70])
def test_propagate_kernel_cases(dev, dtype, n_valid, N):
    """K14 against its plain version (relative error <= 1e-5 in float32,
    1e-12 in float64, on every field it writes) with no valid sample, one,
    the main path's 11, 40, a full 64-slot slice and a slice with holes, at
    D = 141 and at the [limits] window's D = 441; one launch a call (the
    holes check that folding only up to the next power of two above the
    last valid slot gives the plain version's 64-slot fold)."""
    _propagate_case(dev, dtype, n_valid, N, euroc_config(dtype=dtype))


@pytest.mark.parametrize("dtype,I", [("float64", 128), ("float32", 256)])
@pytest.mark.parametrize("n_valid", [11, 100, "full", "holes"])
@pytest.mark.parametrize("N", [20, 70])
def test_propagate_kernel_workspace(dev, dtype, I, n_valid, N):
    """K14 with an IMU slice too long for the block's shared memory (128
    slots in float64, 256 in float32): its slots and chunk roots live in
    the device workspace.  Held to the plain version with the bars of
    test_propagate_kernel_cases."""
    cfg = euroc_config(dtype=dtype)
    cfg = dataclasses.replace(cfg, capacity=dataclasses.replace(cfg.capacity,
                                                                max_imu_per_frame=I))
    itemsize = 8 if dtype == "float64" else 4
    assert propagation._workspace_values(I, itemsize) > 0
    assert propagation._workspace_values(64, itemsize) == 0
    _propagate_case(dev, dtype, I if n_valid == "full" else n_valid, N, cfg)


def _propagate_case(dev, dtype, n_valid, N, cfg):
    """One K14 call against its plain version at D = 21 + 6 N, the slice
    of ``cfg``'s length with its first ``n_valid`` slots valid (or 24 with
    holes at PROP_HOLES)."""
    params = make_params(cfg, dev)
    state = init_state(cfg, params, np.array([2e-3, -1e-3, 5e-4]), np.array([0.3, -0.2, 9.79]))
    rng = np.random.default_rng(N)
    D = 21 + 6 * N
    A = torch.as_tensor(rng.normal(0, 0.05, (D, D)), device=dev)
    tdt = state.cov.dtype
    q = rng.normal(0, 1, 4)
    imu = state.imu._replace(
        q=torch.as_tensor(q / np.linalg.norm(q), dtype=tdt, device=dev),
        v=torch.as_tensor(rng.normal(0, 0.5, 3), dtype=tdt, device=dev),
        v_null=torch.as_tensor(rng.normal(0, 0.5, 3), dtype=tdt, device=dev),
        p=torch.as_tensor(rng.normal(0, 1, 3), dtype=tdt, device=dev),
        timestamp=torch.tensor(3.0, dtype=tdt, device=dev))
    state = state._replace(imu=imu, cov=(A @ A.T + 0.01 * torch.eye(D, device=dev, dtype=A.dtype))
                           .to(tdt))
    I = cfg.capacity.max_imu_per_frame
    mask = np.arange(I) < (24 if n_valid == "holes" else n_valid)
    if n_valid == "holes":
        mask[PROP_HOLES] = False
    n = int(np.nonzero(mask)[0].max()) + 1 if mask.any() else 0
    t = torch.zeros(I, dtype=tdt, device=dev)
    t[:n] = 3.0 + 0.005 * torch.arange(1, n + 1, device=dev)
    w = torch.zeros((I, 3), dtype=tdt, device=dev)
    w[:n] = torch.as_tensor(rng.normal(0, 0.3, (n, 3)), device=dev)
    a = torch.zeros((I, 3), dtype=tdt, device=dev)
    a[:n] = torch.as_tensor(rng.normal([0, 0, 9.81], 0.5, (n, 3)), device=dev)
    m = torch.as_tensor(mask, device=dev)
    n0 = propagation.propagate.launches
    got = propagation.propagate(state, params, t, w, a, m)
    assert propagation.propagate.launches == n0 + 1
    want = propagation.propagate_plain(state, params, t, w, a, m)
    tol = 1e-5 if dtype == "float32" else 1e-12
    for f in ("q", "v", "p", "q_null", "v_null", "p_null", "timestamp"):
        g, ref = getattr(got.imu, f), getattr(want.imu, f)
        assert float((g - ref).abs().max() / ref.abs().max().clamp(min=1e-30)) <= tol, f
    assert float((got.cov - want.cov).abs().max() / want.cov.abs().max()) <= tol
    assert torch.equal(got.cov, got.cov.T) and int(got.imu.sid) == int(want.imu.sid)
    if dtype == "float32" and n_valid == 11 and N == 20:
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            propagation.propagate(state, params, t, w, a, m)
            torch.cuda.synchronize()
        launches = sum(e.count for e in prof.key_averages()
                       if e.key in ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC"))
        assert launches == 1


def _lk_points(F, W, H, win, seed):
    """F points: a quarter with the x search origin des on a 16-px band
    boundary, a quarter with y's, an eighth on the left or right image edge,
    an eighth on the top or bottom one, the rest anywhere."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform([1, 1], [W - 2, H - 2], (F, 2))
    half = (win - 1) / 2
    k = np.arange(F)
    q = F // 4
    pts[:q, 0] = np.clip(16 * rng.integers(1, W // 16, q) + 8 - 17 + half + 0.25, 0, W - 1)
    pts[q:2 * q, 1] = np.clip(16 * rng.integers(1, H // 16, q) + 8 - 17 + half + 0.25, 0, H - 1)
    e = 2 * q + F // 8
    pts[2 * q:e, 0] = np.where(k[2 * q:e] % 2, 0.0, W - 1.0)
    pts[e:e + F // 8, 1] = np.where(k[e:e + F // 8] % 2, 0.0, H - 1.0)
    return pts


@pytest.mark.parametrize("F,win", [(1, 15), (104, 15), (204, 15), (1300, 15), (204, 3),
                                   (204, 21), (204, 31), (204, 33)])
def test_lk_kernel_points(dev, F, win):
    """K1 and its compact entry (the compact tracker in one launch) at the
    main path's point counts, the [limits] configuration's 1,300 and one
    point, with points on band boundaries and image edges, at sides 3 to
    33: one launch a call, status
    agreeing on >= 99% of points, and every point both track within 1e-3 px
    of the plain version (K1's bars).  At side 3 G (9 pixels) is often
    near-singular and most points oscillate without converging within
    max_iter, so where they end depends on the sum order: even the float32
    plain version often ends more than 1e-3 px from the float64 one.
    There the kernel must agree with the float64 plain version on at least
    as many points as the float32 plain version does, less 3% of the
    points.  Each at 1 to 4 pyramid levels.  At side 15 and one level a
    point (204 points) oscillates through its 10 steps and the float32
    plain version ends it 1.79e-3 px from the float64 one, the kernel
    2.4e-5 px: a point on which the two float32 versions differ by more
    than 1e-3 px is held to the float64 plain version, within 1e-3 px,
    where the float32 plain version is itself farther than that from it."""
    H, W = 480, 752
    img0 = _image(H, W, F)
    img1 = np.roll(img0, (2, -3), axis=(0, 1))
    p0 = pyramid.build_pyramid_padded(torch.as_tensor(img0, device=dev), 3)
    p1 = pyramid.build_pyramid_padded(torch.as_tensor(img1, device=dev), 3)
    pts = torch.as_tensor(_lk_points(F, W, H, win, F + win), dtype=torch.float32, device=dev)
    valid = torch.as_tensor(np.random.default_rng(F).uniform(size=F) < 0.95, device=dev)
    for n_levels, compact in ((n, c) for n in (1, 2, 3, 4) for c in (False, True)):
        args = dict(win=win, max_iter=10, n_levels=n_levels, max_iter_upper=5,
                    compact_windows=compact)
        n0 = _compact_counts()[1:]
        kn, ks = lk.pyramidal_lk(p0, p1, pts, pts, valid, **args)
        assert tuple(b - a for a, b in zip(n0, _compact_counts()[1:])) == (
            (0, 0, 1) if compact else (0, 1, 0))
        pn, ps = lk.pyramidal_lk_plain(p0, p1, pts, pts, valid, **args)
        assert (ks == ps).float().mean() >= 0.99
        both = ks & ps
        assert int(both.sum()) >= (1 if F == 1 else F // 2)
        wide = [dataclasses.replace(p, flat=p.flat.double(), _levels=None) for p in (p0, p1)]
        if win > 3:
            far = both & ((kn - pn).abs().amax(1) > 1e-3)
            if bool(far.any()):
                dn, ds = lk.pyramidal_lk_plain(*wide, pts.double(), pts.double(), valid, **args)
                d32, dk = ((x.double() - dn).abs().amax(1)[far] for x in (pn, kn))
                assert bool(ds[far].all() and (d32 > 1e-3).all() and (dk <= 1e-3).all()), (
                    n_levels, compact, d32.tolist(), dk.tolist())
            continue
        dn, ds = lk.pyramidal_lk_plain(*wide, pts.double(), pts.double(), valid, **args)

        def near(x, st):
            return int((((x.double() - dn).abs().amax(1) <= 1e-3) & st & ds).sum())

        assert near(kn, ks) >= near(pn, ps) - 0.03 * F, (n_levels, compact, near(kn, ks),
                                                         near(pn, ps))


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


def _tri_rows_inputs(dev, host_states, dtype, N, motion):
    """triangulate_rows' arguments on the card state's feature table, its
    window widened to N slots (the real 20 poses repeated, nudged, and each
    feature's observations with them): every valid row with >= 3
    observations selected (noise on the rows' observations past the first
    20 slots) and 8 free rows, in a shuffled order; ~85% of the valid ones
    with sel_ok (the free rows never, as on the main path), a third
    already initialized; ``motion``: the motion check at 0.05 m."""
    cfg, state, params, sel = _card_state(dev, host_states, dtype)
    t = state.features
    slots = torch.arange(N, device=dev) % 20
    cams = _wide_state(state, N, N, N).cams if N != 20 else state.cams
    rng = np.random.default_rng(N + 2 * motion)
    obs = t.obs[:, slots].clone()
    if N > 20:
        obs[:, 20:] += torch.as_tensor(rng.normal(0, 2e-3, obs[:, 20:].shape),
                                       device=dev).to(obs.dtype)
    rows = torch.cat([sel, torch.nonzero(~t.valid)[:8, 0]])
    rows = rows[torch.as_tensor(rng.permutation(len(rows)), device=dev)]
    sel_ok = torch.as_tensor(rng.uniform(size=len(rows)) < 0.85, device=dev) & t.valid[rows]
    initialized = t.initialized.clone()
    initialized[rows] = torch.as_tensor(rng.uniform(size=len(rows)) < 0.33, device=dev)
    tri = cfg.triangulation
    if motion:
        tri = dataclasses.replace(tri, translation_threshold=0.05)
    return (cams.q, cams.p, obs, t.obs_mask[:, slots].contiguous(), t.position, initialized,
            rows, sel_ok, params.R_cam0_cam1, params.t_cam0_cam1, tri)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("N", [20, 65, 300])
@pytest.mark.parametrize("motion", [False, True], ids=["motion_off", "motion_on"])
def test_triangulate_rows_kernel_matches_plain(dev, host_states, dtype, N, motion):
    """K13's row entry (ONE launch: the rows' gathers, need_init, the motion
    check, the LM, the new position and initialized columns) against its
    plain version (the call site's glue around triangulate_plain):
    initialized and init_fail identical, the rows that got a position
    within K13's bars (float32: 1e-3 of max(|p|, 1) for each and 1e-4 for
    95%; float64: 1e-7), every other row unchanged; and equal, bit for bit,
    to the same glue around ``triangulate`` (the kernel's separate passes)
    on the card; the inputs unchanged.  N = 65 and 300 take 4 slots a lane
    and the rebuilt views."""
    args = _tri_rows_inputs(dev, host_states, dtype, N, motion)
    cam_q, cam_p, obs, mask, position, initialized, rows, sel_ok, R, t, tri = args
    before = (position.clone(), initialized.clone())
    n0 = triangulation.triangulate_rows.launches
    (pos, init, fail), n_launch = _launches(lambda: triangulation.triangulate_rows(*args))
    assert n_launch == 1 and triangulation.triangulate_rows.launches == n0 + 1
    assert torch.equal(position, before[0]) and torch.equal(initialized, before[1])
    ppos, pinit, pfail = triangulation.triangulate_rows_plain(*args)
    assert torch.equal(init, pinit) and torch.equal(fail, pfail)
    new = init & ~initialized
    assert torch.equal(pos[~new], position[~new])
    if bool(new.any()):
        err = ((pos - ppos).abs().max(1).values / ppos.abs().max(1).values.clamp(min=1.0))[new]
        if dtype == "float32":
            assert float(err.max()) <= 1e-3 and float((err <= 1e-4).float().mean()) >= 0.95
        else:
            assert float(err.max()) <= 1e-7
    # the witness: the call site's glue around the kernel's separate passes
    need = sel_ok & ~initialized[rows]
    wpos, wok = triangulation.triangulate(cam_q, cam_p, obs[rows], mask[rows], R, t, tri,
                                          active=need)
    if motion:
        wok = wok & triangulation.check_motion(cam_q, cam_p, obs[rows], mask[rows], tri)
    done = need & wok
    assert torch.equal(fail, need & ~wok)
    assert torch.equal(init, initialized.index_put((rows,), initialized[rows] | done))
    assert torch.equal(pos, position.index_put((rows,), torch.where(done[:, None], wpos,
                                                                    position[rows])))
    assert int(need.sum()) > 0 and (not motion or bool(fail.any()))


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


def _gate_scales(H, r, cov, s2, thresh):
    """Per-block residual scales that put r'r far under the pass bound, far
    over the fail bound, or at the geometric middle of the undecided band."""
    rtr = (r * r).sum(-1)
    tr = ((H @ cov) * H).sum((1, 2))
    targets = {"pass": 1e-3 * thresh * s2, "fail": 1e3 * thresh * (s2 + tr),
               "undecided": thresh * torch.sqrt(s2 * (s2 + tr))}
    return {k: torch.sqrt(v / rtr) for k, v in targets.items()}


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_gate_kernels_match_plain(dev, host_states, dtype):
    """K10: one launch per gate call and no host read; gamma, where the
    kernel computes it, within 1e-4 (float32) / 1e-9 (float64) relative of
    the plain version's, NaN where it is; the decisions equal the plain
    version's except where gamma (on either tier) lies within 1e-4 of the
    threshold or r'r within 1e-4 of a bound, at residual scales
    on the pass side, in the undecided band and on the fail side, forced
    per block (all pass, pass and fail, one undecided block on each tier),
    on the 77-row blocks (16 and, walked by the co-resident blocks, 300
    features), the 32- and 5-row prefixes and the 5-row prune blocks; the
    same decisions with P at an address that is not 16-byte aligned; a
    failed factorisation gives the plain version's decision."""
    from uav_airvision_tpu_torch import device

    state, params, args = _blocks(dev, host_states, dtype, 20, 16)
    H, r, rows = update.feature_block_plain(*args)
    H, r = H.contiguous(), r.contiguous()
    B, R = r.shape
    dof = args[5].sum(1) - 1  # int64, as on the lost-feature path
    _, _, args2 = _blocks(dev, host_states, dtype, 2, 64)
    H2, r2, rows2 = update.feature_block_plain(*args2)
    cols = torch.cat([21 + 6 * 3 + torch.arange(6, device=dev),
                      21 + 6 * 7 + torch.arange(6, device=dev)])
    H5 = torch.zeros((64, 5, H.shape[2]), dtype=H.dtype, device=dev).index_copy(
        2, cols, H2[:, :, 21:33])
    dof5 = torch.full((64,), 2, dtype=torch.int32, device=dev)
    s2, table, cov = params.obs_noise, params.chi2_table, state.cov
    sc = _gate_scales(H, r, cov, s2, table[dof])
    odd, one = torch.arange(B, device=dev) % 2 == 1, torch.arange(B, device=dev) == B // 2
    full, short = torch.full_like(rows, R), torch.full_like(rows, 20)
    cases = [(H, r * s, rt, dof) for s in (1e-3, 1.0, 10.0, 30.0, 1e3) for rt in (rows, full)]
    cases += [(H, r * f[:, None], rt, dof) for f, rt in (
        (sc["pass"], short), (torch.where(odd, sc["fail"], sc["pass"]), short),
        (torch.where(one, sc["undecided"], sc["pass"]), short),
        (torch.where(one, sc["undecided"], sc["fail"]), full))]
    cases += [(H[:, :m], r[:, :m] * sc["undecided"][:, None], rows, dof) for m in (32, 5)]
    cases += [(H5, r2 * s, rows2, dof5) for s in (1e-3, 1.0, 30.0, 1e3)]
    idx = torch.arange(300, device=dev) % B
    cases += [(H[idx], (r * f[:, None])[idx], rows[idx], dof[idx])
              for f in (sc["pass"], torch.where(one, sc["undecided"], sc["pass"]))]
    rtol = 1e-4 if dtype == "float32" else 1e-9
    cov_odd = torch.empty(cov.numel() + 1, dtype=cov.dtype, device=dev)[1:].view(cov.shape)
    cov_odd.copy_(cov)
    for Hc, rc, rt, d in cases:
        n, syncs = update.gating_test_batch.launches, device.host_syncs["sync"]
        got = update.gating_test_batch(Hc, rc, rt, cov, s2, table, d)
        assert update.gating_test_batch.launches == n + 1
        assert device.host_syncs["sync"] == syncs
        assert got.shape == (Hc.shape[0],) and got.dtype == torch.bool
        want = update.gating_test_batch_plain(Hc, rc, rt, cov, s2, table, d)
        thresh = table[d]
        near = torch.zeros_like(got)
        for m in {min(Hc.shape[1], 32), Hc.shape[1]}:
            gamma = update.gate_gamma_plain(Hc[:, :m], rc[:, :m], cov, s2)
            near |= (gamma - thresh).abs() <= 1e-4 * thresh
        rtr = (rc * rc).sum(-1)
        tr = ((Hc @ cov) * Hc).sum((1, 2))
        near |= ((rtr - thresh * s2).abs() <= 1e-4 * rtr) | (
            (rtr - thresh * (s2 + tr)).abs() <= 1e-4 * rtr)
        assert bool(((got == want) | near).all())
        assert torch.equal(update.gating_test_batch(Hc, rc, rt, cov_odd, s2, table, d), got)
        # gamma, where the kernel computed it, against the plain version's
        ps, fs = update.gate_bounds_plain(Hc, rc, cov, s2, thresh)
        if Hc.shape[1] <= 32 or not bool((ps | fs).all()):
            m = Hc.shape[1] if Hc.shape[1] <= 32 or int(rt.max()) > 32 else 32
            _, g = update._gate_kernel(Hc, rc, rt, cov, s2, table, d, with_gamma=True)
            w = update.gate_gamma_plain(Hc[:, :m], rc[:, :m], cov, s2)
            assert torch.equal(g.isnan(), w.isnan())
            assert _rel_err(g.nan_to_num(), w.nan_to_num()) <= rtol
    # a factorisation that fails: gamma NaN fails the gate, as in the plain version
    bad = -1e6 * torch.eye(H.shape[2], dtype=H.dtype, device=dev)
    for m in (32, R):
        got = update.gating_test_batch(H[:, :m], r[:, :m], rows, bad, s2, table, dof)
        assert torch.equal(got, update.gating_test_batch_plain(H[:, :m], r[:, :m], rows, bad, s2,
                                                               table, dof))


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
    n0 = update.apply_update_rank12.launches
    got, _ = update.apply_update_rank12(state, params, Bm, rr, cols)
    assert update.apply_update_rank12.launches == n0 + 1
    want, _ = update.apply_update_rank12_plain(state, params, Bm, rr, cols)
    tol = 1e-4 if dtype == "float32" else 1e-10
    scale = float(want.cov.abs().max())
    assert torch.equal(got.cov, got.cov.T)
    for a, b in ((got.cov, want.cov), (got.imu.p, want.imu.p), (got.cams.p, want.cams.p)):
        assert float((a - b).abs().max()) <= tol * max(scale, 1.0)


def _prune_blocks(state, Kp, seed, n_in=None):
    """A prune's K9 output as the main path slices it: H12 the (Kp, 5, 12)
    columns 21-33 of (Kp, 5, 33) blocks (read in place by K12), r_blk (Kp,
    5), and ``include`` with ``n_in`` features (or ~60%) included; the
    excluded blocks hold NaN, which must not reach the update."""
    rng = np.random.default_rng(seed)
    dtype, dev = state.cov.dtype, state.cov.device
    H = torch.as_tensor(rng.normal(0, 0.8, (Kp, 5, 33)), device=dev).to(dtype)
    r_blk = torch.as_tensor(rng.normal(0, 0.02, (Kp, 5)), device=dev).to(dtype)
    if n_in is None:
        include = torch.as_tensor(rng.uniform(size=Kp) < 0.6, device=dev)
    else:
        include = torch.zeros(Kp, dtype=torch.bool, device=dev)
        include[torch.as_tensor(rng.choice(Kp, n_in, replace=False), device=dev)] = True
    H[~include] = float("nan")
    r_blk[~include] = float("nan")
    return H[:, :, 21:], r_blk, include


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("N", [20, 70])
@pytest.mark.parametrize("singular", [False, True])
def test_rank12_rows_kernel_matches_plain(dev, host_states, dtype, N, singular):
    """K12's row-indexed entry (the prune call site's masks in the launch)
    against its plain version (the masks, then apply_update_rank12's plain
    version): the covariance and the state within 1e-4 (float32) / 1e-10
    (float64) of max(|P|, 1), P_new exactly symmetric, one launch a call.
    D = 141 (the main path's window) and 441 (70 slots), 128 features of 5
    rows of which ~60% are included; ``singular``: the second camera is
    past the window's count, so P12 is exactly singular."""
    cfg, state, params, _ = _card_state(dev, host_states, dtype)
    if N != 20:
        state = _wide_state(state, N, N - 5, N)
    count = int(state.cams.count)
    r0, r1 = (count - 1, count) if singular else (4, 9)
    if singular:
        c = 21 + 6 * r1 + torch.arange(6, device=dev)
        cov = state.cov.clone()
        cov[c], cov[:, c] = 0.0, 0.0
        state = state._replace(cov=cov)
    cols = torch.cat([21 + 6 * r0 + torch.arange(6, device=dev),
                      21 + 6 * r1 + torch.arange(6, device=dev)])
    assert (int(torch.linalg.matrix_rank(state.cov[cols][:, cols].double())) < 12) == singular
    H12, r_blk, include = _prune_blocks(state, 128, N + singular)
    n0 = update.apply_update_rank12_rows.launches
    (got, warn), n_launch = _launches(
        lambda: update.apply_update_rank12_rows(state, params, H12, r_blk, include, cols))
    assert n_launch == 1 and update.apply_update_rank12_rows.launches == n0 + 1
    want, pwarn = update.apply_update_rank12_rows_plain(state, params, H12, r_blk, include, cols)
    tol = 1e-4 if dtype == "float32" else 1e-10
    scale = max(float(want.cov.abs().max()), 1.0)
    assert torch.equal(got.cov, got.cov.T) and bool(warn) == bool(pwarn)
    for name, g in _fields(got).items():
        assert float((g - _fields(want)[name]).abs().max()) <= tol * scale, name


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_rank12_rows_kernel_one_feature(dev, host_states, dtype):
    """K12's row-indexed entry on n = 640 rows (128 features of 5) with all
    but one feature excluded, against its plain version (the bars of
    test_rank12_kernel_matches_plain), and equal, bit for bit, to the same
    entry on the included feature's block alone: the excluded features'
    rows (NaN here) add nothing."""
    cfg, state, params, _ = _card_state(dev, host_states, dtype)
    cols = torch.cat([21 + 6 * 4 + torch.arange(6, device=dev),
                      21 + 6 * 9 + torch.arange(6, device=dev)])
    H12, r_blk, include = _prune_blocks(state, 128, 1, n_in=1)
    got, warn = update.apply_update_rank12_rows(state, params, H12, r_blk, include, cols)
    want, pwarn = update.apply_update_rank12_rows_plain(state, params, H12, r_blk, include, cols)
    tol = 1e-4 if dtype == "float32" else 1e-10
    scale = max(float(want.cov.abs().max()), 1.0)
    assert torch.equal(got.cov, got.cov.T) and bool(warn) == bool(pwarn)
    for name, g in _fields(got).items():
        assert float((g - _fields(want)[name]).abs().max()) <= tol * scale, name
    f = int(torch.nonzero(include)[0, 0])
    alone, _ = update.apply_update_rank12_rows(state, params, H12[f:f + 1], r_blk[f:f + 1],
                                               include[f:f + 1], cols)
    assert torch.equal(alone.cov, got.cov) and torch.equal(alone.imu.p, got.imu.p)


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


def _topk_exact(score, gr, gc, k):
    """K5 equal to its plain version, in one launch."""
    n0 = gridops.dense_grid_topk.launches
    got = gridops.dense_grid_topk(score, gr, gc, k)
    assert gridops.dense_grid_topk.launches == n0 + 1
    for g, w in zip(got, gridops.dense_grid_topk_plain(score, gr, gc, k)):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.parametrize("edge", [1, 3, 5, 7])
def test_grid_topk_ties_across_bands(dev, edge):
    """K5's band clusters (8 bands of 15 rows a cell here): in every cell a
    tie at the top value straddles the boundary between band ``edge`` - 1
    and band ``edge`` (3 pixels on the row above it, 10 on the row below),
    so the top 8 are the upper band's three and the lower band's first five
    by index; the rest of the map ties at small values."""
    rng = np.random.default_rng(edge)
    padded = rng.integers(-1, 3, (480, 755)).astype(np.int32)  # 4 x 5 cells of 120 x 151
    cells = padded.reshape(4, 120, 5, 151)
    row = edge * 120 // 8
    cells[:, row - 1, :, [100, 120, 140]] = 50
    cells[:, row, :, 0:50:5] = 50
    score = np.ascontiguousarray(padded[:, :752])
    _topk_exact(torch.as_tensor(score, device=dev), 4, 5, 8)


@pytest.mark.parametrize("k", [1, 5, 8])
def test_grid_topk_winners_in_one_band(dev, k):
    """K5 with every cell's winners in its last band (the other bands'
    lists all lose), on a sparse FAST-like map: mostly 0, a few scores."""
    rng = np.random.default_rng(k)
    padded = np.where(rng.uniform(size=(480, 755)) < 0.03, rng.integers(1, 30, (480, 755)),
                      0).astype(np.int32)
    cells = padded.reshape(4, 120, 5, 151)  # 4 x 5 cells of 120 x 151
    cells[:, 115:, :, :8] = 90 + rng.integers(0, 3, (4, 5, 5, 8)).transpose(0, 2, 1, 3)
    score = np.ascontiguousarray(padded[:, :752])
    _topk_exact(torch.as_tensor(score, device=dev), 4, 5, k)


@pytest.mark.parametrize("H,W", [(480, 752), (97, 131), (1080, 1440)])
@pytest.mark.parametrize("k", [1, 5, 8, 32, "all"])
def test_grid_topk_band_kernel_exact(dev, H, W, k):
    """K5 at k = 1, the main path's 5 and 8, 32 (the band clusters' largest)
    and every pixel of a cell (the 1024-thread path), on maps of 480x752,
    97x131 (ragged cells padded with -1) and 1080x1440 (bands staged in two
    passes): exact, with heavy ties, at the map's own address and at one
    4, 8 and 12 bytes past a 16-byte boundary (the staging's ragged rows)."""
    rng = np.random.default_rng(H + (0 if k == "all" else k))
    cell = -(-H // 4) * -(-W // 5)
    k = cell if k == "all" else k
    flat = torch.as_tensor(rng.integers(-1, 4, H * W + 3).astype(np.int32), device=dev)
    for off in (0, 1, 2, 3) if H < 1000 else (0, 1):
        _topk_exact(flat[off:off + H * W].view(H, W), 4, 5, k)


@pytest.mark.parametrize("n", [20, 100, 160, 204, 256, 1024, 1025, 1500, 20000])
def test_grid_ranking_kernels_exact(dev, n):
    """K8: every entry point exact, with heavy ties and invalid entries;
    past 1024 elements a thread owns several, and at 20000 the keys no
    longer fit a block's shared memory and are read from device memory."""
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


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("F,C,workspace", [(104, 100, False), (104, 100, True),
                                           (925, 100, False), (1100, 200, False)],
                         ids=["n204", "n204_workspace", "n1025", "n1300"])
def test_select_track_kernel_exact(dev, F, C, workspace, case, monkeypatch):
    """K8's fused per-cell selection equal to its plain version, bit for
    bit on all six outputs, in one launch: at the main path's 104 slots and
    100 candidates, past 1,024 entries, at the [limits] configuration's
    1,300, and with the working arrays forced out of shared memory into the
    device workspace."""
    if workspace:
        monkeypatch.setattr(kernels, "SMEM_PER_BLOCK", 0)
    arrays, statics = select_inputs(F + C + len(case), F, C, case)
    args = (*(torch.as_tensor(x, device=dev) for x in arrays), *statics)
    n0 = gridops.select_track.launches
    got = gridops.select_track(*args)
    assert gridops.select_track.launches == n0 + 1
    want = gridops.select_track_plain(*args)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape and torch.equal(g, w)


def test_select_track_kernel_past_shared_memory(dev):
    """K8's fused selection at 14,200 entries, whose working arrays outgrow
    a block's shared memory (the device workspace): exact."""
    arrays, statics = select_inputs(3, 14000, 200, "ties")
    args = (*(torch.as_tensor(x, device=dev) for x in arrays), *statics)
    for g, w in zip(gridops.select_track(*args), gridops.select_track_plain(*args)):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.parametrize("w", [(0.0, 0.0, 0.0), (0.3, -0.2, 0.1), (2.0, 1.0, -3.0)],
                         ids=["zero", "hover", "fast"])
@pytest.mark.parametrize("n", [104, 300])
def test_predict_warp_kernel_matches_plain(dev, w, n):
    """K7's fused prediction: the rotation within 4 float32 ulps of 1.0 and
    the warped points within 4 ulps at 752 px of the plain version (whose
    3x3 products go through the library with fused multiply-adds); the
    identity at zero rate; one launch."""
    from uav_airvision_tpu_torch.models.frontend.params import make_frontend_params

    p = make_frontend_params(euroc_config(), dev)
    rng = np.random.default_rng(n)
    pts = torch.as_tensor(rng.uniform([5, 5], [747, 475], (n, 2)), dtype=torch.float32,
                          device=dev)
    wv = torch.tensor(w, dtype=torch.float32, device=dev)
    dt = torch.tensor(0.05, dtype=torch.float32, device=dev)
    n0 = camera.predict_warp_points.launches
    got, R = camera.predict_warp_points(pts, wv, dt, p.R_cam0_imu, p.cam0_intrinsics)
    assert camera.predict_warp_points.launches == n0 + 1
    want, pR = camera.predict_warp_points_plain(pts, wv, dt, p.R_cam0_imu, p.cam0_intrinsics)
    assert float((R - pR).abs().max()) <= 4 * 2.0 ** -23
    assert float((got - want).abs().max()) <= 4 * 2.0 ** -14
    if not any(w):
        assert torch.equal(R, torch.eye(3, device=dev))


def _ulps_from(value, thresh):
    """|value - thresh| in float32 ulps of ``thresh``."""
    spacing = torch.as_tensor(np.spacing(np.abs(thresh.detach().cpu().numpy()).astype(np.float32)),
                              device=value.device)
    return (value - thresh).abs() / spacing


@pytest.mark.parametrize("model", ["radtan", "equidistant"])
def test_stereo_gate_kernel_matches_plain(dev, model):
    """K7's fused stereo gate: decisions identical to the plain version's,
    except where a cut's value lies within 8 float32 ulps of its threshold
    (the plain version's norms and the epipolar line's product go through
    the library with fused multiply-adds); one launch."""
    from uav_airvision_tpu_torch.models.frontend.params import make_frontend_params

    cfg = euroc_config()
    fe = cfg.frontend
    p = make_frontend_params(cfg, dev)
    co = p.cam0_coeffs if model == "radtan" else torch.tensor(
        [-0.0113, 0.0052, -0.0021, 0.0005], device=dev)
    rng = np.random.default_rng(21)
    B = 204
    cam0 = rng.uniform([5, 5], [747, 475], (B, 2))
    p1 = cam0 - np.stack([rng.uniform(0, 40, B), rng.uniform(-3, 3, B)], 1)
    p1[:4] = [[-0.5, 100], [751.99, 50], [100, -0.25], [100, 479.5]]
    p0r = cam0 + rng.normal(0, 2, (B, 2))
    cam0, p1, p0r = (torch.as_tensor(x, dtype=torch.float32, device=dev) for x in (cam0, p1, p0r))
    valid = torch.as_tensor(rng.uniform(size=B) < 0.9, device=dev)
    st = torch.as_tensor(rng.uniform(size=B) < 0.9, device=dev)
    _, proj1 = camera.undistort_distort_points(cam0, p.cam0_intrinsics, model, co, p.R0to1)
    args = (cam0, p1, p0r, proj1, valid, st, p.cam0_intrinsics, model, co, p.E,
            fe.fwd_bwd_error_px, fe.max_vertical_disparity_px, fe.stereo_threshold, 480, 752)
    n0 = camera.stereo_gate.launches
    got = camera.stereo_gate(*args)
    assert camera.stereo_gate.launches == n0 + 1
    want = camera.stereo_gate_plain(*args)
    flips = got != want
    if bool(flips.any()):
        epi = camera.epipolar_residual_plain(cam0, p1, p.cam0_intrinsics, model, co, p.E)
        fx, fy = p.cam0_intrinsics[0], p.cam0_intrinsics[1]
        thr = fe.stereo_threshold * (4.0 / (2.0 * fx + 2.0 * fy))
        err = torch.linalg.norm(cam0 - p0r, dim=-1)
        near = torch.minimum(_ulps_from(epi, thr.expand(B)),
                             _ulps_from(err, torch.full_like(err, fe.fwd_bwd_error_px)))
        assert bool((near[flips] <= 8).all())


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


def _launches(fn):
    """(result, kernel launches the call made), by torch.profiler."""
    from uav_airvision_tpu_torch.profile_main import LAUNCH_CALLS

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        out = fn()
        torch.cuda.synchronize()
    return out, sum(e.count for e in prof.key_averages() if e.key in LAUNCH_CALLS)


def _fields(state):
    """The fields an EKF update changes."""
    i, c = state.imu, state.cams
    return {"q": i.q, "bg": i.bg, "v": i.v, "ba": i.ba, "p": i.p, "R_imu_cam0": i.R_imu_cam0,
            "t_cam0_imu": i.t_cam0_imu, "cams.q": c.q, "cams.p": c.p, "cov": state.cov}


def _wide_state(state, N, count, seed):
    """``state`` with an N-slot window (its poses repeated, nudged) of which
    ``count`` are live, and a random SPD covariance of 21 + 6N rows."""
    c = state.cams
    idx = torch.arange(N, device=c.q.device) % c.q.shape[0]
    nudge = 1e-3 * (torch.arange(N, device=c.q.device) // c.q.shape[0])[:, None]
    cams = c._replace(q=c.q[idx].contiguous(), p=(c.p[idx] + nudge.to(c.p.dtype)).contiguous(),
                      q_null=c.q_null[idx].contiguous(), p_null=c.p_null[idx].contiguous(),
                      count=torch.tensor(count, dtype=torch.int32, device=c.q.device))
    D = 21 + 6 * N
    rng = np.random.default_rng(seed)
    A = torch.as_tensor(rng.normal(0, 0.02, (D, D)), device=c.q.device)
    cov = (A @ A.T / D + 1e-4 * torch.eye(D, dtype=A.dtype, device=A.device))
    return state._replace(cams=cams, cov=cov.to(state.cov.dtype))


@pytest.mark.parametrize("N,n_rows", [(20, 26), (20, 60), (20, 250), (20, 700), (20, None),
                                      (90, 80), (90, 1122), (90, 1500)],
                         ids=["T1_26", "T1", "T2", "QR", "all", "N90_T1", "N90_T2", "N90_QR"])
def test_apply_update_fused_matches_plain(dev, host_states, N, n_rows):
    """K11 as the main path calls it, the update and the injection in ONE
    launch (torch.profiler), held to apply_update_plain in float64 on every
    field of the new state within 1e-12 of the field's largest entry (P_new
    exactly symmetric, too_large equal); the injection leaves the slots past
    the window's count as they were.  N = 90 (D = 561, T2 = 1122 rows) is
    past the old one-block limit of 1024 rows.  And K12's launch, which
    ends in the same injection, held the same way."""
    cfg, state, params, _ = _card_state(dev, host_states, "float64")
    if N != 20:
        state = _wide_state(state, N, N - 5, N)
    D = state.cov.shape[0]
    rng = np.random.default_rng(D + (n_rows or 0))
    R = 200 if n_rows is None else max(1680, n_rows + 100)
    m = R if n_rows is None else n_rows
    H = torch.zeros((R, D), dtype=torch.float64, device=dev)
    H[:m, 21:] = torch.as_tensor(rng.normal(0, 0.05, (m, D - 21)), device=dev)
    r = torch.zeros(R, dtype=torch.float64, device=dev)
    r[:m] = torch.as_tensor(rng.normal(0, 0.01, m), device=dev)
    n0 = update.apply_update.launches
    (got, warn), n_launch = _launches(lambda: update.apply_update(state, params, H, r, n_rows))
    assert n_launch == 1 and update.apply_update.launches == n0 + 1
    want, pwarn = update.apply_update_plain(state, params, H, r, n_rows)
    assert bool(warn) == bool(pwarn)
    for name, g in _fields(got).items():
        w = _fields(want)[name]
        assert g.shape == w.shape and g.dtype == w.dtype, name
        assert float((g - w).abs().max()) <= 1e-12 * float(w.abs().max()), name
    assert torch.equal(got.cov, got.cov.T)
    live = state.cams.count
    assert torch.equal(got.cams.q[live:], state.cams.q[live:])
    # K12: the prune's two cameras
    cols = torch.cat([21 + 6 * 4 + torch.arange(6, device=dev),
                      21 + 6 * 9 + torch.arange(6, device=dev)])
    Bm = torch.as_tensor(rng.normal(0, 0.8, (320, 12)), device=dev)
    rr = torch.as_tensor(rng.normal(0, 0.02, 320), device=dev)
    n0 = update.apply_update_rank12.launches
    (got, warn), n_launch = _launches(
        lambda: update.apply_update_rank12(state, params, Bm, rr, cols))
    assert n_launch == 1 and update.apply_update_rank12.launches == n0 + 1
    want, pwarn = update.apply_update_rank12_plain(state, params, Bm, rr, cols)
    assert bool(warn) == bool(pwarn)
    for name, g in _fields(got).items():
        w = _fields(want)[name]
        assert float((g - w).abs().max()) <= 1e-10 * max(float(w.abs().max()), 1.0), name


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_apply_update_fused_failed_cholesky(dev, host_states, dtype):
    """A failed factorisation makes delta, P_new and the injected live poses
    NaN, as the plain version's (too_large stays False: NaN compares
    False), in one launch."""
    cfg, state, params, _ = _card_state(dev, host_states, dtype)
    D = state.cov.shape[0]
    bad = state._replace(cov=-1e6 * torch.eye(D, dtype=state.cov.dtype, device=dev))
    rng = np.random.default_rng(1)
    H = torch.zeros((1680, D), dtype=state.cov.dtype, device=dev)
    H[:26, 21:] = torch.as_tensor(rng.normal(0, 0.05, (26, D - 21)), device=dev)
    r = torch.ones(1680, dtype=state.cov.dtype, device=dev)
    P_new, delta, got, warn = update._ekf_update_kernel(bad.cov, H, r, params.obs_noise, 26, bad)
    want, pwarn = update.apply_update_plain(bad, params, H, r, 26)
    assert bool(delta.isnan().all()) and bool(P_new.isnan().all())
    assert bool(got.cov.isnan().all()) and bool(got.imu.p.isnan().all())
    assert bool(warn) == bool(pwarn)
    for name, g in _fields(got).items():
        assert torch.equal(g.isnan(), _fields(want)[name].isnan()), name


@pytest.mark.parametrize("k", [8, 9, 12, 40])
def test_grid_topk_kernel_past_8(dev, k):
    """K5 at k = 8 (the old limit) and past it, exact: in cells of 12,000
    pixels where one thread's strided share holds more than 8 of the
    winners (it rescans its share), with ties broken by index."""
    rng = np.random.default_rng(k)
    score = rng.integers(-1, 4, (240, 250)).astype(np.int32)
    cells = score.reshape(2, 120, 1, 250).transpose(0, 2, 1, 3).reshape(2, -1)
    cells[:, ::1024] = 50 + np.arange(cells[:, ::1024].shape[1])
    cells[:, 7::1024] = 40
    score = torch.as_tensor(cells.reshape(2, 1, 120, 250).transpose(0, 2, 1, 3)
                            .reshape(240, 250).copy(), device=dev)
    got = gridops.dense_grid_topk(score, 2, 1, k)
    for g, w in zip(got, gridops.dense_grid_topk_plain(score, 2, 1, k)):
        assert torch.equal(g, w)
    img = torch.as_tensor(np.random.default_rng(k + 1).integers(-1, 4, (480, 752)),
                          dtype=torch.int32, device=dev)
    for g, w in zip(gridops.dense_grid_topk(img, 4, 5, k),
                    gridops.dense_grid_topk_plain(img, 4, 5, k)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("n", [1024, 1025, 1500, 3000])
def test_fast_kernel_mask_points(dev, n):
    """K4+K6 with n mask points (1024 was the most it took): exact; each
    block takes every point whose 7x7 box meets its tile."""
    img = torch.as_tensor(_image(480, 752, 5), device=dev)
    rng = np.random.default_rng(n)
    pts = torch.as_tensor(rng.uniform([0, 0], [752, 480], (n, 2)), dtype=torch.float32,
                          device=dev)
    valid = torch.as_tensor(rng.uniform(size=n) < 0.9, device=dev)
    k, s = fast.detect_fast(img, 15, pts, valid)
    pk, ps = fast.detect_fast_plain(img, 15, pts, valid)
    assert torch.equal(k, pk) and torch.equal(s, ps)


@pytest.mark.parametrize("dtype,N", [("float32", 64), ("float32", 65), ("float64", 64),
                                     ("float64", 65), ("float64", 130), ("float64", 300)])
def test_triangulate_kernel_many_slots(dev, host_states, dtype, N):
    """K13 with N window slots (64 was the most it took): 2, 4 or 8 slots a
    lane in registers, past 256 rebuilt at each use.  The window repeats
    the real one's 20 poses, nudged, and 128 features as in
    test_triangulate_kernel_matches_plain; K13's bars as at N = 20.  Past
    65 slots float64 only: in float32 the sums over 2N views (260 at
    N = 130) round far enough apart in the warp's reductions and the plain
    version's sums that more than 5% of the unconverged solves end a step
    apart (3.1e-4 seen), so the four-and-eight-slot code is held in float64."""
    cfg, state, params, sel = _card_state(dev, host_states, dtype)
    wide = _wide_state(state, N, N, N)
    c, t = wide.cams, state.features
    B = 128
    f = sel[torch.arange(B, device=dev) % len(sel)]
    slots = torch.arange(N, device=dev) % 20
    rng = np.random.default_rng(N)
    obs = t.obs[f][:, slots]
    obs[len(sel):] += torch.as_tensor(rng.normal(0, 2e-3, (B - len(sel),) + obs.shape[1:]),
                                      device=dev).to(obs.dtype)
    active = torch.as_tensor(rng.uniform(size=B) < 0.85, device=dev)
    args = (c.q, c.p, obs, t.obs_mask[f][:, slots], params.R_cam0_cam1, params.t_cam0_cam1,
            cfg.triangulation, active)
    pos, ok = triangulation.triangulate(*args)
    ppos, pok = triangulation.triangulate_plain(*args)
    assert torch.equal(ok, pok)
    err = (pos - ppos).abs().max(1).values / ppos.abs().max(1).values.clamp(min=1.0)
    if dtype == "float32":
        assert float(err.max()) <= 1e-3 and float((err <= 1e-4).float().mean()) >= 0.95
    else:
        assert float(err.max()) <= 1e-7


@pytest.mark.parametrize("dtype,N", [("float64", 34), ("float64", 35), ("float32", 48),
                                     ("float32", 49)])
def test_feature_block_kernel_wide(dev, host_states, dtype, N):
    """K9 at the window sizes around the old limit of its dense tile in a
    block's shared memory (35 slots in float64, 49 in float32; the kernel
    now holds O(N) values): K9's bars as at N = 20."""
    cfg, state, params, sel = _card_state(dev, host_states, dtype)
    wide = _wide_state(state, N, N, N)
    c, t = wide.cams, state.features
    idx = torch.arange(N, device=dev) % 20
    B = 16
    f = sel[torch.arange(B, device=dev) % len(sel)]
    args = (c.q, c.p, c.q_null, c.p_null, t.obs[f][:, idx], t.obs_mask[f][:, idx],
            t.position[f], state.gravity, params.R_cam0_cam1, params.t_cam0_cam1, 21 + 6 * N)
    H, r, rows = update.feature_block(*args)
    pH, pr, prows = update.feature_block_plain(*args)
    assert torch.equal(rows, prows)
    tol = 1e-5 if dtype == "float32" else 1e-10
    scale = torch.maximum(pH.abs().amax((1, 2)), pr.abs().amax(1)).clamp(min=1e-30)
    for got, want in ((H, pH), (r, pr)):
        assert float(((got - want).abs().flatten(1).amax(1) / scale).max()) <= tol


@pytest.mark.parametrize("win", [15, 17, 21, 31, 33])
def test_lk_kernel_window_sides(dev, win):
    """K1 at window sides other than 15 (the only one it took): the
    instantiations for 17, 21 and 31 and the looped one at 33, both entry
    points, 1 to 4 levels, held to the plain version with K1's bars."""
    img0 = _image(240, 320, 4)
    img1 = np.roll(img0, (2, -3), axis=(0, 1))
    p0 = pyramid.build_pyramid_padded(torch.as_tensor(img0, device=dev), 3)
    p1 = pyramid.build_pyramid_padded(torch.as_tensor(img1, device=dev), 3)
    rng = np.random.default_rng(win)
    pts = torch.as_tensor(rng.uniform([1, 1], [318, 238], (60, 2)), dtype=torch.float32,
                          device=dev)
    valid = torch.ones(60, dtype=torch.bool, device=dev)
    for n_levels, compact in ((n, c) for n in (1, 2, 3, 4) for c in (False, True)):
        args = dict(win=win, max_iter=10, n_levels=n_levels, max_iter_upper=5,
                    compact_windows=compact)
        kn, ks = lk.pyramidal_lk(p0, p1, pts, pts, valid, **args)
        pn, ps = lk.pyramidal_lk_plain(p0, p1, pts, pts, valid, **args)
        assert (ks == ps).float().mean() >= 0.99, (n_levels, compact)
        both = ks & ps
        assert int(both.sum()) >= 20, (n_levels, compact)
        assert float((kn[both] - pn[both]).abs().max()) <= 1e-3, (n_levels, compact)


def test_lk_kernel_templates_level_by_level(dev):
    """Side 45 at 7 levels: every level's template (48^2 + 47^2 + 2 x 45^2
    floats and 160 partial sums a level) does not fit a block's shared
    memory, so ``lk_kernel`` (the looped instantiation) builds each level's
    template before its steps, in one slot.  Held to the plain version with
    K1's bars, as at 6 levels, where every level's fits."""
    slot = 48 ** 2 + 47 ** 2 + 2 * 45 ** 2 + 32 * 5
    assert (7 * slot + 128) * 4 > 232448 >= (6 * slot + 128) * 4
    img0 = _image(2048, 2048, 45)
    img1 = np.roll(img0, (2, -3), axis=(0, 1))
    p0 = pyramid.build_pyramid_padded(torch.as_tensor(img0, device=dev), 6)
    p1 = pyramid.build_pyramid_padded(torch.as_tensor(img1, device=dev), 6)
    rng = np.random.default_rng(45)
    pts = torch.as_tensor(rng.uniform([40, 40], [2008, 2008], (60, 2)), dtype=torch.float32,
                          device=dev)
    valid = torch.ones(60, dtype=torch.bool, device=dev)
    for n_levels in (6, 7):
        args = dict(win=45, max_iter=10, n_levels=n_levels, max_iter_upper=5)
        kn, ks = lk.pyramidal_lk(p0, p1, pts, pts, valid, **args)
        pn, ps = lk.pyramidal_lk_plain(p0, p1, pts, pts, valid, **args)
        assert (ks == ps).float().mean() >= 0.99, n_levels
        both = ks & ps
        assert int(both.sum()) >= 20, n_levels
        assert float((kn[both] - pn[both]).abs().max()) <= 1e-3, n_levels


@pytest.mark.parametrize("n_levels", [1, 2, 3, 4])
def test_lk_kernel_clocks(dev, n_levels):
    """K1's phase clocks (block 0's SM clock at its start and, coarse to
    fine, when each level's template is ready, after its Gauss-Newton steps,
    and its step count): non-decreasing, each level's steps at most its
    cap, the points and status those of the launch without clocks."""
    img0 = _image(480, 752, 7)
    img1 = np.roll(img0, (2, -3), axis=(0, 1))
    p0 = pyramid.build_pyramid_padded(torch.as_tensor(img0, device=dev), 3)
    p1 = pyramid.build_pyramid_padded(torch.as_tensor(img1, device=dev), 3)
    pts = torch.as_tensor(_lk_points(104, 752, 480, 15, 7), dtype=torch.float32, device=dev)
    valid = torch.ones(104, dtype=torch.bool, device=dev)
    args = dict(max_iter=10, n_levels=n_levels, max_iter_upper=5)
    clocks = torch.full((1 + 3 * n_levels,), -1, dtype=torch.int64, device=dev)
    kn, ks = lk.pyramidal_lk(p0, p1, pts, pts + 1.0, valid, clocks=clocks, **args)
    wn, ws = lk.pyramidal_lk(p0, p1, pts, pts + 1.0, valid, **args)
    assert torch.equal(kn, wn) and torch.equal(ks, ws)
    c = clocks.tolist()
    times = [c[0]] + [c[1 + 3 * k + j] for k in range(n_levels) for j in (0, 1)]
    assert c[0] > 0 and all(b >= a for a, b in zip(times, times[1:])), c
    for k in range(n_levels):
        cap = 10 if k == n_levels - 1 else 5  # level 0 is the last, finest
        assert 0 <= c[3 + 3 * k] <= cap, c


@pytest.mark.parametrize("dtype,N", [("float32", 35), ("float32", 36), ("float64", 24),
                                     ("float64", 25)])
def test_gate_kernel_wide(dev, host_states, dtype, N):
    """K10 at the last window size whose smallest layout fits a block's
    shared memory and one past it (each block's H, H P chunk and S then
    live in a device workspace), on the lost-feature blocks of N slots and
    their 32-row prefixes: decisions equal to the plain version's except
    where gamma lies within 1e-4 of the threshold or r'r within 1e-4 of a
    bound, gamma within 1e-4 (float32) / 1e-9 (float64) relative where the
    kernel computes it; one launch per call."""
    cfg, state, params, sel = _card_state(dev, host_states, dtype)
    wide = _wide_state(state, N, N, N)
    c, t = wide.cams, state.features
    B = 16
    f = sel[torch.arange(B, device=dev) % len(sel)]
    slots = torch.arange(N, device=dev) % 20
    H, r, rows = update.feature_block_plain(
        c.q, c.p, c.q_null, c.p_null, t.obs[f][:, slots], t.obs_mask[f][:, slots],
        t.position[f], state.gravity, params.R_cam0_cam1, params.t_cam0_cam1, 21 + 6 * N)
    H, r = H.contiguous(), r.contiguous()
    dof = t.obs_mask[f][:, slots].sum(1) - 1
    s2, table, cov = params.obs_noise, params.chi2_table, wide.cov
    sc = _gate_scales(H, r, cov, s2, table[dof])
    one = torch.arange(B, device=dev) == B // 2
    rtol = 1e-4 if dtype == "float32" else 1e-9
    cases = [(H, r * s, rows) for s in (1e-3, 1.0, 1e3)]
    cases += [(H, r * torch.where(one, sc["undecided"], sc["pass"])[:, None], rows),
              (H[:, :32], r[:, :32] * sc["undecided"][:, None], rows)]
    for Hc, rc, rt in cases:
        n = update.gating_test_batch.launches
        got = update.gating_test_batch(Hc, rc, rt, cov, s2, table, dof)
        assert update.gating_test_batch.launches == n + 1
        want = update.gating_test_batch_plain(Hc, rc, rt, cov, s2, table, dof)
        thresh = table[dof]
        near = torch.zeros_like(got)
        for m in {min(Hc.shape[1], 32), Hc.shape[1]}:
            gamma = update.gate_gamma_plain(Hc[:, :m], rc[:, :m], cov, s2)
            near |= (gamma - thresh).abs() <= 1e-4 * thresh
        rtr = (rc * rc).sum(-1)
        tr = ((Hc @ cov) * Hc).sum((1, 2))
        near |= ((rtr - thresh * s2).abs() <= 1e-4 * rtr) | (
            (rtr - thresh * (s2 + tr)).abs() <= 1e-4 * rtr)
        assert bool(((got == want) | near).all())
        ps, fs = update.gate_bounds_plain(Hc, rc, cov, s2, thresh)
        if Hc.shape[1] <= 32 or not bool((ps | fs).all()):
            m = Hc.shape[1] if Hc.shape[1] <= 32 or int(rt.max()) > 32 else 32
            _, g = update._gate_kernel(Hc, rc, rt, cov, s2, table, dof, with_gamma=True)
            w = update.gate_gamma_plain(Hc[:, :m], rc[:, :m], cov, s2)
            assert torch.equal(g.isnan(), w.isnan())
            assert _rel_err(g.nan_to_num(), w.nan_to_num()) <= rtol


def _corner_image(H, W, seed, kind):
    """Images with many FAST corners: uniform noise, or a flat grey field
    with isolated black and white pixels (rings all brighter or all darker
    than their centre)."""
    rng = np.random.default_rng(seed)
    if kind == "noise":
        return rng.integers(0, 256, (H, W)).astype(np.uint8)
    img = np.full((H, W), 128, np.uint8)
    n = H * W // 20
    img[rng.integers(0, H, n), rng.integers(0, W, n)] = rng.choice([0, 255], n)
    return img


@pytest.mark.parametrize("H,W", [(480, 752), (1080, 1440), (31, 29), (16, 32), (5, 9)])
@pytest.mark.parametrize("n", [0, 104, 1500])
def test_fast_kernel_one_launch_exact(dev, H, W, n):
    """K4+K6, one launch a call, bit for bit equal to its plain version on
    the blocky texture, on noise and on isolated dots (every quick-rejection
    outcome), with 0, 104 or 1500 mask points: random ones, points on the
    32x16 tiles' corners and edges (and half a pixel off them), and points
    with floor(x) < 3 or floor(y) < 3 (which mask nothing).  The odd sizes
    are no multiple of the tile and stage by byte loads; an image at an odd
    address does too."""
    rng = np.random.default_rng(H * W + n)
    pts = rng.uniform([-3, -3], [W + 3, H + 3], (n, 2))
    if n:
        ex, ey = np.meshgrid(np.arange(0, W + 1, 32), np.arange(0, H + 1, 16))
        edge = np.stack([ex.ravel(), ey.ravel()], 1).astype(np.float64)
        edge = np.concatenate([edge, edge - 0.5, edge + [16.0, 0.0], edge + [0.0, 8.0]])
        k = min(len(edge), n // 2)
        pts[:k] = edge[:k]
        pts[k:k + 4] = [[2.9, 40.0], [40.0, 2.5], [1.0, 1.0], [3.0, 3.0]][: max(0, min(4, n - k))]
    pts = torch.as_tensor(pts, dtype=torch.float32, device=dev)
    valid = torch.as_tensor(rng.uniform(size=n) < 0.9, device=dev)
    args = (pts, valid) if n else ()
    for kind in ("blocky", "noise", "dots"):
        img = _image(H, W, 7) if kind == "blocky" else _corner_image(H, W, 8, kind)
        img = torch.as_tensor(img, device=dev)
        odd = torch.empty(H * W + 1, dtype=torch.uint8, device=dev)[1:].view(H, W)
        odd.copy_(img)
        for thr in (15, 40):
            want = fast.detect_fast_plain(img, thr, *args)
            n0 = fast.detect_fast.launches
            got = fast.detect_fast(img, thr, *args)
            assert fast.detect_fast.launches == n0 + 1
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
            assert torch.equal(got[0], got[1] > 0)
            g = fast.detect_fast(odd, thr, *args)
            assert torch.equal(g[0], want[0]) and torch.equal(g[1], want[1])
    if (H, W) == (480, 752):
        from uav_airvision_tpu_torch.profile_main import LAUNCH_CALLS

        fast.detect_fast(img, 15, *args)
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            fast.detect_fast(img, 15, *args)
            torch.cuda.synchronize()
        assert sum(e.count for e in prof.key_averages() if e.key in LAUNCH_CALLS) == 1


def _two_view_slots(t):
    """The two window slots that the most features are seen from together
    (the prune's ``rm``), and those features."""
    both = (t.obs_mask[:, :, None] & t.obs_mask[:, None, :] & t.valid[:, None, None]).sum(0)
    both.fill_diagonal_(0)
    i, j = divmod(int(both.argmax()), both.shape[0])
    rm = torch.tensor(sorted((i, j)), device=t.obs.device)
    return rm, torch.nonzero(t.valid & (t.obs_mask[:, rm].sum(1) == 2))[:, 0]


def _rows_inputs(dev, host_states, dtype, N):
    """``feature_block_rows`` arguments (less ``proc``) over an N-slot window
    (N = 2: the prune's form, the two slots ``rm`` of the 20-slot window;
    N = 1 the slot that sees the most features; N > 20 the window repeated) and 40 map
    rows: the real features seen by the window (repeated) and padding rows,
    three of which are rewritten as a feature cut to one view, one cut to no
    view and (N > 2) one whose point sits on the centre of a camera that
    sees it (non-finite Jacobians and residual there, scrubbed).  Returns
    (args, rm, the special rows' positions in ``sel``)."""
    cfg, state, params, sel = _card_state(dev, host_states, dtype)
    c, t = state.cams, state.features
    obs, mask, pos = t.obs.clone(), t.obs_mask.clone(), t.position.clone()
    rm = None
    if N == 2:
        rm, base = _two_view_slots(t)
    elif N != 20:
        if N > 20:
            idx = torch.arange(N, device=dev) % 20
            c = _wide_state(state, N, N, N).cams
        else:  # the slots that see the most features
            idx = torch.sort(torch.argsort((mask & t.valid[:, None]).sum(0), descending=True,
                                           stable=True)[:N]).values
            c = c._replace(q=c.q[idx], p=c.p[idx], q_null=c.q_null[idx], p_null=c.p_null[idx])
        obs, mask = obs[:, idx].contiguous(), mask[:, idx].contiguous()
        base = torch.nonzero(t.valid & mask.any(1))[:, 0] if N < 20 else sel
    else:
        base = sel
    assert len(base) >= 2
    M = obs.shape[0]
    rng = np.random.default_rng(N)
    pad = torch.as_tensor(rng.choice(np.setdiff1d(np.arange(M), base.cpu().numpy()), 8,
                                     replace=False), device=dev)
    rows = torch.cat([base[torch.arange(32, device=dev) % len(base)], pad])
    slots = rm if rm is not None else torch.arange(mask.shape[1], device=dev)
    one, none, bad = (int(x) for x in pad[:3])
    for dst, src in ((one, base[0]), (none, base[0]), (bad, base[1])):
        obs[dst], mask[dst], pos[dst] = obs[src], mask[src], pos[src]
    seen = torch.nonzero(mask[one][slots])[:, 0]
    mask[one, slots[seen[1:]]] = False
    mask[none, slots] = False
    if N > 2:  # with one or two views the scrub would leave a degenerate H_f
        first = slots[torch.nonzero(mask[bad][slots])[0, 0]]
        pos[bad] = c.p[first]
    args = (c.q, c.p, c.q_null, c.p_null, obs, mask, pos, rows, state.gravity,
            params.R_cam0_cam1, params.t_cam0_cam1, 21 + 6 * c.q.shape[0])
    return args, rm, torch.arange(32, 35, device=dev)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("N", [1, 2, 20, 35, 49, 70])
@pytest.mark.parametrize("proc_kind", ["all", "none", "mixed"])
def test_feature_block_rows_kernel_matches_plain(dev, host_states, dtype, N, proc_kind):
    """K9's row-indexed entry (the gathers, the blocks and the ``proc``
    masking in one launch) against its plain version (the call sites'
    code): rows_true exact; H_proj and r_proj within 1e-10 (float64) of each
    block's largest entry of [H_proj | r_proj]; in float32 within 3e-5 (1e-4
    for the prune's N = 2 blocks) where the block observes its feature from
    two views or more.  A one-view block is all cancellation in float32
    (its one row is what the three reflections leave of four; both float32
    versions are up to ~4e-3 of its largest entry off float64): there the
    bar is taken of the unprojected block's largest entry.  Blocks whose ``proc`` is false are
    zeros with rows 0; a non-finite Jacobian is scrubbed to 0 as in the
    plain version."""
    args, rm, special = _rows_inputs(dev, host_states, dtype, N)
    B = args[7].shape[0]
    rng = np.random.default_rng(B + N)
    proc = {"all": torch.ones(B, dtype=torch.bool, device=dev),
            "none": torch.zeros(B, dtype=torch.bool, device=dev),
            "mixed": torch.as_tensor(rng.uniform(size=B) < 0.7, device=dev)}[proc_kind]
    if proc_kind == "mixed":
        proc[special] = True
    full = (*args[:8], proc, *args[8:])
    n0 = update.feature_block_rows.launches
    H, r, rows = update.feature_block_rows(*full, rm=rm)
    assert update.feature_block_rows.launches == n0 + 1
    pH, pr, prows = update.feature_block_rows_plain(*full, rm=rm)
    assert torch.equal(rows, prows)
    assert not bool(H[~proc].any()) and not bool(r[~proc].any()) and not bool(rows[~proc].any())
    scale = torch.maximum(pH.abs().amax((1, 2)), pr.abs().amax(1)).clamp(min=1e-30)

    def err(g, w, h, v):
        return torch.maximum((g - w).abs().flatten(1).amax(1),
                             (h - v).abs().flatten(1).amax(1)) / scale

    e = err(H, pH, r, pr)
    if dtype == "float64":
        assert float(e.max()) <= 1e-10
        return
    mask = args[5][args[7]] if rm is None else args[5][args[7]][:, rm]
    views = mask.sum(1)
    tol = 1e-4 if N == 2 else 3e-5
    assert float(torch.cat([e[views >= 2], e.new_zeros(1)]).max()) <= tol
    one = proc & (views == 1)
    if bool(one.any()):
        # the unprojected blocks' largest entries
        c_q, c_p, c_qn, c_pn, obs, obs_mask, pos, sel = full[:8]
        if rm is not None:
            c_q, c_p, c_qn, c_pn = c_q[rm], c_p[rm], c_qn[rm], c_pn[rm]
            obs, obs_mask = obs[:, rm], obs_mask[:, rm]
        T0, _ = update.stacked_tile(c_q, c_p, c_qn, c_pn, obs[sel], obs_mask[sel], pos[sel],
                                    *full[9:12])
        e_in = err(H, pH, r, pr) * scale / T0.abs().flatten(1).amax(1).clamp(min=1e-30)
        assert float(e_in[one].max()) <= tol


# --- the fleet's instance axis (K2, K4+K6, K5, K1) ----------------------------

@pytest.mark.parametrize("B,H,W", [(4, 480, 752), (3, 95, 131), (2, 1080, 1440)])
def test_pyramid_kernel_batched(dev, B, H, W):
    """K2 over B instances' pairs in one launch: each camera's B pyramids
    one batch, each instance bit for bit its single launch and the batched
    plain version (the band plan at 752x480 and odd sizes, the level passes
    at 1440x1080)."""
    cam0 = torch.as_tensor(np.stack([_image(H, W, 10 + b) for b in range(B)]), device=dev)
    cam1 = torch.as_tensor(np.stack([_image(H, W, 20 + b) for b in range(B)]), device=dev)
    n = pyramid.build_pyramid_pair.launches
    got = pyramid.build_pyramid_pair(cam0, cam1, 3)
    assert pyramid.build_pyramid_pair.launches == n + 1
    want = pyramid.build_pyramid_pair_plain(cam0, cam1, 3)
    for g, w in zip(got, want):
        assert g.batch == B and torch.equal(g.flat, w.flat)
    for b in range(B):
        one = pyramid.build_pyramid_pair(cam0[b], cam1[b], 3)
        for g, o in zip(got, one):
            assert torch.equal(g.instance(b).flat, o.flat)


@pytest.mark.parametrize("B", [1, 4, 8])
def test_fast_kernel_batched(dev, B):
    """K4+K6 over B images, each with its own mask points, in one launch:
    equal to the batched plain version and to B single launches."""
    rng = np.random.default_rng(B)
    img = torch.as_tensor(np.stack([_image(480, 752, 30 + b) for b in range(B)]), device=dev)
    pts = torch.as_tensor(rng.uniform([0, 0], [751, 479], (B, 104, 2)), dtype=torch.float32,
                          device=dev)
    valid = torch.as_tensor(rng.uniform(size=(B, 104)) < 0.8, device=dev)
    n = fast.detect_fast.launches
    k, s = fast.detect_fast(img, 20, pts, valid)
    assert fast.detect_fast.launches == n + 1 and k.shape == (B, 480, 752)
    pk, ps = fast.detect_fast_plain(img, 20, pts, valid)
    assert torch.equal(k, pk) and torch.equal(s, ps)
    for b in range(B):
        k1, s1 = fast.detect_fast(img[b], 20, pts[b], valid[b])
        assert torch.equal(k[b], k1) and torch.equal(s[b], s1)


@pytest.mark.parametrize("k", [5, 8, 40])
def test_grid_topk_kernel_batched(dev, k):
    """K5 over B = 4 maps in one launch (the band clusters at k <= 32, the
    1024-thread path past it): equal to the batched plain version and to
    the single launches."""
    rng = np.random.default_rng(k)
    score = torch.as_tensor(rng.integers(-1, 60, (4, 480, 752)) * (rng.uniform(size=(4, 480, 752))
                                                                  < 0.02), dtype=torch.int32,
                            device=dev)
    n = gridops.dense_grid_topk.launches
    got = gridops.dense_grid_topk(score, 4, 5, k)
    assert gridops.dense_grid_topk.launches == n + 1 and got[0].shape == (4, 20, k)
    want = gridops.dense_grid_topk_plain(score, 4, 5, k)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    for b in range(4):
        one = gridops.dense_grid_topk(score[b], 4, 5, k)
        assert all(torch.equal(g[b], o) for g, o in zip(got, one))


@pytest.mark.parametrize("compact", [False, True])
def test_lk_kernel_batched(dev, compact):
    """K1 (either tracker) over B = 4 instances' points and batched
    pyramids in one launch: each instance bit for bit its single launch
    (the compact entry's window origins too), and against the batched
    plain version K1's bars (status agreeing on >= 99% of points, agreeing
    points within 1e-3 px)."""
    B, F = 4, 104
    rng = np.random.default_rng(7)
    cam0 = torch.as_tensor(np.stack([_image(480, 752, 40 + b) for b in range(B)]), device=dev)
    shifted = torch.roll(cam0, shifts=(1, 2), dims=(1, 2))
    p0, p1 = pyramid.build_pyramid_pair(cam0, shifted, 3)
    pts = torch.as_tensor(rng.uniform([20, 20], [730, 460], (B, F, 2)), dtype=torch.float32,
                          device=dev)
    valid = torch.as_tensor(rng.uniform(size=(B, F)) < 0.9, device=dev)
    kw = dict(n_levels=2, max_iter=10, max_iter_upper=5)
    if compact:
        des = torch.zeros((B, F, 2, 2), dtype=torch.int32, device=dev)
        n = lk.pyramidal_lk_compact.launches
        got = lk.pyramidal_lk_compact(p0, p1, pts, pts + 1.0, valid, des=des, **kw)
        assert lk.pyramidal_lk_compact.launches == n + 1
    else:
        n = lk.pyramidal_lk.launches
        got = lk.pyramidal_lk(p0, p1, pts, pts + 1.0, valid, **kw)
        assert lk.pyramidal_lk.launches == n + 1
    for b in range(B):
        if compact:
            one_des = torch.zeros((F, 2, 2), dtype=torch.int32, device=dev)
            one = lk.pyramidal_lk_compact(p0.instance(b), p1.instance(b), pts[b], pts[b] + 1.0,
                                          valid[b], des=one_des, **kw)
            assert torch.equal(des[b], one_des)
        else:
            one = lk.pyramidal_lk(p0.instance(b), p1.instance(b), pts[b], pts[b] + 1.0,
                                  valid[b], **kw)
        assert torch.equal(got[0][b], one[0]) and torch.equal(got[1][b], one[1])
    pn, ps = lk.pyramidal_lk_plain(p0, p1, pts, pts + 1.0, valid, compact_windows=compact, **kw)
    agree = float((got[1] == ps).float().mean())
    both = got[1] & ps
    assert agree >= 0.99 and int(both.sum()) > B * F // 2
    assert float((got[0][both] - pn[both]).abs().max()) <= 1e-3


@pytest.fixture(scope="module")
def fleet_states():
    """Three host filter states of the oracle scenario (35, 38 and 41
    frames: their windows and maps differ) stacked on the card."""
    from uav_airvision_tpu_torch.utils import tree

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    runs = [_host_state("float32", n) for n in (35, 38, 41)]
    cfg, _, params = runs[0]
    state = tree.stack([convert.to_torch(convert.to_numpy(st), dev) for _, st, _ in runs])
    return cfg, state, convert.to_torch(convert.to_numpy(params), dev)


BACKEND_BATCHED = ["K14", "K13", "K9 lost", "K9 prune", "K10 small", "K10 tiered"]


@pytest.mark.parametrize("kernel", BACKEND_BATCHED)
def test_backend_kernel_batched(dev, fleet_states, kernel):
    """K14, K13 (row entry), K9 (row entry, the lost pass's and the
    prune's blocks) and K10 (5-row and 77-row blocks) over three instances
    in one launch: each instance bit for bit its single launch, and within
    the kernel's bars of the batched plain version (K14 1e-5 relative, K13
    1e-3 of max(|p|, 1) and the same flags, K9 3e-5 / 1e-4 of a block's
    largest entry and the same rows, K10 the same decisions away from the
    threshold)."""
    from uav_airvision_tpu_torch.utils import tree

    cfg, st, params = fleet_states
    S = st.cov.shape[0]
    t, c = st.features, st.cams
    sel = gridops.smallest_k_indices(torch.where(t.valid, t.seq, 2 ** 31 - 1), 32).long()
    ok = (t.valid & (t.obs_mask.sum(2) >= 3)).gather(1, sel)
    if kernel == "K14":
        I = cfg.capacity.max_imu_per_frame
        rng = np.random.default_rng(3)
        live = torch.arange(I, device=dev)[None] < torch.tensor([[11], [7], [12]], device=dev)
        imu_t = torch.where(live, st.imu.timestamp[:, None] + 0.005 * torch.arange(
            1, I + 1, device=dev), 0.0)
        w = torch.as_tensor(rng.normal(0, 0.3, (S, I, 3)), dtype=torch.float32, device=dev)
        a = torch.as_tensor(rng.normal([0, 0, 9.81], 0.5, (S, I, 3)), dtype=torch.float32,
                            device=dev)
        args = (st, params, imu_t, w, a, live)
        n = propagation.propagate.launches
        got = propagation.propagate(*args)
        assert propagation.propagate.launches == n + 1
        want = propagation.propagate_plain(*args)
        assert _rel_err(got.cov, want.cov) <= 1e-5 and _rel_err(got.imu.p, want.imu.p) <= 1e-5
        for b in range(S):
            one = propagation.propagate(tree.index(st, b), params, imu_t[b], w[b], a[b], live[b])
            g = tree.index(got, b)
            assert all(torch.equal(x, y) for x, y in zip((g.cov, *g.imu), (one.cov, *one.imu)))
        return
    if kernel == "K13":
        args = (c.q, c.p, t.obs, t.obs_mask, t.position, torch.zeros_like(t.initialized), sel,
                ok, params.R_cam0_cam1, params.t_cam0_cam1, cfg.triangulation)
        got = triangulation.triangulate_rows(*args)
        want = triangulation.triangulate_rows_plain(*args)
        assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
        new = got[1]
        assert bool(new.any())
        rel = (got[0] - want[0]).abs().amax(-1) / want[0].abs().amax(-1).clamp(min=1.0)
        assert float(rel[new].max()) <= 1e-3
        for b in range(S):
            one = triangulation.triangulate_rows(*(x[b] for x in args[:8]), *args[8:])
            assert all(torch.equal(g[b], o) for g, o in zip(got, one))
        return
    rm = torch.stack([c.count - 2, c.count - 1], 1).long() if kernel == "K9 prune" else None
    fargs = (c.q, c.p, c.q_null, c.p_null, t.obs, t.obs_mask, t.position, sel, ok, st.gravity,
             params.R_cam0_cam1, params.t_cam0_cam1, cfg.capacity.state_dim)
    H, r, rows = update.feature_block_rows(*fargs, rm=rm)
    if kernel.startswith("K9"):
        pH, pr, prows = update.feature_block_rows_plain(*fargs, rm=rm)
        scale = torch.maximum(pH.abs().amax((-2, -1)), pr.abs().amax(-1)).clamp(min=1e-30)
        err = max(float(((H - pH).abs().amax((-2, -1)) / scale).max()),
                  float(((r - pr).abs().amax(-1) / scale).max()))
        assert torch.equal(rows, prows) and err <= (1e-4 if rm is not None else 3e-5)
        for b in range(S):
            one = update.feature_block_rows(*(x[b] for x in fargs[:10]), *fargs[10:],
                                            rm=rm[b] if rm is not None else None)
            assert all(torch.equal(g[b], o) for g, o in zip((H, r, rows), one))
        return
    if kernel == "K10 small":
        H, r, rows = H[:, :, :5], r[:, :, :5], rows.clamp(max=5)
        dof = torch.full(rows.shape, 2, device=dev)
    else:
        dof = (rows + 3) // 4 - 1
    r = r * torch.tensor([1e-3, 1.0, 30.0], device=dev)[:, None, None]
    args = (H, r, rows, st.cov, params.obs_noise, params.chi2_table, dof)
    n = update.gating_test_batch.launches
    got = update.gating_test_batch(*args)
    assert update.gating_test_batch.launches == n + 1
    want = update.gating_test_batch_plain(*args)
    thresh = params.chi2_table[dof.clamp(0, 99)]
    gamma = update.gate_gamma_plain(H, r, st.cov, params.obs_noise)
    assert bool(((got == want) | ((gamma - thresh).abs() <= 1e-4 * thresh)).all())
    for b in range(S):
        one = update.gating_test_batch(H[b], r[b], rows[b], st.cov[b], params.obs_noise,
                                       params.chi2_table, dof[b])
        assert torch.equal(got[b], one)


@pytest.mark.parametrize("n", [64, 256, 1500])
def test_k8_kernels_batched(dev, n):
    """K8's smallest-k and stable compaction over four instances in one
    launch: each instance its single launch and the plain version, exactly."""
    rng = np.random.default_rng(n)
    key = torch.as_tensor(rng.integers(0, 40, (4, n)), dtype=torch.int32, device=dev)
    mask = torch.as_tensor(rng.uniform(size=(4, n)) < 0.4, device=dev)
    for k in (16, 64):
        got = gridops.smallest_k_indices(key, k)
        assert torch.equal(got, gridops.smallest_k_indices_plain(key, k))
        for b in range(4):
            assert torch.equal(got[b], gridops.smallest_k_indices(key[b], k))
    got = gridops.stable_compact_indices(mask, n)
    assert torch.equal(got, gridops.stable_compact_indices_plain(mask, n))
    for b in range(4):
        assert torch.equal(got[b], gridops.stable_compact_indices(mask[b], n))


def _kernel_launches(fn, name):
    """(result, launches of the csrc kernels whose name holds ``name`` the
    call made), by torch.profiler's device events."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        out = fn()
        torch.cuda.synchronize()
    return out, sum(e.count for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA and name in e.key)


def _to_dtype(tree_, dtype):
    from uav_airvision_tpu_torch.utils import tree

    return tree.map_leaves(lambda x: x.to(dtype) if x.is_floating_point() else x, tree_)


# K11 in one launch: the instances' true rows (None: every row of a buffer
# no taller than T2) and whether each updates
EKF_BATCHED = {"T1": ([26, 60, 144], [True] * 3), "mixed tiers": ([26, 250, 700], [True] * 3),
               "mixed, one idle": ([700, 60, 250], [True, False, True]), "B1": ([250], [True])}


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("case", sorted(EKF_BATCHED))
def test_ekf_update_kernel_batched(dev, fleet_states, dtype, case):
    """K11 over a fleet's updating instances in ONE launch of its kernel
    (torch.profiler; an idle instance's state is merged back by selects),
    T1, T2 and QR instances side by side: each instance bit for bit its
    single launch (``apply_update``); the instance that does not update
    keeps its state; against the batched plain version in float64 within
    test_apply_update_fused_matches_plain's 1e-12 of each field's largest
    entry, in float32 the covariance within test_ekf_update_kernel_matches_
    plain's bar of the float64 plain version."""
    from uav_airvision_tpu_torch.utils import tree

    cfg, st, params = fleet_states
    rows, upd = EKF_BATCHED[case]
    S = len(rows)
    st = _to_dtype(tree.map_leaves(lambda x: x[:S], st), getattr(torch, dtype))
    params = _to_dtype(params, getattr(torch, dtype))
    D = st.cov.shape[-1]
    rng = np.random.default_rng(S + sum(rows))
    H = torch.zeros((S, 1680, D), dtype=st.cov.dtype, device=dev)
    r = torch.zeros((S, 1680), dtype=st.cov.dtype, device=dev)
    for b, m in enumerate(rows):
        H[b, :m, 21:] = torch.as_tensor(rng.normal(0, 0.05, (m, D - 21)), device=dev)
        r[b, :m] = torch.as_tensor(rng.normal(0, 0.01, m), device=dev)
    mask = torch.tensor(upd, device=dev)
    n0 = update.apply_update.launches
    (got, warn), n_launch = _kernel_launches(
        lambda: update.apply_update_fleet(st, params, H, r, rows, upd, mask), "update_kernel")
    assert n_launch == 1 and update.apply_update.launches == n0 + 1
    if all(upd):  # nothing to merge: the kernel is the call's only launch
        assert _launches(lambda: update.apply_update_fleet(st, params, H, r, rows, upd,
                                                           mask))[1] == 1
    for b in range(S):
        g = tree.index(got, b)
        if not upd[b]:
            assert all(torch.equal(x, y) for x, y in zip(_fields(g).values(),
                                                          _fields(tree.index(st, b)).values()))
            assert not bool(warn[b])
            continue
        one, owarn = update.apply_update(tree.index(st, b), params, H[b], r[b], rows[b])
        for name, x in _fields(g).items():
            assert torch.equal(x, _fields(one)[name]), f"instance {b}: {name}"
        assert bool(warn[b]) == bool(owarn)
    f64 = torch.float64
    want, _ = update.apply_update_fleet_plain(_to_dtype(st, f64), _to_dtype(params, f64),
                                              H.double(), r.double(), rows, upd, mask)
    for b in (b for b in range(S) if upd[b]):
        g, w = _fields(tree.index(got, b)), _fields(tree.index(want, b))
        if dtype == "float64":
            for name in g:
                assert float((g[name] - w[name]).abs().max()) <= 1e-12 * float(
                    w[name].abs().max()), f"instance {b}: {name}"
        else:
            p32 = update.apply_update_plain(tree.index(st, b), params, H[b], r[b], rows[b])[0]
            e32 = float((p32.cov.double() - w["cov"]).abs().max())
            sc = max(float(w["cov"].abs().max()), 1.0)
            assert float((g["cov"].double() - w["cov"]).abs().max()) <= max(1e-5 * sc, 4 * e32)
        assert torch.equal(g["cov"], g["cov"].T)


# K12 in one launch: each instance's feature count (its tier) and whether it
# prunes
RANK12_BATCHED = {"mixed n_feat": ([32, 128, 64], [True] * 3),
                  "mixed, one idle": ([128, 32, 32], [True, False, True]), "B1": ([64], [True])}


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("case", sorted(RANK12_BATCHED))
def test_rank12_kernel_batched(dev, fleet_states, dtype, case):
    """K12 over a fleet's pruning instances in ONE launch of its kernel
    (torch.profiler), instances with 32 and 128 features (their own cluster
    splits of the sums) side by side, each with its own two cameras: each
    instance bit for bit its single
    launch (``apply_update_rank12_rows`` on its own features); the idle
    instance keeps its state; against the batched plain version within
    test_rank12_rows_kernel_matches_plain's 1e-4 (float32) / 1e-10 (float64)
    of max(|P|, 1)."""
    from uav_airvision_tpu_torch.utils import tree

    cfg, st, params = fleet_states
    n_feats, upd = RANK12_BATCHED[case]
    S, K = len(n_feats), max(n_feats)
    st = _to_dtype(tree.map_leaves(lambda x: x[:S], st), getattr(torch, dtype))
    params = _to_dtype(params, getattr(torch, dtype))
    blocks = [_prune_blocks(tree.index(st, b), K, 7 * b + K) for b in range(S)]
    H12, r_blk, include = (torch.stack(x) for x in zip(*blocks))
    cols = torch.stack([torch.cat([21 + 6 * a + torch.arange(6, device=dev),
                                   21 + 6 * c + torch.arange(6, device=dev)])
                        for a, c in ((4, 9), (2, 3), (10, 15))[:S]])
    mask = torch.tensor(upd, device=dev)
    args = (st, params, H12, r_blk, include, cols, upd, mask, n_feats)
    n0 = update.apply_update_rank12_rows.launches
    (got, warn), n_launch = _kernel_launches(
        lambda: update.apply_update_rank12_rows_fleet(*args), "rank12_kernel")
    assert n_launch == 1 and update.apply_update_rank12_rows.launches == n0 + 1
    if all(upd):  # nothing to merge: the kernel is the call's only launch
        assert _launches(lambda: update.apply_update_rank12_rows_fleet(*args))[1] == 1
    want, pwarn = update.apply_update_rank12_rows_fleet_plain(*args)
    tol = 1e-4 if dtype == "float32" else 1e-10
    for b in range(S):
        g = tree.index(got, b)
        if not upd[b]:
            assert all(torch.equal(x, y) for x, y in zip(_fields(g).values(),
                                                          _fields(tree.index(st, b)).values()))
            continue
        k = n_feats[b]
        one, owarn = update.apply_update_rank12_rows(tree.index(st, b), params, H12[b, :k],
                                                     r_blk[b, :k], include[b, :k], cols[b])
        w = _fields(tree.index(want, b))
        scale = max(float(w["cov"].abs().max()), 1.0)
        for name, x in _fields(g).items():
            assert torch.equal(x, _fields(one)[name]), f"instance {b}: {name}"
            assert float((x - w[name]).abs().max()) <= tol * scale, f"instance {b}: {name}"
        assert bool(warn[b]) == bool(owarn) == bool(pwarn[b])
        assert torch.equal(g.cov, g.cov.T)


@pytest.mark.parametrize("B", [1, 4])
def test_predict_warp_kernel_batched(dev, B):
    """K7's prediction over B instances in one launch, their points strided
    views of one buffer (as K8's selection leaves them): the rotations
    within 4 float32 ulps of 1.0 and the points within 4 ulps at 752 px of
    the batched plain version (test_predict_warp_kernel_matches_plain's
    bars), each instance bit for bit its single launch; a zero rate gives
    the identity."""
    from uav_airvision_tpu_torch.models.frontend.params import make_frontend_params

    p = make_frontend_params(euroc_config(), dev)
    rng = np.random.default_rng(B)
    buf = torch.zeros((B, 300), dtype=torch.float32, device=dev)
    buf[:, :208] = torch.as_tensor(rng.uniform([5, 5], [747, 475], (B, 104, 2)).reshape(B, 208),
                                   dtype=torch.float32, device=dev)
    pts = buf[:, :208].unflatten(-1, (104, 2))
    wv = torch.as_tensor(rng.normal(0, 1.0, (B, 3)), dtype=torch.float32, device=dev)
    wv[0] = 0.0
    dt = torch.as_tensor(rng.uniform(0.04, 0.06, B), dtype=torch.float32, device=dev)
    n0 = camera.predict_warp_points.launches
    got, R = camera.predict_warp_points(pts, wv, dt, p.R_cam0_imu, p.cam0_intrinsics)
    assert camera.predict_warp_points.launches == n0 + 1
    assert got.shape == (B, 104, 2) and R.shape == (B, 3, 3)
    want, pR = camera.predict_warp_points_plain(pts, wv, dt, p.R_cam0_imu, p.cam0_intrinsics)
    assert float((R - pR).abs().max()) <= 4 * 2.0 ** -23
    assert float((got - want).abs().max()) <= 4 * 2.0 ** -14
    assert torch.equal(R[0], torch.eye(3, device=dev))
    for b in range(B):
        one, oR = camera.predict_warp_points(pts[b], wv[b], dt[b], p.R_cam0_imu,
                                             p.cam0_intrinsics)
        assert torch.equal(got[b], one) and torch.equal(R[b], oR)


@pytest.mark.parametrize("workspace", [False, True])
@pytest.mark.parametrize("B", [1, 4])
def test_select_track_kernel_batched(dev, B, workspace, monkeypatch):
    """K8's selection over B instances (one of each input case, inputs read
    at instance strides from views of larger buffers) in one launch, and
    the first frame's ranking, kept-order statistics and compaction of 160
    candidates each over B instances: every output equal to the batched
    plain version and, instance by instance, to its single launch, bit for
    bit; also with the selection's working arrays in the device
    workspace."""
    if workspace:
        monkeypatch.setattr(kernels, "SMEM_PER_BLOCK", 0)
    ins = [select_inputs(40 + b, 104, 100, CASES[b % len(CASES)]) for b in range(B)]
    statics = ins[0][1]
    arrays = []
    for k in range(11):  # each operand a view of a wider buffer: instance strides
        x = torch.stack([torch.as_tensor(a[k]) for a, _ in ins]).to(dev)
        wide = torch.zeros((B, x[0].numel() + 16), dtype=x.dtype, device=dev)
        wide[:, :x[0].numel()] = x.reshape(B, -1)
        arrays.append(wide[:, :x[0].numel()].view(x.shape))
    n0 = gridops.select_track.launches
    got = gridops.select_track(*arrays, *statics)
    assert gridops.select_track.launches == n0 + 1
    want = gridops.select_track_plain(*arrays, *statics)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape and torch.equal(g, w)
    for b in range(B):
        one = gridops.select_track(*(x[b] for x in arrays), *statics)
        assert all(torch.equal(g[b], o) for g, o in zip(got, one)), f"instance {b}"
    rng = np.random.default_rng(B)
    n = 160
    cell = torch.as_tensor(rng.integers(0, 20, (B, n)), dtype=torch.int32, device=dev)
    pri = torch.as_tensor(rng.integers(0, 3, (B, n)), dtype=torch.float32, device=dev)
    arr = torch.as_tensor(rng.integers(0, 6, (B, n)), dtype=torch.int32, device=dev)
    valid = torch.as_tensor(rng.uniform(size=(B, n)) < 0.7, device=dev)
    counts = [fn.launches for fn in gridops.K8_WRAPPERS[:3]]
    rank, perm = gridops.rank_in_cell(cell, pri, arr, valid, 20)
    keep = valid & (rank < 3)
    stats = gridops.kept_order_stats(perm, keep, cell, valid, 20)
    comp = gridops.compact_kept(perm, keep, 104)
    assert [fn.launches for fn in gridops.K8_WRAPPERS[:3]] == [c + 1 for c in counts]
    for g, w in ((rank, perm), gridops.rank_in_cell_plain(cell, pri, arr, valid, 20)), \
            (stats, gridops.kept_order_stats_plain(perm, keep, cell, valid, 20)), \
            (comp, gridops.compact_kept_plain(perm, keep, 104)):
        assert all(x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(g, w))
    for b in range(B):
        r1 = gridops.rank_in_cell(cell[b], pri[b], arr[b], valid[b], 20)
        s1 = gridops.kept_order_stats(perm[b], keep[b], cell[b], valid[b], 20)
        c1 = gridops.compact_kept(perm[b], keep[b], 104)
        for g, o in (((rank, perm), r1), (stats, s1), (comp, c1)):
            assert all(torch.equal(x[b], y) for x, y in zip(g, o)), f"instance {b}"
