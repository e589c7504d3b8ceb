"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: every test skips without a CUDA device.  On a machine with
one (no JAX needed):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Small shapes; chip_smoke.py repeats these checks at the main path's shapes.
"""

import numpy as np
import pytest
import torch

from uav_airvision_tpu.config import euroc_config
from uav_airvision_tpu_torch.models.msckf import propagation
from uav_airvision_tpu_torch.models.msckf.state import init_state, make_params
from uav_airvision_tpu_torch.ops import fast, lk, pyramid

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
