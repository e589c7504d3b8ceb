"""The PyTorch port stands alone: it imports nothing of JAX or of the JAX
package, its own copies of the JAX-free modules (config, simulated world,
IMU prebatching, trajectory writer, metrics) behave as the JAX package's
do, its entry points default to the card, and each kernel wrapper runs its
plain version, bit for bit, on CPU tensors.
"""

import ast
import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from uav_airvision_tpu import config as jconfig
from uav_airvision_tpu.evaluation import metrics as jmetrics
from uav_airvision_tpu.simulation.world import StereoWorld as JStereoWorld
from uav_airvision_tpu.streaming.prebatch import prebatch_imu as j_prebatch_imu
from uav_airvision_tpu.utils import trajectory as jtrajectory
from uav_airvision_tpu_torch import config as tconfig
from uav_airvision_tpu_torch import device, kernels
from uav_airvision_tpu_torch.evaluation import metrics as tmetrics
from uav_airvision_tpu_torch.models import vio
from uav_airvision_tpu_torch.models.msckf import triangulation as ttri
from uav_airvision_tpu_torch.models.msckf import update as tupd
from uav_airvision_tpu_torch.simulation.world import StereoWorld as TStereoWorld
from uav_airvision_tpu_torch.streaming.prebatch import prebatch_imu as t_prebatch_imu
from uav_airvision_tpu_torch.utils import trajectory as ttrajectory

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted((ROOT / "uav_airvision_tpu_torch").rglob("*.py"))
                         + [ROOT / "chip_smoke.py"], ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax(path):
    """No module of the port, and not chip_smoke.py, imports jax or the JAX
    package (uav_airvision_tpu), not even a JAX-free module of it."""
    for name in _imported_modules(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "uav_airvision_tpu"), f"{path.name} imports {name}"


@pytest.mark.parametrize("make", [lambda m: m.euroc_config(),
                                  lambda m: m.long_horizon_config(),
                                  lambda m: m.euroc_config(dtype="float64")],
                         ids=["euroc", "long_horizon", "euroc_f64"])
def test_config_copy_equals_jax(make):
    got, want = make(tconfig), make(jconfig)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.capacity.state_dim == want.capacity.state_dim
    assert tconfig.Config.from_json(want.to_json()) == got


def test_world_and_prebatch_copies_equal_jax():
    """The port's StereoWorld renders the same bytes from the same seed, and
    gives the same IMU stream, ground truth and prebatched frames."""
    tw, jw = TStereoWorld(tconfig.euroc_config()), JStereoWorld(jconfig.euroc_config())
    dur = 3 / 20.0
    t_imu, j_imu = tw.imu_stream(dur), jw.imu_stream(dur)
    for a, b in zip(t_imu, j_imu):
        np.testing.assert_array_equal(a, b)
    fts = tw.frame_times(dur)
    np.testing.assert_array_equal(fts, jw.frame_times(dur))
    np.testing.assert_array_equal(tw.groundtruth(fts), jw.groundtruth(fts))
    trng, jrng = np.random.default_rng(5), np.random.default_rng(5)
    for t in fts:
        for a, b in zip(tw.render_frame(t, trng), jw.render_frame(t, jrng)):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    cap = tconfig.euroc_config().capacity
    tpb = t_prebatch_imu(fts, *t_imu, cap.max_imu_per_frame, cap.imu_init_msgs)
    jpb = j_prebatch_imu(fts, *j_imu, cap.max_imu_per_frame, cap.imu_init_msgs)
    for field in dataclasses.fields(jpb):
        np.testing.assert_array_equal(np.asarray(getattr(tpb, field.name)),
                                      np.asarray(getattr(jpb, field.name)), err_msg=field.name)


def test_metrics_and_trajectory_copies_equal_jax(tmp_path):
    rng = np.random.default_rng(3)
    gt_t = np.arange(0.0, 5.0, 0.05)
    gt_p = np.cumsum(rng.normal(0, 0.02, (len(gt_t), 3)), 0)
    est_t = gt_t[::2] + 0.001
    est_p = gt_p[::2] + rng.normal(0, 0.01, (len(est_t), 3))
    for fn in ("ate", "rte"):
        assert getattr(tmetrics, fn)(est_t, est_p, gt_t, gt_p) == \
            getattr(jmetrics, fn)(est_t, est_p, gt_t, gt_p)
    q = rng.normal(0, 1, (len(est_t), 4))
    act = rng.uniform(size=len(est_t)) < 0.9
    paths = []
    for mod, name in ((ttrajectory, "port"), (jtrajectory, "jax")):
        w = mod.TrajectoryWriter(path=str(tmp_path / f"{name}.txt"))
        w.write_batch(est_t, est_p, q / np.linalg.norm(q, axis=1, keepdims=True), act)
        paths.append(Path(w.path))
    assert paths[0].read_bytes() == paths[1].read_bytes()


def test_entry_points_default_to_cuda(monkeypatch):
    """get_device() means the card; without CUDA it raises instead of falling
    back to the CPU, and so do init_vio_state and the CLI by default."""
    import inspect

    from uav_airvision_tpu_torch import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        device.get_device()
    assert device.get_device("cpu") == CPU
    with pytest.raises(RuntimeError, match="CUDA"):
        vio.init_vio_state(tconfig.euroc_config())
    assert vio.init_vio_state(tconfig.euroc_config(), device="cpu").filter.cov.device == CPU
    with pytest.raises(RuntimeError, match="CUDA"):
        main.main(["--synthetic", "0.1"])
    assert inspect.signature(device.get_device).parameters["name"].default == "cuda"


@pytest.fixture(scope="module")
def filter_state():
    """A float64 filter state of the oracle scenario after 41 frames (a
    19-camera window) from the port's own back-end and Config."""
    from test_torch_cuda import _host_state

    cfg, state, params = _host_state("float64")
    t = state.features
    sel = torch.nonzero(t.valid & (t.obs_mask.sum(1) >= 3))[:, 0][:16]
    assert len(sel) >= 4
    return cfg, state, params, sel


def _launch_counts():
    return (ttri.triangulate.launches, tupd.feature_block.launches, tupd.gate_bounds.launches,
            tupd.gate_gamma.launches, tupd.rank12_update.launches)


def _assert_identical(got, want):
    if isinstance(got, tuple):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_identical(g, w)
    else:
        assert got.dtype == want.dtype and got.shape == want.shape
        assert torch.equal(got, want) or bool((got.isnan() == want.isnan()).all()
                                              and torch.equal(got.nan_to_num(), want.nan_to_num()))


@pytest.mark.parametrize("kernel", ["K13", "K9", "K9_prune", "K10", "K12"])
def test_wrappers_run_plain_on_cpu(filter_state, kernel, monkeypatch):
    """On CPU tensors each kernel's public wrapper returns exactly what its
    plain version returns, counts no launch and reports no call to the
    kernels' observer."""
    observed = []
    monkeypatch.setattr(kernels, "observer", lambda name, args: observed.append(name))
    cfg, state, params, sel = filter_state
    c, t = state.cams, state.features
    n0 = _launch_counts()
    if kernel == "K13":
        active = torch.arange(len(sel)) % 5 != 1
        args = (c.q, c.p, t.obs[sel], t.obs_mask[sel], params.R_cam0_cam1, params.t_cam0_cam1,
                cfg.triangulation, active)
        _assert_identical(ttri.triangulate(*args), ttri.triangulate_plain(*args))
    elif kernel.startswith("K9"):
        rm = torch.tensor([3, 7]) if kernel == "K9_prune" else torch.arange(c.q.shape[0])
        args = (c.q[rm], c.p[rm], c.q_null[rm], c.p_null[rm], t.obs[sel][:, rm],
                t.obs_mask[sel][:, rm], t.position[sel], state.gravity, params.R_cam0_cam1,
                params.t_cam0_cam1, cfg.capacity.state_dim)
        _assert_identical(tupd.feature_block(*args), tupd.feature_block_plain(*args))
    elif kernel == "K10":
        H, r, rows = tupd.feature_block_plain(
            c.q, c.p, c.q_null, c.p_null, t.obs[sel], t.obs_mask[sel], t.position[sel],
            state.gravity, params.R_cam0_cam1, params.t_cam0_cam1, cfg.capacity.state_dim)
        dof = t.obs_mask[sel].sum(1).to(torch.int32) - 1
        thresh = params.chi2_table[dof.long()]
        for scale in (1e-3, 10.0, 1e3):
            gate = (H, r * scale, rows, state.cov, params.obs_noise, params.chi2_table, dof)
            _assert_identical(tupd.gating_test_batch(*gate), tupd.gating_test_batch_plain(*gate))
            _assert_identical(tupd.gate_bounds(H, r * scale, state.cov, params.obs_noise, thresh),
                              tupd.gate_bounds_plain(H, r * scale, state.cov, params.obs_noise,
                                                     thresh))
            for m in (32, H.shape[1]):
                args = (H[:, :m], r[:, :m] * scale, state.cov, params.obs_noise)
                _assert_identical(tupd.gate_gamma(*args), tupd.gate_gamma_plain(*args))
    else:
        rng = np.random.default_rng(12)
        cols = torch.cat([21 + 6 * 4 + torch.arange(6), 21 + 6 * 9 + torch.arange(6)])
        B = torch.as_tensor(rng.normal(0, 0.8, (60, 12)))
        r = torch.as_tensor(rng.normal(0, 0.02, 60))
        _assert_identical(tupd.rank12_update(state.cov, B, r, cols, params.obs_noise),
                          tupd.rank12_update_plain(state.cov, B, r, cols, params.obs_noise))
        got, warn = tupd.apply_update_rank12(state, params, B, r, cols)
        want, pwarn = tupd.apply_update_rank12_plain(state, params, B, r, cols)
        _assert_identical(tuple(torch.utils._pytree.tree_leaves(got)) + (warn,),
                          tuple(torch.utils._pytree.tree_leaves(want)) + (pwarn,))
    assert _launch_counts() == n0 and not observed


def test_wrappers_raise_on_other_devices(filter_state):
    """A tensor on neither the CPU nor a CUDA device is refused."""
    cfg, state, params, sel = filter_state
    meta = torch.device("meta")
    with pytest.raises(ValueError, match="K13"):
        ttri.triangulate(*(x.to(meta) for x in (state.cams.q, state.cams.p, state.features.obs,
                                                state.features.obs_mask, params.R_cam0_cam1,
                                                params.t_cam0_cam1)), cfg.triangulation)
    H = torch.zeros((2, 77, 141), device=meta)
    with pytest.raises(ValueError, match="K10"):
        tupd.gate_gamma(H, torch.zeros((2, 77), device=meta), state.cov.to(meta),
                        params.obs_noise.to(meta))

