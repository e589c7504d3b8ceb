"""The PyTorch port's tools around the command line, on the CPU: checkpoint
and resume (``utils/checkpoint.py``, ``run_sequence_checkpointed``), the
stage timer and trace (``utils/profiling.py``, ``--profile``), the headless
viewer (``--view``) and the plots, against the JAX package where it has the
same function.

Checkpointing runs a narrow configuration (94x60 images, 32 feature slots),
as tests/test_streaming.py does for the JAX package; the command-line flags
run a 0.1 s simulated sequence at full width.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from uav_airvision_tpu import config as jconfig
from uav_airvision_tpu.models import vio as jvio
from uav_airvision_tpu.utils import profiling as jprofiling
from uav_airvision_tpu_torch import config as tconfig
from uav_airvision_tpu_torch import convert
from uav_airvision_tpu_torch import main as tmain
from uav_airvision_tpu_torch.evaluation import plots
from uav_airvision_tpu_torch.models import vio as tvio
from uav_airvision_tpu_torch.ops.pyramid import Pyramid
from uav_airvision_tpu_torch.utils import checkpoint as ckpt
from uav_airvision_tpu_torch.utils import profiling
from uav_airvision_tpu_torch.viewer import SimpleViewer
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

CPU = torch.device("cpu")
N_FRAMES = 12


def narrow_config():
    """__graft_entry__._tiny_config on the port's config: the camera
    scaled to 94x60 and the capacities cut."""
    cfg = tconfig.euroc_config()
    sx, sy = 94.0 / 752.0, 60.0 / 480.0
    c = cfg.calib
    scale = [(fx * sx, fy * sy, cx * sx, cy * sy)
             for fx, fy, cx, cy in (c.cam0_intrinsics, c.cam1_intrinsics)]
    calib = dataclasses.replace(c, cam0_intrinsics=scale[0], cam1_intrinsics=scale[1],
                                cam0_resolution=(94, 60), cam1_resolution=(94, 60))
    cap = dataclasses.replace(cfg.capacity, max_features=32, max_map_features=64,
                              max_lost_per_frame=16, max_update_rows=256,
                              max_prune_rows=256, max_imu_per_frame=16)
    return dataclasses.replace(cfg, calib=calib, capacity=cap)


def narrow_frames(cfg, n=N_FRAMES):
    """Seeded random images and IMU samples on a monotone 20 Hz clock."""
    rng = np.random.default_rng(0)
    w, h = cfg.calib.cam0_resolution
    I = cfg.capacity.max_imu_per_frame
    ts = np.arange(1, n + 1) * 0.05
    f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32))  # noqa: E731
    return tvio.VioFrame(
        timestamp=f32(ts),
        cam0=torch.as_tensor(rng.integers(0, 255, (n, h, w), dtype=np.uint8)),
        cam1=torch.as_tensor(rng.integers(0, 255, (n, h, w), dtype=np.uint8)),
        imu_t=f32(np.linspace(0.005, 0.05, I)[None] + ts[:, None] - 0.05),
        imu_w=f32(rng.normal(0, 0.01, (n, I, 3))),
        imu_a=f32(rng.normal(0, 0.01, (n, I, 3)) + np.array([0, 0, 9.81])),
        imu_mask=torch.ones((n, I), dtype=torch.bool),
        fe_mean_w=f32(np.zeros((n, 3))),
        fe_dt=f32(np.full(n, 0.05)),
        active=torch.ones(n, dtype=torch.bool))


GYRO_BIAS = np.zeros(3)
ACC_MEAN = np.array([0.05, 0.02, 9.8])


def _leaves(tree, prefix=""):
    """(dotted path, tensor) of every tensor of a state tree, a pyramid's
    flat buffer and sizes included."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for name in tree._fields:
            yield from _leaves(getattr(tree, name), f"{prefix}{name}.")
    elif isinstance(tree, Pyramid):
        yield f"{prefix}flat", tree.flat
        yield f"{prefix}sizes", torch.tensor([tree.H0, tree.W0, tree.n_levels, tree.pad])
    elif tree is not None:
        yield prefix[:-1], tree


def _assert_same_state(got, want):
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert got.keys() == want.keys()
    for key, w in want.items():
        g = got[key]
        assert g.dtype == w.dtype and g.shape == w.shape, key
        assert torch.equal(g, w), key


@pytest.fixture(scope="module")
def narrow_run():
    cfg = narrow_config()
    frames = narrow_frames(cfg)
    state, outs = tvio.run_sequence(cfg, frames, GYRO_BIAS, ACC_MEAN)
    return cfg, frames, state, outs


def test_checkpoint_roundtrip(narrow_run, tmp_path):
    """A state after 12 frames (the previous pyramid included) saves and
    restores into an initial state's structure leaf for leaf; the latest
    step is found; a template of another configuration is refused."""
    cfg, _, state, _ = narrow_run
    assert state.frontend.prev_pyr is not None
    template = tvio.init_vio_state(cfg, GYRO_BIAS, ACC_MEAN, device="cpu")
    assert ckpt.latest_step(tmp_path / "none") is None
    with pytest.raises(FileNotFoundError):
        ckpt.restore_state(tmp_path / "none", template)
    ckpt.save_state(tmp_path, template, 3)
    ckpt.save_state(tmp_path, state, 12)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_00000003", "step_00000012"]
    assert ckpt.latest_step(tmp_path) == 12
    got, step = ckpt.restore_state(tmp_path, template)
    assert step == 12
    _assert_same_state(got, state)
    got, step = ckpt.restore_state(tmp_path, template, step=3)
    assert step == 3 and got.frontend.prev_pyr is None
    _assert_same_state(got, template)
    wider = dataclasses.replace(cfg, capacity=dataclasses.replace(cfg.capacity,
                                                                  max_features=64))
    with pytest.raises(ValueError, match="frontend.ids"):
        ckpt.restore_state(tmp_path, tvio.init_vio_state(wider, device="cpu"))
    with pytest.raises(ValueError, match="no pyramid"):
        ckpt.restore_state(tmp_path, state, step=3)
    small = state._replace(frontend=state.frontend._replace(
        prev_pyr=Pyramid(torch.zeros(16), 2, 2, 1, 1)))
    with pytest.raises(ValueError, match="does not match"):
        ckpt.restore_state(tmp_path, small)


def test_checkpoint_roundtrip_of_jax_state(tmp_path):
    """The JAX package's initial state, turned into the port's by
    ``convert``, roundtrips bit for bit."""
    cfg = jconfig.euroc_config()
    js = jvio.init_vio_state(cfg, np.array([1e-3, -2e-3, 5e-4]), np.array([0.1, -0.2, 9.8]))
    state = tvio.VioState(
        frontend=convert.frontend_state_to_torch(js.frontend, None, tconfig.euroc_config(), CPU),
        filter=convert.to_torch(js.filter, CPU))
    ckpt.save_state(tmp_path, state, 1)
    template = tvio.init_vio_state(tconfig.euroc_config(), device="cpu")
    got, _ = ckpt.restore_state(tmp_path, template)
    _assert_same_state(got, state)
    jleaves = jax.tree_util.tree_leaves(js.filter)
    tleaves = [t for _, t in _leaves(got.filter)]
    assert len(jleaves) == len(tleaves)
    for j, t in zip(jleaves, tleaves):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_run_sequence_checkpointed_resumes_bit_identical(narrow_run, tmp_path):
    """tests/test_streaming.py's kill-and-resume check on the port: a run fed
    the first 8 frames, snapshotting every 4, then resumed over all 12,
    skips the first 8 and continues with the uninterrupted run's bits."""
    cfg, frames, ref_state, ref = narrow_run
    ckdir = str(tmp_path / "ck")
    part = tvio.VioFrame(*(x[:8] for x in frames))
    _, outs1, start1 = tvio.run_sequence_checkpointed(cfg, part, GYRO_BIAS, ACC_MEAN, ckdir,
                                                      every=4)
    assert start1 == 0 and ckpt.latest_step(ckdir) == 8
    state2, outs2, start = tvio.run_sequence_checkpointed(cfg, frames, GYRO_BIAS, ACC_MEAN,
                                                          ckdir, every=4)
    assert start == 8
    for name in ("p", "q", "v", "timestamp", "active"):
        assert torch.equal(getattr(outs1, name), getattr(ref, name)[:8]), name
        assert torch.equal(getattr(outs2, name), getattr(ref, name)[8:]), name
    _assert_same_state(state2, ref_state)
    # everything checkpointed: nothing left to run
    _, outs3, start3 = tvio.run_sequence_checkpointed(cfg, frames, GYRO_BIAS, ACC_MEAN, ckdir,
                                                      every=4)
    assert outs3 is None and start3 == N_FRAMES


def test_stage_timer_matches_jax():
    """StageTimer is the JAX package's: the same report for the same stages."""
    reports = []
    for mod in (profiling, jprofiling):
        timer = mod.StageTimer()
        for name in ("load", "run", "run"):
            with timer.stage(name):
                pass
        reports.append(json.loads(timer.dump()))
    assert reports[0].keys() == reports[1].keys() == {"load", "run"}
    for name in ("load", "run"):
        assert reports[0][name].keys() == reports[1][name].keys()
        assert reports[0][name]["count"] == reports[1][name]["count"]


def test_cli_profile_view_and_checkpoint(tmp_path, monkeypatch, capsys):
    """``--profile`` writes the stage timings (the JAX keys) and a Chrome
    trace holding the port's stage spans under reports/, ``--view`` replays headless, and a second run with
    the same ``--checkpoint-dir`` resumes after the last frame."""
    monkeypatch.chdir(tmp_path)
    args = ["--synthetic", "0.1", "--device", "cpu", "--checkpoint-dir", "ck",
            "--checkpoint-every", "1"]
    run = tmain.main(args + ["--profile", "--view"])
    out = capsys.readouterr().out
    stages = json.loads((tmp_path / "reports" / "profile_stages.json").read_text())
    assert stages.keys() == {"load", "run"}
    assert stages["run"].keys() == {"total_s", "count", "mean_ms"}
    trace = (tmp_path / "reports" / "torch_trace" / profiling.TRACE_FILE).read_bytes()
    assert trace.lstrip().startswith(b"{") and b'"traceEvents"' in trace and b'"aten::' in trace
    # the port's stage spans (the recorder is on for --profile's run)
    assert b'"fe.pyramid"' in trace and b'"be.subset"' in trace
    assert "[viewer] headless" in out
    assert run.start_frame == 0 and len(run.outputs.p) == 2
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == [
        "step_00000001", "step_00000002"]
    again = tmain.main(args)
    assert again.start_frame == 2 and again.outputs is None
    assert "[resume] from checkpointed frame 2" in capsys.readouterr().out


def test_viewer_headless():
    """Without PyQt5 the viewer takes images, poses and points and replays
    nothing, as the JAX package's does."""
    v = SimpleViewer()
    v.update_image(np.zeros((4, 4), np.uint8))
    v.update_pose(type("Pose", (), {"R": np.eye(3), "t": np.zeros(3)})())
    v.update_points(np.zeros((2, 3)))
    v.replay(np.arange(3.0), np.zeros((3, 3)))
    assert v.pose_queue.qsize() == 1 and v.image_queue.qsize() == 1


def test_plots_write_pngs(tmp_path):
    """Every plot function writes its PNG (matplotlib, Agg)."""
    pytest.importorskip("matplotlib")
    t = np.arange(0, 4, 0.05)
    p_gt = np.stack([np.sin(t), np.cos(t), 0.1 * t], 1)
    p_est = p_gt + np.random.default_rng(0).normal(0, 0.01, p_gt.shape)
    pg, err = plots.per_sequence_artifacts(str(tmp_path / "seq"), t, p_est, t, p_gt)
    assert len(err) == len(t) and np.all(err < 0.1)
    for png in ("trajectories.png", "ate_vs_path.png", "rte_vs_path.png"):
        assert (tmp_path / "seq" / png).stat().st_size > 0
    path = plots.plot_summary(str(tmp_path / "ate_summary.png"), ["a", "b"], [1.0, 2.0])
    assert (tmp_path / "ate_summary.png").stat().st_size > 0 and path.endswith(".png")
