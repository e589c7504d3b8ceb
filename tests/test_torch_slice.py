"""The PyTorch port's main path against the JAX package, end to end on the CPU.

Full-width 752x480 StereoWorld frames go through the port's ``run_sequence``
(frontend_step + backend_step) and through the JAX package's fused
``vio_step`` (jitted, the step ``uav_airvision_tpu.models.vio.run_sequence``
scans).  The config shrinks the window to 8 cameras and the IMU init to 40
messages, and the frames start where the trajectory starts to move, so that
within 16 frames the first frame, temporal tracking, the lost-feature update
and the rank-12 prune all run.  The streaming orchestrator (``vio.VIO``) is
fed the same frames and IMU messages and held to both.
"""

import dataclasses
from queue import Queue

import numpy as np
import jax
import pytest
import torch

from uav_airvision_tpu.config import euroc_config
from uav_airvision_tpu.models import vio as jvio
from uav_airvision_tpu.models.frontend.params import make_frontend_params as j_fparams
from uav_airvision_tpu.models.frontend.pipeline import frontend_step as j_frontend_step
from uav_airvision_tpu.models.msckf.state import make_params as j_mparams
from uav_airvision_tpu.simulation.world import StereoWorld
from uav_airvision_tpu.streaming.prebatch import prebatch_imu
from uav_airvision_tpu.utils.precision import with_highest_precision
from uav_airvision_tpu_torch import convert
from uav_airvision_tpu_torch.config import Config as TConfig
from uav_airvision_tpu_torch.models import vio as tvio
from uav_airvision_tpu_torch.models.frontend.params import make_frontend_params
from uav_airvision_tpu_torch.models.frontend.pipeline import frontend_step
from uav_airvision_tpu_torch.simulation.world import StereoWorld as TStereoWorld
from uav_airvision_tpu_torch.streaming.dataset import imu_msg, stereo_msg
from uav_airvision_tpu_torch.utils.trajectory import TrajectoryWriter
from uav_airvision_tpu_torch import vio as tstream
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

N_FRAMES = 16
K_CONVERT = 8  # the JAX front-end state after this frame is converted
T0 = 1.5  # the bench world's trajectory starts moving here


def slice_config():
    cfg = euroc_config()
    return dataclasses.replace(
        cfg,
        capacity=dataclasses.replace(cfg.capacity, max_cam_states=8, imu_init_msgs=40),
        filter=dataclasses.replace(cfg.filter, max_cam_state_size=8))


def render(cfg, n_frames, t0=T0, seed=5):
    """Frames from ``t0`` on; the IMU stream from 0, so gravity initializes
    on the static start and every frame is active."""
    world = StereoWorld(cfg)
    dur = n_frames / 20.0
    imu_t, imu_w, imu_a = world.imu_stream(t0 + dur + 0.1)
    fts = t0 + world.frame_times(dur)
    rng = np.random.default_rng(seed)
    cam0, cam1 = zip(*(world.render_frame(t, rng) for t in fts))
    pb = prebatch_imu(fts, imu_t, imu_w, imu_a, cfg.capacity.max_imu_per_frame,
                      cfg.capacity.imu_init_msgs)
    return pb, np.stack(cam0), np.stack(cam1)


def run_jax(cfg, pb, cam0, cam1, keep_state_at=K_CONVERT):
    """JAX fused step per frame; returns per-frame (StepOutput, FrontendOutput)
    as numpy, and the JAX front-end state after frame ``keep_state_at``."""
    fparams, mparams = j_fparams(cfg), j_mparams(cfg)
    state = jvio.init_vio_state(cfg, pb.gyro_bias, pb.acc_mean, mparams)

    def step(st, fr):
        new_st, out = jvio.vio_step(st, fr, fparams, mparams, cfg)
        # the front-end output of the same step (XLA shares the subgraph)
        _, fe_out = j_frontend_step(st.frontend, fr.cam0, fr.cam1, fr.fe_mean_w, fr.fe_dt,
                                    fparams, cfg)
        return new_st, out, fe_out

    step = with_highest_precision(jax.jit(step))
    f32 = np.float32
    res = []
    for k in range(len(pb.timestamps)):
        fr = jvio.VioFrame(
            timestamp=f32(pb.timestamps[k]), cam0=cam0[k], cam1=cam1[k],
            imu_t=pb.imu_t[k].astype(f32), imu_w=pb.imu_w[k].astype(f32),
            imu_a=pb.imu_a[k].astype(f32), imu_mask=pb.imu_mask[k],
            fe_mean_w=pb.fe_mean_w[k].astype(f32), fe_dt=f32(pb.fe_dt[k]),
            active=np.bool_(pb.active[k]))
        state, out, fe_out = step(state, fr)
        res.append(jax.tree.map(np.asarray, (out, fe_out)))
        if k == keep_state_at:
            kept = state.frontend
    return res, kept


@pytest.fixture(scope="module")
def both_runs():
    cfg = slice_config()
    pb, cam0, cam1 = render(cfg, N_FRAMES)
    frames = tvio.frames_from_prebatch(pb, cam0, cam1, torch.device("cpu"))
    port = []
    tcfg = TConfig.from_json(cfg.to_json())  # the port's own Config, same values
    tvio.run_sequence(tcfg, frames, pb.gyro_bias, pb.acc_mean,
                      on_frame=lambda k, fe, out: port.append((out, fe)))
    ref, jax_fe_state = run_jax(cfg, pb, cam0, cam1)
    return tcfg, pb, frames, cam0, port, ref, jax_fe_state


def test_frontend_from_converted_jax_state(both_runs):
    """convert.frontend_state_to_torch: the port's front-end, started from the
    JAX state after frame K_CONVERT (plus that frame's cam0 image), reproduces
    the JAX front-end output of the next frame."""
    cfg, pb, frames, cam0, _, ref, jax_fe_state = both_runs
    k = K_CONVERT + 1
    cpu = torch.device("cpu")
    state = convert.frontend_state_to_torch(jax.tree.map(np.asarray, jax_fe_state),
                                            cam0[K_CONVERT], cfg, cpu)
    _, fe = frontend_step(state, frames.cam0[k], frames.cam1[k], frames.fe_mean_w[k],
                          frames.fe_dt[k], make_frontend_params(cfg, cpu), cfg)
    jfe = ref[k][1]
    same = (fe.ids.numpy() == jfe.ids) & (fe.mask.numpy() == jfe.mask)
    assert same.mean() >= 0.98
    both = same & jfe.mask
    np.testing.assert_allclose(fe.uv.numpy()[both], jfe.uv[both], atol=1e-4, rtol=0)


def test_slice_matches_jax_per_frame(both_runs):
    """Per frame: front-end ids/mask equal on >= 98% of slots, uv within 1e-4
    on slots both keep, and pose within 1e-3 m / 1e-4.  Not bit-exact: the LK
    sums run in another order (see test_torch_ops.py), so a feature sitting
    on a status threshold can flip, and float32 filter arithmetic rounds
    differently between the frameworks."""
    cfg, _, _, _, port, ref, _ = both_runs
    n_active = n_prune = n_lost = 0
    for k, ((tout, tfe), (jout, jfe)) in enumerate(zip(port, ref)):
        ids_eq = (tfe.ids.numpy() == jfe.ids) & (tfe.mask.numpy() == jfe.mask)
        assert ids_eq.mean() >= 0.98, f"frame {k}: ids agree on {ids_eq.mean():.3f}"
        both = ids_eq & jfe.mask
        assert both.sum() >= 40, f"frame {k}: only {both.sum()} features"
        np.testing.assert_allclose(tfe.uv.numpy()[both], jfe.uv[both], atol=1e-4, rtol=0)
        assert bool(tout.active) == bool(jout.active)
        if bool(jout.active):
            n_active += 1
            n_prune += int(jout.n_prune_feats) > 0
            n_lost += int(jout.n_update_rows) > 0
            np.testing.assert_allclose(tout.p.numpy(), jout.p, atol=1e-3, rtol=0)
            np.testing.assert_allclose(tout.q.numpy(), jout.q, atol=1e-4, rtol=0)
            assert int(tout.n_cams) == int(jout.n_cams)
    assert n_active >= 8 and n_prune >= 1 and n_lost >= 1


def _messages(cfg, frames):
    """The slice's IMU and stereo messages, as the streaming API takes them."""
    imu_t, imu_w, imu_a = TStereoWorld(cfg).imu_stream(T0 + N_FRAMES / 20.0 + 0.1)
    fts = T0 + TStereoWorld(cfg).frame_times(N_FRAMES / 20.0)
    imu = [imu_msg(t, w, a) for t, w, a in zip(imu_t, imu_w, imu_a)]
    img = [stereo_msg(t, c0, c1, None, None)
           for t, c0, c1 in zip(fts, frames.cam0.numpy(), frames.cam1.numpy())]
    return imu, img


def test_streaming_matches_batch_and_jax(both_runs, tmp_path):
    """The same frames and IMU messages, fed synchronously in timestamp order
    (IMU first on ties) through ``VIO(device="cpu")``, give the poses of the
    port's ``run_sequence`` within 1e-5 m / 1e-5, the same timestamps, and
    the JAX package's within the slice's tolerances (p 1e-3 m, q 1e-4); one
    host read per published pose.  Not exactly equal: ``prebatch_imu`` cuts
    the front-end's rotation window on rebased times and the orchestrator
    on absolute ones, and at frame 1 the sample stamped 1.49 s lies on the
    boundary prev_t - 0.01 (1.49 >= 1.5 - 0.01, but 1.49 - 1.5 < -0.01 in
    float64): one sample more in the mean angular velocity, 1.8e-4 rad/s.
    That moves the LK seeds of frame 1, LK stops within its 0.01 px
    precision of another point, and the tracks carry it on: 4.8e-8 m in
    frame 1's pose, 1.7e-6 m by frame 15.  With frames that start at time 0
    the windows are the same and so are the poses."""
    cfg, pb, frames, _, port, ref, _ = both_runs
    imu, img = _messages(cfg, frames)
    writer = TrajectoryWriter(path=str(tmp_path / "traj.txt"))
    v = tstream.VIO(cfg, Queue(), Queue(), trajectory_writer=writer, device="cpu")
    events = sorted([(m.timestamp, 0, m) for m in imu] + [(m.timestamp, 1, m) for m in img],
                    key=lambda e: e[:2])
    for _, kind, m in events:
        (v.process_imu_msg if kind == 0 else v.process_stereo_msg)(m)
        while not v._publish_queue.empty():
            v._publish(v._read(v._publish_queue.get()))
    np.testing.assert_array_equal(v.gyro_bias, pb.gyro_bias)
    np.testing.assert_array_equal(v.acc_mean, pb.acc_mean)
    active = [k for k, (out, _) in enumerate(port) if bool(out.active)]
    assert len(v.results) == len(active) == N_FRAMES and v.publish_reads == N_FRAMES
    traj = np.loadtxt(writer.path, ndmin=2)
    for row, res, k in zip(traj, v.results, active):
        tout, jout = port[k][0], ref[k][0]
        assert abs(res.timestamp - (pb.time_base + float(tout.timestamp))) < 1e-9
        np.testing.assert_allclose(row[1:4], tout.p.numpy(), atol=1e-5, rtol=0)
        np.testing.assert_allclose(row[4:8], tout.q.numpy(), atol=1e-5, rtol=0)
        np.testing.assert_allclose(row[1:4], jout.p, atol=1e-3, rtol=0)
        np.testing.assert_allclose(row[4:8], jout.q, atol=1e-4, rtol=0)
        # T_imu_body is the identity in this config: the body pose is the IMU pose
        np.testing.assert_allclose(res.pose.t, row[1:4], atol=1e-9)
        assert res.cam0_pose.R.shape == (3, 3) and np.isfinite(res.velocity).all()


@pytest.mark.parametrize("fault", [None, "step", "publish"])
def test_streaming_threads_join(both_runs, tmp_path, monkeypatch, fault):
    """Queues in, ``None`` sentinels, three threads: ``join`` returns with
    one pose per active frame; an exception in the device step or in the
    publish thread still unblocks ``join`` and is raised by it."""
    cfg, _, frames, _, _, _, _ = both_runs
    imu, img = _messages(cfg, frames)
    n = 3
    if fault == "step":
        real_step, calls = tstream.vio_step, []

        def step(*args):
            calls.append(1)
            if len(calls) == 2:
                raise ValueError("injected step fault")
            return real_step(*args)

        monkeypatch.setattr(tstream, "vio_step", step)
    img_q, imu_q = Queue(), Queue()
    v = tstream.VIO(cfg, img_q, imu_q, device="cpu",
                    trajectory_writer=TrajectoryWriter(path=str(tmp_path / "traj.txt")))
    if fault == "publish":
        monkeypatch.setattr(v, "_publish", lambda o: 1 / 0)
    v.start()
    for m in imu:
        imu_q.put(m)
    imu_q.put(None)
    v.imu_thread.join(timeout=60)
    assert not v.imu_thread.is_alive() and v.is_gravity_set
    for m in img[:n]:
        img_q.put(m)
    img_q.put(None)
    if fault is None:
        v.join()
        assert len(v.results) == n
    else:
        with pytest.raises(RuntimeError, match="error in one of its threads") as err:
            v.join()
        assert isinstance(err.value.__cause__,
                          ValueError if fault == "step" else ZeroDivisionError)
        assert len(v.results) == (1 if fault == "step" else 0)
    assert not v.img_thread.is_alive() and not v.publish_thread.is_alive()


def test_port_imports_without_jax():
    """Every module of the port imports with JAX and cv2 unavailable."""
    import subprocess
    import sys

    code = ("import sys; sys.modules['jax'] = None; sys.modules['cv2'] = None\n"
            "import pkgutil, importlib, uav_airvision_tpu_torch as p\n"
            "mods = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
            "[importlib.import_module(m) for m in mods]\n"
            "assert not any(k == 'jax' or k.startswith('jax.') for k in sys.modules"
            " if sys.modules[k] is not None)\n"
            "print(len(mods))\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 15
