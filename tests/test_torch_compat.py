"""The port's reference-shaped facade (``uav_airvision_tpu_torch.compat``)
against the JAX package's (``uav_airvision_tpu.compat``), on the CPU.

tests/test_compat.py's four scenarios on its small world (188x120, 64
feature slots): the callback API end to end, feature starvation (the stereo
seed fallback), an IMU outage, and the reset that keeps the learned
extrinsics.  Both facades get the same messages; every pose the port
publishes lies within 1e-3 m (1e-4 in the quaternion) of the JAX facade's,
the tolerance of tests/test_torch_slice.py: the LK sums run in another
order, so a feature on a status threshold can flip, and the float32 filter
rounds differently in the two frameworks.  The options that the default
configuration leaves off are held to JAX function by function
(tests/test_torch_ops.py, tests/test_torch_backend.py).

One JAX facade pair is built and re-armed between scenarios: each JAX
facade compiles its own steps on construction.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from uav_airvision_tpu import compat as jcompat
from uav_airvision_tpu.config import euroc_config
from uav_airvision_tpu.models.frontend.pipeline import init_frontend_state as j_init_fe
from uav_airvision_tpu.simulation.world import StereoWorld
from uav_airvision_tpu_torch import compat as tcompat
from uav_airvision_tpu_torch.config import Config as TConfig
from uav_airvision_tpu_torch.streaming.dataset import imu_msg, stereo_msg
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

CPU = "cpu"


def small_cfg():
    """tests/test_compat.py's configuration, with the JAX LK's iterations
    as a while loop (``lk_static_iters=False``: the same steps, config.py;
    a shorter compile; the port has one form)."""
    cfg = euroc_config()
    cfg = dataclasses.replace(cfg, frontend=dataclasses.replace(cfg.frontend,
                                                                lk_static_iters=False))
    sx, sy = 188.0 / 752.0, 120.0 / 480.0
    c = cfg.calib
    fx, fy, cx, cy = c.cam0_intrinsics
    cam0 = (fx * sx, fy * sy, cx * sx, cy * sy)
    fx, fy, cx, cy = c.cam1_intrinsics
    cam1 = (fx * sx, fy * sy, cx * sx, cy * sy)
    calib = dataclasses.replace(c, cam0_intrinsics=cam0, cam1_intrinsics=cam1,
                                cam0_resolution=(188, 120), cam1_resolution=(188, 120))
    cap = dataclasses.replace(cfg.capacity, max_features=64, max_map_features=128,
                              max_lost_per_frame=32, max_prune_feats=48, max_update_rows=512,
                              max_prune_rows=512, max_imu_per_frame=32, imu_init_msgs=40)
    return dataclasses.replace(cfg, calib=calib, capacity=cap)


_JAX_FACADES = []


def jax_facades(cfg):
    """The JAX facade pair, re-armed as newly built."""
    if not _JAX_FACADES:
        _JAX_FACADES.extend((jcompat.ImageProcessor(cfg), jcompat.MSCKF(cfg)))
    ip, filt = _JAX_FACADES
    ip.state, ip.imu_buffer, ip._ptr_t, ip.prev_t = j_init_fe(cfg), [], -np.inf, None
    ip.num_features, ip._last_stereo = {}, None
    filt.state, filt.imu_buffer, filt.is_gravity_set = None, [], False
    filt.time_base, filt._kept_extrinsics = None, None
    return ip, filt


def drive(cfg, duration, imu_seed, frame_seed, dropout=None, starve=None):
    """The same IMU and stereo messages through both facades.  Returns
    (port facades, JAX facades, [(port result, JAX result)], world)."""
    world = StereoWorld(cfg)
    imu_t, imu_w, imu_a = world.imu_stream(duration, seed=imu_seed, dropout_window=dropout)
    fts = world.frame_times(duration)
    rng = np.random.default_rng(frame_seed)
    port = (tcompat.ImageProcessor(TConfig.from_json(cfg.to_json()), device=CPU),
            tcompat.MSCKF(TConfig.from_json(cfg.to_json()), device=CPU))
    ref = jax_facades(cfg)
    pairs, k = [], 0
    for t in fts:
        while k < len(imu_t) and imu_t[k] <= t:
            m = imu_msg(imu_t[k], imu_w[k], imu_a[k])
            for facade in (*port, *ref):
                facade.imu_callback(m)
            k += 1
        c0, c1 = world.render_frame(t, rng, starve_window=starve)
        outs = []
        for ip, filt in (port, ref):
            fmsg = ip.stereo_callback(stereo_msg(t, c0, c1, None, None))
            assert all(isinstance(f, tuple) and len(f) == 5 for f in fmsg.features)
            outs.append(filt.feature_callback(fmsg))
        assert (outs[0] is None) == (outs[1] is None)
        if outs[0] is not None:
            pairs.append(tuple(outs))
    return port, ref, pairs, world


def assert_same_poses(pairs, tol=1e-3):
    assert len(pairs) > 10
    for got, want in pairs:
        assert abs(got.timestamp - want.timestamp) < 1e-9
        assert np.isfinite(got.position).all()
        np.testing.assert_allclose(got.position, np.asarray(want.position), atol=tol, rtol=0)
        np.testing.assert_allclose(got.orientation, np.asarray(want.orientation), atol=tol / 10,
                                   rtol=0)


def test_facade_end_to_end_matches_jax():
    """The callback API end to end (stareo_callback alias, feature messages,
    vio_results, the full reset), poses held to the JAX facade's and, as in
    tests/test_compat.py, within 0.5 m of the ground truth."""
    cfg = small_cfg()
    (ip, filt), _, pairs, world = drive(cfg, 2.0, 1, 0)
    assert ip.stareo_callback == ip.stereo_callback
    assert_same_poses(pairs)
    errs = [np.linalg.norm(r.position - world.traj.pos(r.timestamp)) for r, _ in pairs[5:]]
    assert max(errs) < 0.5
    assert ip.num_features["after_ransac"] == ip.num_features["after_matching"]
    assert filt.is_gravity_set
    filt.reset()
    assert filt.state is None and not filt.is_gravity_set


def test_feature_starvation_recovery_matches_jax():
    """A textureless interval (1.4-1.8 s) starves the tracker and the stereo
    seed fallback fires; the port stays finite throughout.  Its poses equal
    the JAX facade's (1e-3 m) up to the interval; from there both are held
    to the ground truth (0.5 m, tests/test_compat.py's bound) only: on the
    textureless patches LK's normal matrix is near singular, the two
    frameworks' sums move the same tracks apart (up to ~2e-3 in normalized
    coordinates, measured), and the filter carries that."""
    cfg = small_cfg()
    (_, filt), _, pairs, world = drive(cfg, 3.0, 2, 1, starve=(1.4, 1.8))
    assert torch.isfinite(filt.state.cov).all()
    assert_same_poses([(g, w) for g, w in pairs if g.timestamp < 1.4])
    for g, w in pairs:
        for pos in (g.position, np.asarray(w.position)):
            assert np.isfinite(pos).all()
            assert np.linalg.norm(pos - world.traj.pos(g.timestamp)) < 0.5


def test_imu_dropout_matches_jax():
    """A 0.3 s IMU outage: frames in the gap propagate with whatever samples
    exist; no NaN, and the same poses as the JAX facade."""
    cfg = small_cfg()
    (_, filt), (_, jfilt), pairs, _ = drive(cfg, 2.5, 3, 2, dropout=(1.5, 1.8))
    assert torch.isfinite(filt.state.cov).all()
    assert np.isfinite(np.asarray(jfilt.state.cov)).all()
    assert_same_poses(pairs)


def test_msckf_reset_preserves_learned_extrinsics():
    """reset() keeps the learned IMU-cam0 extrinsics and the state id across
    the re-initialization (reference msckf.py:800-819), as the JAX facade's
    does; reset_state_cov re-initialises the covariance only."""
    cfg = small_cfg()
    filt = tcompat.MSCKF(TConfig.from_json(cfg.to_json()), device=CPU)
    jfilt = jcompat.MSCKF(cfg)
    n = cfg.capacity.imu_init_msgs
    for f in (filt, jfilt):
        for i in range(n):
            f.imu_callback(imu_msg(i * 0.005, np.zeros(3), np.array([0, 0, 9.81])))
    assert filt.is_gravity_set
    np.testing.assert_allclose(filt.state.cov.numpy(), np.asarray(jfilt.state.cov), atol=1e-7)
    R = filt.state.imu.R_imu_cam0.numpy() @ np.array([[0.9998, -0.02, 0], [0.02, 0.9998, 0],
                                                      [0, 0, 1.0]])
    t = filt.state.imu.t_cam0_imu.numpy() + 0.003
    dtype = filt.state.cov.dtype
    filt.state = filt.state._replace(imu=filt.state.imu._replace(
        R_imu_cam0=torch.as_tensor(R, dtype=dtype), t_cam0_imu=torch.as_tensor(t, dtype=dtype),
        sid=torch.tensor(7, dtype=torch.int32)))
    jfilt.state = jfilt.state._replace(imu=jfilt.state.imu._replace(
        R_imu_cam0=jnp.asarray(R, jfilt.state.cov.dtype),
        t_cam0_imu=jnp.asarray(t, jfilt.state.cov.dtype), sid=jnp.asarray(7, jnp.int32)))
    for f in (filt, jfilt):
        f.reset()
        assert not f.is_gravity_set
        for i in range(n):
            f.imu_callback(imu_msg(10 + i * 0.005, np.zeros(3), np.array([0, 0, 9.81])))
        assert f.is_gravity_set
    np.testing.assert_allclose(filt.state.imu.R_imu_cam0.numpy(), R, atol=1e-6)
    np.testing.assert_allclose(filt.state.imu.t_cam0_imu.numpy(), t, atol=1e-6)
    np.testing.assert_allclose(filt.state.imu.R_imu_cam0.numpy(),
                               np.asarray(jfilt.state.imu.R_imu_cam0), atol=1e-7)
    assert int(filt.state.imu.sid) == int(jfilt.state.imu.sid) == 7
    assert int(filt.state.cams.count) == 0
    filt.state = filt.state._replace(cov=filt.state.cov * 3.0)
    filt.reset_state_cov()
    jfilt.reset_state_cov()
    np.testing.assert_allclose(filt.state.cov.numpy(), np.asarray(jfilt.state.cov), atol=1e-7)


def test_facade_defaults_to_cuda(monkeypatch):
    """Both classes run on the card unless asked for the CPU, and raise
    without one; draw_features_stereo raises clearly without OpenCV."""
    import inspect
    import sys

    cfg = TConfig.from_json(small_cfg().to_json())
    for cls in (tcompat.ImageProcessor, tcompat.MSCKF):
        assert inspect.signature(cls.__init__).parameters["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cls in (tcompat.ImageProcessor, tcompat.MSCKF):
        with pytest.raises(RuntimeError, match="CUDA"):
            cls(cfg)
    ip = tcompat.ImageProcessor(cfg, device=CPU)
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(RuntimeError, match="OpenCV"):
        ip.draw_features_stereo(show=False)
