"""The long-horizon run's cases shared by tests/test_torch_long_run.py
(float32) and tests/test_torch_long_run_f64.py (float64): the
configuration, the JAX package's chunk loop as scripts/long_run.py:57-98
runs it, the port's run beside it, and the per-frame and per-chunk bars.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import torch

from uav_airvision_tpu.config import euroc_config
from uav_airvision_tpu.models.vio import VioFrame as JVioFrame
from uav_airvision_tpu.models.vio import run_sequence as j_run_sequence
from uav_airvision_tpu.simulation.world import (EUROC_MOTION_PRESETS, StereoWorld,
                                                Trajectory6DoF)
from uav_airvision_tpu.streaming.prebatch import prebatch_imu
from uav_airvision_tpu_torch import long_run
from uav_airvision_tpu_torch.config import Config as TConfig

DURATION = 1.2  # 24 frames
CHUNK_S = 0.4  # 8 frames a chunk
SEED = 7
JAX_KEYS = ("preset", "duration_s", "frames", "poses", "ate_rmse_m", "rte_rmse_m",
            "path_len_m", "online_resets", "max_pos_std_m", "wall_s")


def long_slice_config(dtype="float32"):
    cfg = euroc_config(dtype=dtype)
    return dataclasses.replace(
        cfg,
        capacity=dataclasses.replace(cfg.capacity, max_cam_states=8, imu_init_msgs=40),
        filter=dataclasses.replace(cfg.filter, max_cam_state_size=8),
        frontend=dataclasses.replace(cfg.frontend, lk_temporal_levels=3))


def jax_chunk_loop(cfg, rendered):
    """scripts/long_run.py's loop over DURATION seconds in chunks of
    CHUNK_S: per-frame (p, q, active, did_reset) and per-chunk (resets so
    far, position std, finite, sym_err).  ``rendered`` maps a chunk's first
    frame to its images: chunks missing there are rendered and put there."""
    world = StereoWorld(cfg, seed=SEED, trajectory=Trajectory6DoF(**EUROC_MOTION_PRESETS["easy"]),
                        scene="layered", photometric=True)
    imu_t, imu_w, imu_a = world.imu_stream(DURATION, seed=SEED)
    fts = world.frame_times(DURATION)
    pb = prebatch_imu(fts, imu_t, imu_w, imu_a, cfg.capacity.max_imu_per_frame,
                      cfg.capacity.imu_init_msgs)
    per = int(round(CHUNK_S * 20))
    rng = np.random.default_rng(SEED)
    state, outs, chunks, n_resets = None, [], [], 0
    for k0 in range(0, len(fts), per):
        k1 = min(k0 + per, len(fts))
        if k0 not in rendered:
            rendered[k0] = [world.render_frame(t, rng) for t in fts[k0:k1]]
        imgs = rendered[k0]
        frames = JVioFrame(
            timestamp=jnp.asarray(pb.timestamps[k0:k1], jnp.float32),
            cam0=jnp.asarray(np.stack([i[0] for i in imgs])),
            cam1=jnp.asarray(np.stack([i[1] for i in imgs])),
            imu_t=jnp.asarray(pb.imu_t[k0:k1], jnp.float32),
            imu_w=jnp.asarray(pb.imu_w[k0:k1], jnp.float32),
            imu_a=jnp.asarray(pb.imu_a[k0:k1], jnp.float32),
            imu_mask=jnp.asarray(pb.imu_mask[k0:k1]),
            fe_mean_w=jnp.asarray(pb.fe_mean_w[k0:k1], jnp.float32),
            fe_dt=jnp.asarray(pb.fe_dt[k0:k1], jnp.float32),
            active=jnp.asarray(pb.active[k0:k1]))
        state, out = j_run_sequence(cfg, frames, pb.gyro_bias, pb.acc_mean, state=state)
        act = np.asarray(out.active)
        n_resets += int(np.asarray(out.did_reset)[act].sum())
        outs.append({f: np.asarray(getattr(out, f)) for f in ("p", "q", "active", "did_reset")})
        cov = np.asarray(state.filter.cov)
        chunks.append(dict(frame=k1, resets=n_resets, finite=bool(np.isfinite(cov).all()),
                           pos_std=float(np.sqrt(np.max(np.diag(cov)[12:15]))),
                           sym_err=float(np.max(np.abs(cov - cov.T)))))
    return {f: np.concatenate([o[f] for o in outs]) for f in outs[0]}, chunks


def runs(dtype):
    """The port's chunked run on the CPU and JAX's chunk loop, in ``dtype``
    (each rendering its own frames, cv2 blocked by the caller).  Returns
    (the port's Config, its result, its outputs, its images by chunk, JAX's
    per-frame outputs, JAX's per-chunk rows)."""
    cfg = long_slice_config(dtype)
    tcfg = TConfig.from_json(cfg.to_json())
    images, jax_images = {}, {}
    result, outs = long_run.run(tcfg, DURATION, "easy", CHUNK_S, SEED, "cpu", images=images)
    want, jchunks = jax_chunk_loop(cfg, jax_images)
    return tcfg, result, outs, images, want, jchunks


def check_against_jax(result, outs, want, jchunks):
    """Per frame the slice test's bars (p 1e-3 m, q 1e-4); per chunk resets
    equal, position std within 1e-3 relative, both covariances finite."""
    act = want["active"]
    assert np.array_equal(outs.active.numpy(), act) and act.sum() >= 16
    p, q = outs.p.numpy(), outs.q.numpy()
    assert np.isfinite(p).all() and np.isfinite(q).all()
    np.testing.assert_allclose(p[act], want["p"][act], atol=1e-3, rtol=0)
    np.testing.assert_allclose(q[act], want["q"][act], atol=1e-4, rtol=0)
    assert len(result["chunks"]) == len(jchunks) == 3
    for row, j in zip(result["chunks"], jchunks):
        print(f"frame {row['frame']}: pos_std {row['pos_std_m']:.6g} (JAX {j['pos_std']:.6g}), "
              f"sym_err {row['sym_err']:.3g} (JAX {j['sym_err']:.3g}), resets {row['resets']}")
        assert row["frame"] == j["frame"]
        assert row["resets"] == j["resets"]
        assert row["cov_finite"] and j["finite"]
        assert abs(row["pos_std_m"] - j["pos_std"]) <= 1e-3 * j["pos_std"]
    assert result["online_resets"] == jchunks[-1]["resets"]
    assert result["poses"] == int(act.sum())


def chunks_equal_one_call(tcfg, outs, images):
    """The chunked run against one run_sequence call over the same frames
    (the chunks' images concatenated), bit for bit."""
    whole = {0: tuple(torch.cat([images[k][i] for k in sorted(images)]) for i in (0, 1))}
    _, one = long_run.run(tcfg, DURATION, "easy", DURATION, SEED, "cpu", images=whole)
    for f in ("p", "q", "v", "active", "did_reset", "timestamp"):
        assert torch.equal(getattr(outs, f), getattr(one, f)), f
