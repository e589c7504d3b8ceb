#!/usr/bin/env python
"""The JAX package's ATE max on the 200-frame bench world rendered without
OpenCV, per configuration: the figures that chip_smoke.py's ATE bars are
1.25 x of.

    JAX_PLATFORMS=cpu python tools/jax_ate_bar.py [variant ...]

The world is the one bench.py and chip_smoke.py render (StereoWorld,
``default_rng(5)``, 200 frames = 10 s, 752x480) with ``cv2`` blocked, as on
a machine without OpenCV.  ATE max is the largest per-frame
``|p - groundtruth(t)|`` over the active frames, no alignment
(tests/test_e2e.py).  Variants (chip_smoke.py runs the same ones on the
port):

- ``default``: ``euroc_config()``;
- ``compact``: ``frontend.lk_compact_windows=True`` and the triangulation
  motion check on (``triangulation.translation_threshold=0.05``);
- ``exact``: scripts/diag_long_drift.py's ``exact`` variant (30 LK
  iterations on every level, the full temporal pyramid, unseeded stereo,
  the full-pyramid backward check, the exact adder mask) plus the stacked
  camera-prune update (``filter.prune_rank12=False``).

Runs on the CPU; one variant takes a few minutes (compile included).
"""

import dataclasses
import json
import os
import sys
import time

sys.modules["cv2"] = None  # render as a machine without OpenCV does
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

N_FRAMES = 200
VARIANTS = {
    "default": {},
    "compact": {"frontend": {"lk_compact_windows": True},
                "triangulation": {"translation_threshold": 0.05}},
    "exact": {"frontend": {"lk_max_iteration": 30, "lk_max_iteration_upper": 0,
                           "lk_temporal_levels": 0, "stereo_seeded": False,
                           "stereo_full_backward": True, "exact_adder_mask": True},
              "filter": {"prune_rank12": False}},
}


def variant_config(base, over):
    return dataclasses.replace(base, **{
        group: dataclasses.replace(getattr(base, group), **fields)
        for group, fields in over.items()})


def main(names):
    import jax.numpy as jnp

    from uav_airvision_tpu.config import euroc_config
    from uav_airvision_tpu.models.vio import VioFrame, run_sequence
    from uav_airvision_tpu.simulation.world import StereoWorld
    from uav_airvision_tpu.streaming.prebatch import prebatch_imu

    base = euroc_config()
    world = StereoWorld(base)
    dur = N_FRAMES / 20.0
    imu_t, imu_w, imu_a = world.imu_stream(dur)
    fts = world.frame_times(dur)
    rng = np.random.default_rng(5)
    cam0, cam1 = zip(*(world.render_frame(t, rng) for t in fts))
    pb = prebatch_imu(fts, imu_t, imu_w, imu_a, base.capacity.max_imu_per_frame,
                      base.capacity.imu_init_msgs)
    f32 = jnp.float32
    frames = VioFrame(
        timestamp=jnp.asarray(pb.timestamps, f32), cam0=jnp.asarray(np.stack(cam0)),
        cam1=jnp.asarray(np.stack(cam1)), imu_t=jnp.asarray(pb.imu_t, f32),
        imu_w=jnp.asarray(pb.imu_w, f32), imu_a=jnp.asarray(pb.imu_a, f32),
        imu_mask=jnp.asarray(pb.imu_mask), fe_mean_w=jnp.asarray(pb.fe_mean_w, f32),
        fe_dt=jnp.asarray(pb.fe_dt, f32), active=jnp.asarray(pb.active))
    for name in names:
        cfg = variant_config(base, VARIANTS[name])
        t0 = time.time()
        _, outs = run_sequence(cfg, frames, pb.gyro_bias, pb.acc_mean)
        act = np.asarray(outs.active)
        p = np.asarray(outs.p)[act]
        err = np.linalg.norm(p - world.groundtruth(pb.timestamps[act]), axis=1)
        print(json.dumps({"variant": name, "active": int(act.sum()),
                          "finite": bool(np.isfinite(p).all()),
                          "ate_max_m": float(err.max()),
                          "ate_rmse_m": float(np.sqrt(np.mean(err ** 2))),
                          "bar_m": 1.25 * float(err.max()),
                          "seconds": round(time.time() - t0, 1)}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:] or list(VARIANTS))
