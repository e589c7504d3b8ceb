"""Command line of the PyTorch port (batch mode on the built-in simulator).

    python -m uav_airvision_tpu_torch.main --synthetic 8 --eval [--device cpu]

Renders ``--synthetic`` seconds of the calibrated StereoWorld, runs the whole
sequence through ``run_sequence`` on ``--device``, writes the reference
trajectory format to ``results/txts/output_<name>_offset0.txt`` and, with
``--eval``, prints ATE/RTE against ground truth, as the JAX package's CLI
(uav_airvision_tpu/main.py) does in batch mode.
"""

from __future__ import annotations

import argparse
import time


def main(argv=None):
    parser = argparse.ArgumentParser(description="stereo VIO, PyTorch port")
    parser.add_argument("--synthetic", type=float, required=True,
                        help="seconds of the built-in simulator to run")
    parser.add_argument("--eval", action="store_true",
                        help="compute ATE/RTE against ground truth")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    import numpy as np
    import torch

    from .config import euroc_config
    from .simulation.world import StereoWorld
    from .streaming.prebatch import prebatch_imu
    from .utils.trajectory import TrajectoryWriter

    from .device import get_device
    from .models.vio import frames_from_prebatch, run_sequence

    device = get_device(args.device)
    config = euroc_config()
    t0 = time.time()
    world = StereoWorld(config)
    imu_t, imu_w, imu_a = world.imu_stream(args.synthetic)
    fts = world.frame_times(args.synthetic)
    rng = np.random.default_rng(5)
    cam0, cam1 = zip(*(world.render_frame(t, rng) for t in fts))
    pb = prebatch_imu(fts, imu_t, imu_w, imu_a, config.capacity.max_imu_per_frame,
                      config.capacity.imu_init_msgs)
    frames = frames_from_prebatch(pb, np.stack(cam0), np.stack(cam1), device)
    print(f"[load] {len(fts)} frames in {time.time() - t0:.1f}s")

    t0 = time.time()
    _, outs = run_sequence(config, frames, pb.gyro_bias, pb.acc_mean)
    if device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.time() - t0
    print(f"[run] {len(fts)} frames in {wall:.2f}s on {device} "
          f"({len(fts) / wall:.1f} fps incl. kernel build)")

    act = outs.active.cpu().numpy()
    p = outs.p.cpu().numpy()
    q = outs.q.cpu().numpy()
    ts_abs = pb.time_base + outs.timestamp.cpu().numpy().astype(np.float64)
    writer = TrajectoryWriter(dataset_name="synthetic", offset="0")
    writer.write_batch(ts_abs, p, q, act)
    print(f"[out] trajectory -> {writer.path} ({int(act.sum())} poses)")

    if args.eval:
        from .evaluation.metrics import ate, rte

        gtp = world.groundtruth(fts)
        a = ate(ts_abs[act], p[act], fts, gtp)
        r = rte(ts_abs[act], p[act], fts, gtp)
        print(f"[eval] ATE rmse={a['rmse']:.4f}m mean={a['mean']:.4f}m | "
              f"RTE rmse={r['rmse']:.4f}m")


if __name__ == "__main__":
    main()
