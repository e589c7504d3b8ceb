"""Command line of the PyTorch port.

    python -m uav_airvision_tpu_torch.main --synthetic 8 --eval [--device cpu]
    python -m uav_airvision_tpu_torch.main --mode realtime --synthetic 8 --warmup --eval

Two modes, as the JAX package's CLI (uav_airvision_tpu/main.py):

* ``--mode batch`` (default): prebatch the whole sequence and run it through
  ``run_sequence`` on ``--device``.
* ``--mode realtime``: threaded playback through queues into the streaming
  orchestrator (``vio.VIO``) at ``--ratio`` x real time, headless unless a
  viewer is passed to ``VIO`` by a caller.

``--synthetic SECONDS`` renders the calibrated StereoWorld in memory.
``--path`` reads a EuRoC sequence through ``streaming/dataset.py`` (realtime
mode only); it needs OpenCV to decode the images and is untested: the
repository holds no EuRoC sequence.  Both modes write the reference
trajectory format to ``results/txts/output_<name>_offset<offset>.txt`` and,
with ``--eval``, print ATE/RTE against ground truth.
"""

from __future__ import annotations

import argparse
import os
import time


class _ListStream:
    """In-memory dataset-shaped iterable for DataPublisher."""

    def __init__(self, msgs, starttime=0.0):
        self.msgs = msgs
        self.starttime = starttime

    def __iter__(self):
        return iter(self.msgs)


def _render(config, duration):
    """(world, imu arrays, frame times, cam0 frames, cam1 frames) of the
    built-in simulator, seed 5."""
    import numpy as np

    from .simulation.world import StereoWorld

    world = StereoWorld(config)
    imu = world.imu_stream(duration)
    fts = world.frame_times(duration)
    rng = np.random.default_rng(5)
    cam0, cam1 = zip(*(world.render_frame(t, rng) for t in fts))
    return world, imu, fts, cam0, cam1


def synthetic_streams(config, duration):
    """(imu stream, stereo stream, ground truth dict) of message lists."""
    from .streaming.dataset import imu_msg, stereo_msg

    world, (ts_imu, ws, accs), fts, cam0, cam1 = _render(config, duration)
    imu_msgs = [imu_msg(t, w, a) for t, w, a in zip(ts_imu, ws, accs)]
    img_msgs = [stereo_msg(t, i0, i1, None, None) for t, i0, i1 in zip(fts, cam0, cam1)]
    gt = dict(timestamp=fts, p=world.groundtruth(fts))
    return _ListStream(imu_msgs), _ListStream(img_msgs), gt


def _evaluate(ts, p, gt):
    from .evaluation.metrics import ate, rte

    a = ate(ts, p, gt["timestamp"], gt["p"])
    r = rte(ts, p, gt["timestamp"], gt["p"])
    print(f"[eval] ATE rmse={a['rmse']:.4f}m mean={a['mean']:.4f}m | "
          f"RTE rmse={r['rmse']:.4f}m")


def run_batch(args):
    import numpy as np
    import torch

    from .config import euroc_config
    from .device import get_device
    from .models.vio import frames_from_prebatch, run_sequence
    from .streaming.prebatch import prebatch_imu
    from .utils.trajectory import TrajectoryWriter

    if not args.synthetic:
        raise SystemExit("batch mode runs --synthetic SECONDS; a EuRoC --path runs in "
                         "--mode realtime")
    device = get_device(args.device)
    config = euroc_config()
    t0 = time.time()
    world, (imu_t, imu_w, imu_a), fts, cam0, cam1 = _render(config, args.synthetic)
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
        _evaluate(ts_abs[act], p[act], dict(timestamp=fts, p=world.groundtruth(fts)))


def run_realtime(args):
    from queue import Queue

    import numpy as np

    from .config import euroc_config
    from .device import get_device
    from .streaming.publisher import DataPublisher
    from .utils.trajectory import TrajectoryWriter
    from .vio import VIO

    get_device(args.device)  # fail before rendering when the device is missing
    config = euroc_config()
    gt = None
    if args.synthetic:
        imu_src, img_src, gt = synthetic_streams(config, args.synthetic)
        name, offset = "synthetic", "0"
    else:
        from .streaming.dataset import EuRoCDataset

        dataset = EuRoCDataset(args.path)
        dataset.set_starttime(offset=args.offset)
        imu_src, img_src = dataset.imu, dataset.stereo
        name, offset = os.path.basename(os.path.normpath(args.path)), str(int(args.offset))
        if args.eval:
            gt = dataset.groundtruth.load()

    img_q, imu_q = Queue(), Queue()
    writer = TrajectoryWriter(dataset_name=name, offset=offset)
    vio = VIO(config, img_q, imu_q, trajectory_writer=writer, device=args.device)
    vio.start()
    if args.warmup:
        # build and load the kernels before the clock starts, so the paced
        # run measures the steady state
        t0 = time.time()
        vio.warmup()
        print(f"[realtime] warmup {time.time() - t0:.1f}s")

    now = time.time()
    imu_pub = DataPublisher(imu_src, imu_q, duration=args.duration, ratio=args.ratio)
    img_pub = DataPublisher(img_src, img_q, duration=args.duration, ratio=args.ratio)
    imu_pub.start(now)
    img_pub.start(now)
    vio.join()
    wall = time.time() - now
    n = len(vio.results)
    print(f"[realtime] {n} poses in {wall:.1f}s wall "
          f"({n / wall:.1f} poses/s end-to-end) -> {writer.path}")
    if args.eval and gt is not None and n:
        _evaluate(np.array([r.timestamp for r in vio.results]),
                  np.stack([r.pose.t for r in vio.results]), gt)  # published body poses


def main(argv=None):
    parser = argparse.ArgumentParser(description="stereo VIO, PyTorch port")
    parser.add_argument("--path", default=None,
                        help="EuRoC sequence directory (realtime mode; needs OpenCV; untested)")
    parser.add_argument("--offset", type=float, default=10.0,
                        help="seconds to skip at the start of a --path sequence")
    parser.add_argument("--mode", choices=["batch", "realtime"], default="batch")
    parser.add_argument("--ratio", type=float, default=0.4,
                        help="realtime playback speed (reference: 0.4)")
    parser.add_argument("--duration", type=float, default=float("inf"),
                        help="realtime mode: stop publishing after this many dataset seconds")
    parser.add_argument("--synthetic", type=float, default=0.0,
                        help="seconds of the built-in simulator to run instead of a dataset")
    parser.add_argument("--eval", action="store_true",
                        help="compute ATE/RTE against ground truth")
    parser.add_argument("--warmup", action="store_true",
                        help="realtime mode: run a dummy frame (kernel build and load) before "
                             "starting the publishers")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    if not args.synthetic and not args.path:
        parser.error("give --synthetic SECONDS or --path EUROC_DIR")
    if args.mode == "realtime":
        run_realtime(args)
    else:
        run_batch(args)


if __name__ == "__main__":
    main()
