"""Command line of the PyTorch port, flag-compatible with the reference
entry point (``python main.py --path <euroc_dir> --offset <sec> [--view]``)
and with the JAX package's CLI (uav_airvision_tpu/main.py).

    python -m uav_airvision_tpu_torch.main --path <euroc_dir> --offset 0 --eval [--device cpu]
    python -m uav_airvision_tpu_torch.main --synthetic 8 --eval
    python -m uav_airvision_tpu_torch.main --mode realtime --synthetic 8 --warmup --eval

Two modes:

* ``--mode batch`` (default): decode and prebatch the whole sequence and run
  it through ``run_sequence`` on ``--device``; ``--checkpoint-dir`` snapshots
  the state every ``--checkpoint-every`` frames and resumes from the latest
  snapshot, ``--profile`` writes the stage timings and a torch.profiler trace
  under ``reports/``, the trace holding the port's stage spans
  (``utils/profiling.py``'s recorder, on for the run; their host seconds in
  ``reports/profile_spans.json``), ``--view`` replays the trajectory in the viewer.
* ``--mode realtime``: threaded playback through queues into the streaming
  orchestrator (``vio.VIO``) at ``--ratio`` x real time.

``--path`` reads a EuRoC sequence directory (``streaming/dataset.py``, PNGs
decoded by the port's loader, ``runtime/``); ``--synthetic SECONDS`` renders
the calibrated StereoWorld in memory instead.  ``--long-horizon`` runs
``long_horizon_config()``.  Both modes write the reference trajectory format
to ``results/txts/output_<name>_offset<offset>.txt`` and, with ``--eval``,
print ATE/RTE against ground truth.  The viewer degrades to a headless no-op
without PyQt5.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import NamedTuple, Optional


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
    return a, r


def build_frames_from_euroc(config, path, offset, device):
    """(frames on ``device``, PrebatchedSequence, ground truth or None) of
    the EuRoC sequence at ``path`` from ``offset`` seconds on: every image
    decoded in one multithreaded call (runtime/loader.cpp), the IMU
    prebatched, ground truth loaded when the sequence has it."""
    from .models.vio import frames_from_prebatch
    from .streaming.dataset import EuRoCDataset
    from .streaming.prebatch import load_euroc_arrays, prebatch_imu

    dataset = EuRoCDataset(path)
    dataset.set_starttime(offset=offset)
    fts, cam0, cam1, imu_t, imu_w, imu_a = load_euroc_arrays(dataset)
    pb = prebatch_imu(fts, imu_t, imu_w, imu_a, config.capacity.max_imu_per_frame,
                      config.capacity.imu_init_msgs)
    frames = frames_from_prebatch(pb, cam0, cam1, device)
    gt = None
    if os.path.isfile(dataset.groundtruth.path):
        gt = dataset.groundtruth.load()
    return frames, pb, gt


def build_frames_synthetic(config, duration, device):
    """(frames on ``device``, PrebatchedSequence, ground truth) of
    ``duration`` seconds of the built-in simulator, seed 5."""
    import numpy as np

    from .models.vio import frames_from_prebatch
    from .streaming.prebatch import prebatch_imu

    world, (imu_t, imu_w, imu_a), fts, cam0, cam1 = _render(config, duration)
    pb = prebatch_imu(fts, imu_t, imu_w, imu_a, config.capacity.max_imu_per_frame,
                      config.capacity.imu_init_msgs)
    frames = frames_from_prebatch(pb, np.stack(cam0), np.stack(cam1), device)
    return frames, pb, dict(timestamp=fts, p=world.groundtruth(fts))


class BatchRun(NamedTuple):
    """What ``run_batch`` did: the prebatched sequence, the outputs of the
    frames it ran (frames [start_frame, T); None when a checkpoint already
    covered them all), the host seconds of loading and of the run (which
    ends in a device synchronisation), and ATE/RTE when evaluated."""

    pb: object
    outputs: object
    start_frame: int
    load_s: float
    run_s: float
    trajectory: Optional[str]
    ate: Optional[dict]
    rte: Optional[dict]


def _config(args):
    from .config import euroc_config, long_horizon_config

    return long_horizon_config() if args.long_horizon else euroc_config()


def run_batch(args) -> BatchRun:
    """Batch mode: load the whole sequence, run it (checkpointed, traced
    where asked), write the trajectory, evaluate and view it."""
    import contextlib

    import numpy as np
    import torch

    from .device import get_device
    from .models.vio import run_sequence, run_sequence_checkpointed
    from .utils.trajectory import TrajectoryWriter

    device = get_device(args.device)
    config = _config(args)
    if args.synthetic:
        name, offset = "synthetic", "0"
    else:
        name, offset = os.path.basename(os.path.normpath(args.path)), str(int(args.offset))

    timer = None
    if args.profile:
        from .utils import profiling

        timer = profiling.StageTimer()

    def staged(stage_name):
        return timer.stage(stage_name) if timer else contextlib.nullcontext()

    with staged("load"):
        t0 = time.time()
        if args.synthetic:
            frames, pb, gt = build_frames_synthetic(config, args.synthetic, device)
        else:
            frames, pb, gt = build_frames_from_euroc(config, args.path, args.offset, device)
        load_s = time.time() - t0
    n_frames = len(pb.timestamps)
    print(f"[load] {n_frames} frames in {load_s:.1f}s")

    trace_dir = os.path.join("reports", "torch_trace")
    t0 = time.time()
    with staged("run"), (profiling.recording() if timer else contextlib.nullcontext()), \
            (profiling.device_trace(trace_dir, device) if timer else contextlib.nullcontext()):
        if args.checkpoint_dir:
            _, outs, start = run_sequence_checkpointed(
                config, frames, pb.gyro_bias, pb.acc_mean,
                checkpoint_dir=args.checkpoint_dir, every=args.checkpoint_every)
            if start:
                print(f"[resume] from checkpointed frame {start}")
        else:
            (_, outs), start = run_sequence(config, frames, pb.gyro_bias, pb.acc_mean), 0
        if device.type == "cuda":
            torch.cuda.synchronize()
    run_s = time.time() - t0
    if timer:
        print(f"[profile] device trace -> {trace_dir}")
    n = n_frames - start
    print(f"[run] {n} frames in {run_s:.2f}s on {device} "
          f"({n / run_s:.1f} fps incl. kernel build)")

    path = a = r = None
    if outs is not None:
        act = outs.active.cpu().numpy()
        p = outs.p.cpu().numpy()
        q = outs.q.cpu().numpy()
        # device times are rebased (float32-safe); restore absolute stamps here
        ts_abs = pb.time_base + outs.timestamp.cpu().numpy().astype(np.float64)
        writer = TrajectoryWriter(dataset_name=name, offset=offset)
        writer.write_batch(ts_abs, p, q, act)
        path = writer.path
        print(f"[out] trajectory -> {path} ({int(act.sum())} poses)")
        if args.eval and gt is not None:
            a, r = _evaluate(ts_abs[act], p[act], gt)
        if args.view:
            from .viewer import SimpleViewer

            SimpleViewer().replay(outs.timestamp.cpu().numpy()[act], p[act])

    if timer:
        os.makedirs("reports", exist_ok=True)
        stages = os.path.join("reports", "profile_stages.json")
        timer.dump(stages)
        print(f"[profile] stage timings -> {stages}\n{timer.dump()}")
        spans = os.path.join("reports", "profile_spans.json")
        with open(spans, "w") as f:
            json.dump(profiling.snapshot(), f, indent=1)
        print(f"[profile] program spans and counters -> {spans}")
    return BatchRun(pb, outs, start, load_s, run_s, path, a, r)


def run_realtime(args):
    from queue import Queue

    import numpy as np

    from .device import get_device
    from .streaming.publisher import DataPublisher
    from .utils.trajectory import TrajectoryWriter
    from .vio import VIO

    get_device(args.device)  # fail before rendering when the device is missing
    config = _config(args)
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

    viewer = None
    if args.view:
        from .viewer import SimpleViewer

        viewer = SimpleViewer()
    img_q, imu_q = Queue(), Queue()
    writer = TrajectoryWriter(dataset_name=name, offset=offset)
    vio = VIO(config, img_q, imu_q, viewer, trajectory_writer=writer, device=args.device)
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
    return vio.results


def main(argv=None):
    """Parse ``argv`` and run the mode; returns run_batch's ``BatchRun`` or
    the realtime mode's published results."""
    parser = argparse.ArgumentParser(description="stereo VIO, PyTorch port")
    parser.add_argument("--path", default=None, help="EuRoC sequence directory")
    parser.add_argument("--offset", type=float, default=10.0,
                        help="seconds to skip at the start of a --path sequence")
    parser.add_argument("--view", action="store_true",
                        help="show the trajectory in the viewer (needs PyQt5; headless "
                             "without it)")
    parser.add_argument("--mode", choices=["batch", "realtime"], default="batch")
    parser.add_argument("--ratio", type=float, default=0.4,
                        help="realtime playback speed (reference: 0.4)")
    parser.add_argument("--duration", type=float, default=float("inf"),
                        help="realtime mode: stop publishing after this many dataset seconds")
    parser.add_argument("--synthetic", type=float, default=0.0,
                        help="seconds of the built-in simulator to run instead of a dataset")
    parser.add_argument("--eval", action="store_true",
                        help="compute ATE/RTE against ground truth")
    parser.add_argument("--checkpoint-dir", default=None,
                        help="batch mode: snapshot the VIO state every --checkpoint-every "
                             "frames; if the directory already holds snapshots, resume from "
                             "the latest one")
    parser.add_argument("--checkpoint-every", type=int, default=200)
    parser.add_argument("--long-horizon", action="store_true",
                        help="use long_horizon_config(): 3-level temporal LK for missions "
                             "beyond ~60 s")
    parser.add_argument("--warmup", action="store_true",
                        help="realtime mode: run a dummy frame (kernel build and load) before "
                             "starting the publishers")
    parser.add_argument("--profile", action="store_true",
                        help="batch mode: time the load and run stages and trace the run with "
                             "torch.profiler, the port's stage spans recorded; writes "
                             "reports/profile_stages.json, reports/profile_spans.json and "
                             "reports/torch_trace/trace.json")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    if not args.synthetic and not args.path:
        parser.error("give --synthetic SECONDS or --path EUROC_DIR")
    if args.mode == "realtime":
        return run_realtime(args)
    return run_batch(args)


if __name__ == "__main__":
    main()
