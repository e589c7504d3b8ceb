"""Where the main path's time goes on the card: frames/s, host syncs and CUDA
launches per frame, and the device's busy share.

    python -m uav_airvision_tpu_torch.profile_main [--frames 200] [--window 100 160]
        [--config default|compact] [--dtype float32|float64]

Renders the bench world as chip_smoke.py does (euroc_config, seed 5), runs
``run_sequence`` over it (under ``--config``: ``compact`` is chip_smoke.py's
compact configuration, ``frontend.lk_compact_windows`` with the
triangulation motion check at 0.05 m; ``--dtype float64`` the filter in
float64, the config's ``dtype``) once to warm up, then once more timed (host clock
around a synchronised run; ``device.host_syncs`` counted), then runs the
first ``window[0]`` frames again and profiles frames ``window[0]:window[1]``
with ``torch.profiler`` (CPU and CUDA activities) and the port's recorder on
(``utils/profiling.py``: the stage spans of ``frontend_step`` and
``backend_step``, the host reads by site).  From the profile: kernel
launches per frame (``LAUNCH_CALLS``: the runtime's and the driver's launch
calls, the cluster and the cooperative launches included), device time per
frame (the CUDA kernels' self time) and its share of the window's wall
time, the most frequent kernels, each hand-written kernel's launches per
frame and device time per launch (us), and for each of the program's stage
spans (``stages``) its calls, its launches (``count_under``) and the device
time of the operations launched inside it (``profiling.device_by_span``)
per frame, with its host ms per frame under the profiler.  Prints one JSON
line with the card's name and power limit.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import re
import subprocess
import time

import numpy as np
import torch


def render(n_frames: int):
    from .config import euroc_config
    from .simulation.world import StereoWorld
    from .streaming.prebatch import prebatch_imu

    config = euroc_config()
    world = StereoWorld(config)
    dur = n_frames / 20.0
    imu_t, imu_w, imu_a = world.imu_stream(dur)
    fts = world.frame_times(dur)
    rng = np.random.default_rng(5)
    cam0, cam1 = zip(*(world.render_frame(t, rng) for t in fts))
    pb = prebatch_imu(fts, imu_t, imu_w, imu_a, config.capacity.max_imu_per_frame,
                      config.capacity.imu_init_msgs)
    return config, pb, np.stack(cam0), np.stack(cam1)


# The configurations --config selects, as overrides of euroc_config's groups
# (chip_smoke.py's VARIANTS["compact"])
CONFIGS = {"default": {},
           "compact": {"frontend": {"lk_compact_windows": True},
                       "triangulation": {"translation_threshold": 0.05}}}


def variant(config, name: str):
    """``config`` with the overrides of CONFIGS[name]."""
    return dataclasses.replace(config, **{
        group: dataclasses.replace(getattr(config, group), **fields)
        for group, fields in CONFIGS[name].items()})


LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
                "cudaLaunchCooperativeKernel")


def count_under(events, spans, names=LAUNCH_CALLS):
    """{span: [number of events named in ``names`` below it in the CPU call
    tree, number of spans]} for the spans named in ``spans``.  Only the host
    side of a span counts: the profiler also lists each span once more on
    the device side, without children."""
    def below(ev):
        return sum((c.name in names) + below(c) for c in ev.cpu_children)

    counts = {}
    for ev in events:
        if ev.name in spans and ev.device_type == torch.autograd.DeviceType.CPU:
            c = counts.setdefault(ev.name, [0, 0])
            c[0] += below(ev)
            c[1] += 1
    return counts


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--frames", type=int, default=200)
    parser.add_argument("--window", type=int, nargs=2, default=(100, 160))
    parser.add_argument("--config", choices=sorted(CONFIGS), default="default")
    parser.add_argument("--dtype", choices=("float32", "float64"), default="float32")
    args = parser.parse_args(argv)
    a, b = args.window
    if not 0 <= a < b <= args.frames:
        parser.error("the window must lie inside the frames")

    from . import device
    from .models import vio
    from .utils import profiling

    dev = device.get_device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    config, pb, cam0, cam1 = render(args.frames)
    config = dataclasses.replace(variant(config, args.config), dtype=args.dtype)
    frames = vio.frames_from_prebatch(pb, cam0, cam1, dev)

    vio.run_sequence(config, frames, pb.gyro_bias, pb.acc_mean)  # warm-up, kernel build
    torch.cuda.synchronize()
    syncs0 = device.host_syncs["sync"]
    t0 = time.perf_counter()
    vio.run_sequence(config, frames, pb.gyro_bias, pb.acc_mean)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    syncs = (device.host_syncs["sync"] - syncs0) / args.frames

    head = vio.VioFrame(*(x[:a] for x in frames))
    window = vio.VioFrame(*(x[a:b] for x in frames))
    state, _ = vio.run_sequence(config, head, pb.gyro_bias, pb.acc_mean)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with profiling.recording(), torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        vio.run_sequence(config, window, pb.gyro_bias, pb.acc_mean, state=state)
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    n = b - a
    recorded = profiling.snapshot()
    launches_under = count_under(prof.events(), profiling.SPANS)
    device_under = profiling.device_by_span(prof.events())
    events = prof.key_averages()
    launches = sum(e.count for e in events if e.key in LAUNCH_CALLS)
    # the spans show up on the device side too, as long as the kernels under them
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0 and e.key not in profiling.SPANS]
    device_us = sum(e.self_device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: -e.count)[:12]
    # the hand-written kernels of csrc/ (each in an anonymous namespace of its own)
    ours = sorted([(m.group(1), e) for e in kernels
                   if (m := re.match(r"(?:void )?\(anonymous namespace\)::([^(]+)", e.key))],
                  key=lambda x: x[0])
    print(json.dumps({
        "card": smi.stdout.strip() if smi.returncode == 0 else "nvidia-smi failed",
        "config": args.config, "dtype": args.dtype, "frames": args.frames, "frames_per_s": args.frames / wall, "wall_s": wall,
        "host_syncs_per_frame": syncs, "window": [a, b],
        "launches_per_frame": launches / n,
        # each stage span's calls, launches, device us and host ms per frame
        "stages": {name: {"calls": c[1] / n, "launches": c[0] / n,
                          "device_us": 1e6 * device_under.get(name, [0.0])[0] / n,
                          "host_ms": 1e3 * recorded["spans"][name][0] / n}
                   for name, c in sorted(launches_under.items())},
        "device_us_unattributed": 1e6 * device_under.get("(unattributed)", [0.0])[0] / n,
        "counters_per_frame": {k: v / n for k, v in sorted(recorded["counters"].items())},
        "device_ms_per_frame": device_us / 1e3 / n,
        "profiled_wall_ms_per_frame": prof_wall * 1e3 / n,
        "device_busy_share": device_us / 1e6 / prof_wall,
        "top_kernels_by_count": [[e.key[:80], e.count / n, e.self_device_time_total / e.count]
                                 for e in top],
        "csrc_kernels": [[name, e.count / n, e.self_device_time_total / e.count]
                         for name, e in ours]}))


if __name__ == "__main__":
    main()
