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
with ``torch.profiler`` (CPU and CUDA activities).  From the profile:
kernel launches per frame (``LAUNCH_CALLS``: the runtime's and the
driver's launch calls, the cluster and the cooperative launches included), device time per frame (the CUDA kernels' self time) and its share
of the window's wall time, the most frequent kernels, and each
hand-written kernel's launches per frame and device time per launch (us).  The index glue
K15 (``augment_state``, the prune's window compaction, ``online_reset``),
the EKF updates (``apply_update``, K11, and ``apply_update_rank12_rows``,
K12, as the back-end step calls them; ``apply_update_rank12`` where an
older tree calls it) and the front-end's fused calls (the
per-cell selection ``select_track`` and the prediction
``predict_warp_points`` as ``pipeline`` calls them, the stereo gate
``stereo_gate`` as ``stereo`` calls it, FAST ``detect_fast`` as
``pipeline`` calls it, and the LK calls ``lk.pyramidal_lk``, the compact
tracker's included) and
K9's row-indexed entry ``feature_block_rows`` and the triangulation of the
selected features ``_triangulate_selected`` (K13 with its call site's glue)
as the back-end step calls them run under profiler spans, and the launches made under each are counted (per
frame for K15; per call and per frame for the rest).  A span absent from the
profiled code (an older tree) reports nothing.  Prints one JSON line with
the card's name and power limit.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
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
K15_FUNCTIONS = ("augment_state", "_compact_window", "online_reset")
EKF_FUNCTIONS = ("apply_update", "apply_update_rank12", "apply_update_rank12_rows")


def span_functions(module, names, prefix):
    """Rebind ``module.<name>`` so each call runs under a profiler span
    ``<prefix> <name>``; returns {(module, name): original} for restoring.
    Names the module lacks are skipped."""
    originals = {(module, name): getattr(module, name) for name in names
                 if hasattr(module, name)}
    for (_, name), fn in originals.items():
        # wraps: the span carries the function's attributes (a wrapper's
        # launch counter, which the function itself updates by its name)
        @functools.wraps(fn)
        def spanned(*args, _fn=fn, _label=f"{prefix} {name}", **kwargs):
            with torch.profiler.record_function(_label):
                return _fn(*args, **kwargs)

        setattr(module, name, spanned)
    return originals


def count_under(events, prefix, names=LAUNCH_CALLS):
    """{span: [number of events named in ``names`` below it in the CPU call
    tree, number of spans]} for the spans whose name starts with ``prefix``.
    Only the host side of a span counts: the profiler also lists each span
    once more on the device side, without children."""
    def below(ev):
        return sum((c.name in names) + below(c) for c in ev.cpu_children)

    counts = {}
    for ev in events:
        if ev.name.startswith(prefix) and ev.device_type == torch.autograd.DeviceType.CPU:
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
    from .models.msckf import step
    from .models.frontend import pipeline, stereo
    from .ops import lk

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
    originals = span_functions(step, K15_FUNCTIONS, "K15")
    originals.update(span_functions(step, EKF_FUNCTIONS, "EKF"))
    # the front-end's fused calls, spanned where the front-end calls them
    originals.update(span_functions(pipeline, ("select_track", "predict_warp_points",
                                               "detect_fast"), "FE"))
    originals.update(span_functions(stereo, ("stereo_gate",), "FE"))
    originals.update(span_functions(lk, ("pyramidal_lk",), "FE"))
    # K9's row-indexed entry and the triangulation of the selected features,
    # where the back-end calls them (their gathers and masks inside)
    originals.update(span_functions(step, ("feature_block_rows", "_triangulate_selected"), "BE"))
    try:
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            vio.run_sequence(config, window, pb.gyro_bias, pb.acc_mean, state=state)
            torch.cuda.synchronize()
            prof_wall = time.perf_counter() - t0
    finally:
        for (module, name), fn in originals.items():
            setattr(module, name, fn)
    n = b - a
    k15 = count_under(prof.events(), "K15")
    ekf = count_under(prof.events(), "EKF")
    fe = count_under(prof.events(), "FE")
    be = count_under(prof.events(), "BE")
    events = prof.key_averages()
    launches = sum(e.count for e in events if e.key in LAUNCH_CALLS)
    # the spans show up on the device side too, as long as the kernels under them
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0 and not e.key.startswith(("K15", "EKF", "FE", "BE"))]
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
        "k15_launches_per_frame": {name: c[0] / n for name, c in sorted(k15.items())},
        "ekf_launches_per_call": {name: [c[0] / c[1], c[1]] for name, c in sorted(ekf.items())},
        # [launches per call, calls, launches per frame]
        "frontend_launches": {name: [c[0] / c[1], c[1], c[0] / n]
                              for name, c in sorted(fe.items())},
        "backend_launches": {name: [c[0] / c[1], c[1], c[0] / n]
                             for name, c in sorted(be.items())},
        "device_ms_per_frame": device_us / 1e3 / n,
        "profiled_wall_ms_per_frame": prof_wall * 1e3 / n,
        "device_busy_share": device_us / 1e6 / prof_wall,
        "top_kernels_by_count": [[e.key[:80], e.count / n, e.self_device_time_total / e.count]
                                 for e in top],
        "csrc_kernels": [[name, e.count / n, e.self_device_time_total / e.count]
                         for name, e in ours]}))


if __name__ == "__main__":
    main()
