"""Fleet throughput: B VIO instances on one card over the bench world.

    python -m uav_airvision_tpu_torch.fleet_bench [B ...] [--decorrelated] [--device cpu]

The port's counterpart of scripts/fleet_bench.py.  Renders the bench world
(euroc_config, seed 5) for BENCH_FRAMES frames (60 by default) a step, and
for each B (1, 4 and 8 by default) runs ``parallel.fleet.run_fleet`` over
(T, B) frames: broadcast copies of the one stream, or with
``--decorrelated`` instance b starting FLEET_STRIDE x b frames in (7 by
default), so that the instances' tracks and filter decisions diverge.  Each
B runs once to warm up, then once timed (host clock around a synchronised
run).  Prints, for each B: aggregate instance-frames/s, host syncs per step
(``device.host_syncs``), each batched kernel's launches per step (the
front-end's K2, K4+K6, K5, K1, K7's prediction and K8's selection and
first-frame entries, the back-end's K14, K13, K9, K10, K11 and K12: their
wrappers' counts) and, on the card, CUDA launches per step and those
kernels' device us per launch and per step (torch.profiler over steps
40-44, run again from the state before them) and peak device memory; then
one JSON line with the card's name and power limit.  On the card unless
``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

import torch

from . import device
from .models import vio
from .models.msckf import propagation, triangulation, update
from .ops import camera, fast, gridops, lk, pyramid
from .parallel import fleet
from .profile_main import LAUNCH_CALLS, render

# the front-end's kernels with an instance axis, by their wrappers (K1:
# either tracker; K8's first-frame entries run on an instance's first frame)
BATCHED = {"K2": (pyramid.build_pyramid_pair,), "K4+K6": (fast.detect_fast,),
           "K5": (gridops.dense_grid_topk,), "K1": (lk.pyramidal_lk, lk.pyramidal_lk_compact),
           "K7 predict": (camera.predict_warp_points,), "K8 select": (gridops.select_track,),
           "K8 first frame": (gridops.rank_in_cell, gridops.kept_order_stats,
                              gridops.compact_kept)}
# the back-end's kernels with an instance axis (launched once a stage; K11
# and K12 once an update stage)
BACKEND = {"K14": (propagation.propagate,), "K13": (triangulation.triangulate_rows,),
           "K9": (update.feature_block_rows,), "K10": (update.gating_test_batch,),
           "K11": (update.apply_update,), "K12": (update.apply_update_rank12_rows,)}
# their CUDA kernels, by a part of the name the profiler lists
KERNEL_NAMES = {"K2": ("pyramid_kernel", "level0_kernel", "level_kernel"),
                "K4+K6": ("fast_tile_kernel",), "K5": ("grid_topk",),
                "K1": ("lk_kernel", "lk_compact_kernel"), "K7 predict": ("predict_warp_kernel",),
                "K8 select": ("select_track_kernel",),
                "K8 first frame": ("rank_in_cell_kernel", "kept_order_stats_kernel",
                                   "compact_kept_kernel"),
                "K14": ("propagate_kernel",), "K13": ("triangulate_kernel",),
                "K9": ("feature_block_kernel",), "K10": ("gate_small_kernel", "gate_tiered_kernel"),
                "K11": ("update_kernel",), "K12": ("rank12_kernel",)}


def fleet_frames(frames: vio.VioFrame, T: int, B: int, stride: int) -> vio.VioFrame:
    """(T, B) frames from a (T', ...) stream: instance b sees frames
    [stride * b, stride * b + T) (stride 0: broadcast copies)."""
    idx = (torch.arange(T)[:, None] + stride * torch.arange(B)[None, :]).to(frames.cam0.device)
    return vio.VioFrame(*(x[idx] for x in frames))


PROFILE_WINDOW = (40, 45)  # steps profiled (every instance active at stride 7, B <= 8)


def measure(config, frames: vio.VioFrame, pb, profile: bool):
    """One warm run and one timed run of ``run_fleet`` over ``frames``
    ((T, B) leaves); with ``profile`` (on the card) the steps of
    PROFILE_WINDOW once more under torch.profiler, from the state the run
    reaches before them.  Returns the measurements."""
    T, B = frames.timestamp.shape[:2]
    cuda = frames.cam0.device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    fleet.run_fleet(config, frames, pb.gyro_bias, pb.acc_mean)
    sync()
    for group in (BATCHED, BACKEND):
        for fns in group.values():
            for fn in fns:
                fn.launches = 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    syncs0 = device.host_syncs["sync"]
    t0 = time.perf_counter()
    _, outs = fleet.run_fleet(config, frames, pb.gyro_bias, pb.acc_mean)
    sync()
    wall = time.perf_counter() - t0
    res = {"B": B, "steps": T, "seconds": wall, "instance_frames_per_s": T * B / wall,
           "host_syncs_per_step": (device.host_syncs["sync"] - syncs0) / T,
           "kernel_launches_per_step": {k: sum(fn.launches for fn in fns) / T
                                        for k, fns in BATCHED.items()},
           "backend_launches_per_step": {k: sum(fn.launches for fn in fns) / T
                                         for k, fns in BACKEND.items()},
           "active_instance_frames": int(outs.active.sum()),
           "finite": bool(torch.isfinite(outs.p).all())}
    if cuda:
        res["peak_device_bytes"] = torch.cuda.max_memory_allocated()
    if profile:
        a, b = PROFILE_WINDOW if T >= PROFILE_WINDOW[1] else (0, T)
        state, _ = fleet.run_fleet(config, vio.VioFrame(*(x[:a] for x in frames)), pb.gyro_bias,
                                   pb.acc_mean)
        sync()
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            fleet.run_fleet(config, vio.VioFrame(*(x[a:b] for x in frames)), pb.gyro_bias,
                            pb.acc_mean, state=state)
            sync()
        events = prof.key_averages()
        res["cuda_launches_per_step"] = sum(e.count for e in events
                                            if e.key in LAUNCH_CALLS) / (b - a)
        res["kernel_device_us_per_launch"], res["kernel_device_us_per_step"] = {}, {}
        for label, parts in KERNEL_NAMES.items():
            ev = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
                  and any(p in e.key for p in parts)]
            n, us = sum(e.count for e in ev), sum(e.self_device_time_total for e in ev)
            res["kernel_device_us_per_launch"][label] = us / n if n else None
            res["kernel_device_us_per_step"][label] = us / (b - a)
    return res


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("sizes", type=int, nargs="*", default=[1, 4, 8])
    parser.add_argument("--decorrelated", action="store_true")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    n_frames = int(os.environ.get("BENCH_FRAMES", "60"))
    stride = int(os.environ.get("FLEET_STRIDE", "7")) if args.decorrelated else 0

    dev = device.get_device(args.device)
    card = "cpu"
    if dev.type == "cuda":
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
        card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed"
    print(card)
    config, pb, cam0, cam1 = render(n_frames + stride * (max(args.sizes) - 1))
    stream = vio.frames_from_prebatch(pb, cam0, cam1, dev)
    mode = f"decorrelated(stride={stride})" if args.decorrelated else "broadcast"
    print(f"source=synthetic bench world T={n_frames} mode={mode} device={dev}")
    results = []
    for B in args.sizes:
        res = measure(config, fleet_frames(stream, n_frames, B, stride), pb,
                      profile=dev.type == "cuda")
        results.append(res)
        launches = res.get("cuda_launches_per_step", "not measured")
        print(f"B={B:3d}: {res['instance_frames_per_s']:9.2f} instance-frames/s aggregate, "
              f"{res['seconds'] / n_frames * 1e3:8.2f} ms/step, "
              f"{res['host_syncs_per_step']:.2f} host syncs/step, CUDA launches/step "
              f"{launches}, batched kernels' launches/step {res['kernel_launches_per_step']} "
              f"{res['backend_launches_per_step']}, device us/step "
              f"{res.get('kernel_device_us_per_step', 'not measured')}", flush=True)
    print(json.dumps({"card": card, "mode": mode, "frames": n_frames, "results": results}))


if __name__ == "__main__":
    main()
