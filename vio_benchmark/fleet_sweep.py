"""One run of a cell: the fleet sweep through the port, timed, traced and checked.

``run_cell`` builds the cell's inputs from the seed (``gen/``), sets up the
port's fleet (``uav_airvision_tpu_torch.parallel.fleet``), warms it up over
the sweep's first steps, then drives ``run_fleet`` over consecutive chunks of
the pre-assembled (S, B, ...) frame stack, carrying the state from chunk to
chunk and starting a fresh fleet state after the sweep's last step, with
``on_frame`` stamping each step's end.  The window holds whole sweeps: it
ends at the end of the first sweep that ends once ``seconds`` have passed,
with a ``torch.cuda.synchronize()``, so every run's window does the same
work a sweep (a sweep's first steps, its IMU initialisation, are the
lightest).  Untraced on the card, in a cell whose end-to-end metrics take
the device's time (``DEVICE_METRICS``), the whole window runs under the
profiler's device activity alone (``trace.DeviceBusy``, cut every
``SEGMENT_STEPS`` steps), for the device's busy seconds over all its work.
After it the outputs are read to the host,
and the output check runs the plain reference (``reference/``) on the CPU
over two stretches of the window's first sweep, for instances drawn from the
seed: the sweep's start from the reference's own initial state, and a later
stretch (a full window, in motion) from the program's state at its start,
its front-end on its own and its back-end fed the program's features.

With ``trace`` the window times the front-end's and the back-end's host
spans (``frontend_step_fleet`` and ``backend_step_fleet`` rebound in
``models.vio``); after it, ``profile_steps`` steps from the later checked
stretch's start (a full window, prunes and updates) run once more from the
window's state there, under torch.profiler, with K2's and K11's calls
recorded for their rooflines.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import sys
import time

import numpy as np
import torch

from . import registry
from .gen import traffic
from .reference import check as ref_check
from .reference import compare as ref_compare
from .yardstick import ate, peaks, trace, work

FORBIDDEN = ("jax", "jaxlib", "flax", "uav_airvision_tpu")
LAYER_SPANS = ("frontend_step_fleet", "backend_step_fleet")
SEGMENT_STEPS = 60  # steps of one device-activity profile of the window
DEVICE_METRICS = ("device_frames_per_s",)


def numbers_of(parts: dict) -> dict:
    """Every number of the checked stretches: the filter's of each stretch
    (the later one's from the back-end fed the program's features) and the
    front-end's, pooled over both.  The cell's limits file names those that
    are compared; the others are printed."""
    out = {}
    for key in ("start", "mid"):
        out[f"pose_gap_{key}_m"] = parts[key]["filter"]["pose_gap_m"]
        out[f"cov_gap_{key}"] = parts[key]["filter"]["cov_gap_rel"]
    out.update(ref_compare.feature_numbers([parts[key]["features"] for key in ("start", "mid")]))
    return out


def log(*args):
    print(*args, file=sys.stderr, flush=True)


def host_probe_ms(repeats=3, n=200_000):
    """The host's speed: the fastest of ``repeats`` runs of a fixed loop of
    Python arithmetic, in ms (read beside the window, outside it)."""
    best = math.inf
    for _ in range(repeats):
        t0 = time.perf_counter()
        x = 0
        for i in range(n):
            x += i * i
        best = min(best, time.perf_counter() - t0)
    return 1e3 * best


def forbidden_modules():
    """Loaded modules whose top-level name is one the run may not load."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def export_state(tree):
    """A port state tree as plain data on the CPU (the reference's
    ``import_state`` rebuilds it in its own types)."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return {"type": type(tree).__name__, "fields": [export_state(x) for x in tree]}
    if type(tree).__name__ == "Pyramid":
        d = {f.name: getattr(tree, f.name) for f in dataclasses.fields(tree)
             if not f.name.startswith("_")}
        d["flat"] = d["flat"].cpu()
        return {"pyramid": d}
    if isinstance(tree, torch.Tensor):
        return tree.cpu()
    if isinstance(tree, (list, tuple)):
        return [export_state(x) for x in tree]
    return tree


def clone_state(tree):
    """A copy of every tensor of a port state tree (pyramids included)."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(clone_state(x) for x in tree))
    if type(tree).__name__ == "Pyramid":
        return dataclasses.replace(tree, flat=tree.flat.clone(), _levels=None)
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    return tree


def draw_checks(mix: dict, labels, seed: int):
    """The check's sample, from the seed: the start stretch's instances (one
    of each preset while presets remain), the later stretch's first step (a
    chunk boundary) and its instances, the heaviest preset among them."""
    chk = mix["check"]
    rng = np.random.default_rng(traffic.sub_seed(seed, 9))
    B = len(labels)
    order = ["difficult", "medium", "easy"]
    presets = [p for p in order if any(lab[0] == p for lab in labels)]

    def pick(n):
        chosen = []
        for p in presets:
            if len(chosen) < n:
                pool = [b for b, lab in enumerate(labels) if lab[0] == p and b not in chosen]
                chosen.append(int(rng.choice(pool)))
        rest = [b for b in range(B) if b not in chosen]
        chosen += [int(x) for x in rng.choice(rest, min(n - len(chosen), len(rest)),
                                                replace=False)] if len(chosen) < n else []
        return sorted(chosen)

    C = int(mix["chunk_steps"])
    firsts = list(range(int(chk["mid_first"]), int(chk["mid_last"]) + 1, C))
    return {"start": (0, int(chk["start_steps"]), pick(int(chk["start_instances"]))),
            "mid": (int(rng.choice(firsts)), int(chk["mid_steps"]),
                    pick(int(chk["mid_instances"])))}


def _port():
    from uav_airvision_tpu_torch import device as pdevice
    from uav_airvision_tpu_torch import kernels as pkernels
    from uav_airvision_tpu_torch.config import Config
    from uav_airvision_tpu_torch.models import vio as pvio
    from uav_airvision_tpu_torch.models.msckf import step as pstep
    from uav_airvision_tpu_torch.ops import pyramid as ppyramid
    from uav_airvision_tpu_torch.parallel import fleet as pfleet
    from uav_airvision_tpu_torch.utils import tree as ptree

    return dict(device=pdevice, kernels=pkernels, Config=Config, vio=pvio, step=pstep,
                pyramid=ppyramid, fleet=pfleet, tree=ptree)


def run_cell(workload: str, seed: int, seconds: float, traced: bool, t_start: float,
             device: str = "cuda", search=(), bench_path="BENCHMARK.json", fault=None,
             control=False, device_busy=None):
    """One run; returns its result: set-up phases, window, counts, the
    checked numbers beside their limits, ``correct`` and, traced, the trace
    records the per-layer readers take.  ``t_start`` is the process's start
    on the host clock (set-up counts from it).  ``fault``,
    if given, is called with the port's modules before the window, to break
    the timed path (the harness's own tests); ``control`` runs the check's
    control (the reference in TF32) beside the reference and returns its
    numbers too.  ``device_busy`` (default: untraced on the card, where an
    end-to-end metric of the cell is one of ``DEVICE_METRICS``) profiles the
    window's device activity for its busy seconds."""
    bench = registry.load_benchmark(bench_path)
    cell, conf_entry = registry.cell(bench, workload)
    conf = registry.load_config(cell["config"], search)
    mix = registry.load_traffic(cell["traffic"], search)
    limits = registry.load_limits(workload, search)
    cuda = device == "cuda"
    if device_busy is None:
        device_busy = cuda and not traced and any(
            m["name"] in DEVICE_METRICS for m in registry.metrics_of(bench, workload, "end_to_end"))
    phases = {}

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def phase(name, t0):
        sync()
        phases[name] = time.perf_counter() - t0

    t0 = time.perf_counter()
    port = _port()
    phases["import"] = t0 - t_start + time.perf_counter() - t0
    t0 = time.perf_counter()
    dev = port["device"].get_device(device)
    torch.empty(1, device=dev)
    phase("cuda_context", t0)
    t0 = time.perf_counter()
    if cuda:
        port["kernels"].lib()
    phase("kernel_library", t0)

    config = port["Config"].from_json(json.dumps(conf["config"]))
    inputs = traffic.generate(mix, conf["config"], seed, dev, sync)
    phases.update(inputs.phases)
    vio, fleet = port["vio"], port["fleet"]
    frames = vio.VioFrame(**inputs.frames)
    S, B, C = inputs.steps, inputs.batch, int(mix["chunk_steps"])

    def span(k0, k1):
        return vio.VioFrame(*(x[k0:k1] for x in frames))

    t0 = time.perf_counter()
    state0 = fleet.init_fleet_state(config, inputs.gyro_bias, inputs.acc_mean, B, dev)
    phase("init_state", t0)
    t0 = time.perf_counter()
    warm = clone_state(state0)
    for k0 in range(0, int(mix["warmup_steps"]), C):
        warm, _ = fleet.run_fleet(config, span(k0, min(k0 + C, S)), inputs.gyro_bias,
                                  inputs.acc_mean, state=warm)
    del warm
    phase("warmup", t0)

    checks = draw_checks(mix, inputs.labels, seed)
    boundaries = {checks["start"][1]: None, checks["mid"][0]: None,
                  checks["mid"][0] + checks["mid"][1]: None}
    watched = set(range(checks["start"][1])) | set(range(checks["mid"][0],
                                                         checks["mid"][0] + checks["mid"][1]))
    published = {}
    spans = trace.Spans()
    if traced:
        for name in LAYER_SPANS:
            spans.wrap(vio, name, name)
    if fault is not None:
        fault(port)
    syncs = port["device"].host_syncs
    stamps, outs = [], []
    pos = {"step": 0, "sweep": 0}

    def on_frame(k, fe, out):
        stamps.append(time.perf_counter())
        g = pos["step"] + k
        if pos["sweep"] == 0 and g in watched:
            published[g] = {"ids": fe.ids, "uv": fe.uv, "mask": fe.mask, "p": out.p, "q": out.q,
                            "active": out.active}

    gc.collect()
    gc.freeze()  # the set-up's objects out of the collector's way in the window
    setup_s = time.perf_counter() - t_start
    busy = trace.DeviceBusy(skip=LAYER_SPANS) if device_busy else None
    if busy is not None:  # the profiler's first start, the harness's own, before the window
        t0 = time.perf_counter()
        busy.start()
        torch.ones(1, device=dev).add_(1)
        busy.stop()
        busy.read()
        phases["profiler_start_not_setup"] = time.perf_counter() - t0
    probe_before = host_probe_ms()
    sync()
    syncs0 = syncs["sync"]
    proc0 = time.process_time()
    if busy is not None:
        busy.start()
    t_win = time.perf_counter()
    stamps.append(t_win)
    state = state0
    steps = seg = 0
    while True:
        k0 = pos["step"]
        k1 = min(k0 + C, S)
        state, out = fleet.run_fleet(config, span(k0, k1), inputs.gyro_bias, inputs.acc_mean,
                                     state=state, on_frame=on_frame)
        outs.append((pos["sweep"], k0, out.p, out.q, out.active))
        steps += k1 - k0
        seg += k1 - k0
        pos["step"] = k1
        if pos["sweep"] == 0 and k1 in boundaries:
            boundaries[k1] = clone_state(state)
        if k1 >= S:
            if time.perf_counter() - t_win >= seconds:
                break
            pos["step"], pos["sweep"] = 0, pos["sweep"] + 1
            state = fleet.init_fleet_state(config, inputs.gyro_bias, inputs.acc_mean, B, dev)
        if busy is not None and seg >= SEGMENT_STEPS:
            sync()
            busy.cut()
            seg = 0
    sync()
    if busy is not None:
        busy.stop()
    window_s = time.perf_counter() - t_win
    proc_s = time.process_time() - proc0
    gc.unfreeze()
    host_syncs = syncs["sync"] - syncs0
    step_s = np.diff(np.asarray(stamps)).tolist()
    spans.restore()
    memory_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    device_busy_s = None
    if busy is not None:
        device_busy_s, counts = busy.read()
        segs = [c / SEGMENT_STEPS for c in counts[:-1]]
        log(f"device busy {device_busy_s:.6f} s over {len(counts)} profiles of the window, "
            f"{sum(counts)} device events")

    profile = None
    if traced:
        k0 = checks["mid"][0]
        if boundaries.get(k0) is not None:
            profile = _profile(port, config, clone_state(boundaries[k0]), span(k0, k0 + int(
                mix["profile_steps"])), inputs, cuda)

    # the outputs, read once the window has closed
    attempted, failed = steps * B, 0
    first = [[] for _ in range(S)]
    for sweep, k0, p, q, act in outs:
        act = act.cpu().bool()
        fin = torch.isfinite(p.cpu()).all(-1) & torch.isfinite(q.cpu()).all(-1)
        failed += int((act & ~fin).sum())
        if sweep == 0:
            for j in range(p.shape[0]):
                first[k0 + j] = (p[j].cpu().numpy(), act[j].numpy())
    info = {"sweeps": pos["sweep"] + 1, "steps": steps, "window_s": window_s,
            "host_probe_ms": [probe_before, host_probe_ms()],
            "longest_steps_ms": [1e3 * x for x in sorted(step_s)[-3:]],
            "process_cpu_share": proc_s / window_s}
    if busy is not None:
        info.update(device_busy_s=device_busy_s, device_events=sum(counts),
                    device_events_per_step=[min(segs, default=0), max(segs, default=0)],
                    wall_frames_per_s_profiled=steps * B / window_s)
    if all(len(x) for x in first):
        info["ate_rmse_m_first_sweep"] = _ate(first, inputs, float(mix["fps"]))

    parts, control_parts = _check(conf["config"], checks, published, boundaries, frames, inputs,
                                  port, control)
    numbers = numbers_of(parts)
    numbers["nonfinite_poses"] = failed
    control_numbers = numbers_of(control_parts) if control_parts else None
    del state, state0, boundaries, published, frames

    bad = forbidden_modules()
    if bad:
        raise SystemExit(f"modules that the run may not load are loaded: {bad}")

    checked = {name: {"value": numbers.get(name, math.inf), "limit": lim}
               for name, lim in limits.items()}
    info.update({k: v for k, v in numbers.items() if k not in checked})
    correct = bool(checked) and all(v["value"] <= v["limit"] for v in checked.values())

    result = {"phases": phases, "info": info, "setup_s": setup_s, "window_s": window_s,
              "instance_frames": steps * B, "attempted": attempted, "failed": failed,
              "device_busy_s": device_busy_s,
              "memory_peak_bytes": memory_peak, "correct": correct, "checked": checked,
              "control": control_numbers,
              "trace": None if not traced else {
                  "steps": steps, "step_s": step_s, "host_syncs": host_syncs,
                  "instance_frames": steps * B, "window_s": window_s,
                  "span_s": dict(spans.seconds), "profile": profile}}
    return result


def _profile(port, config, state, frames, inputs, cuda):
    """The profiled sub-window: the steps of ``frames`` once more from
    ``state`` (the window's state at the later checked stretch's start: a
    full window, prunes and updates), under torch.profiler, K2's and K11's
    calls recorded."""
    vio, fleet = port["vio"], port["fleet"]
    k2, k11 = [], []

    def on_k2(cam0, cam1, levels, pad=17):
        n = cam0.shape[0] if cam0.dim() == 3 else 1
        k2.append(work.k2_work(n, cam0.shape[-2], cam0.shape[-1], levels + 1, pad))

    def on_k11(st, params, H_buf, r_buf, rows_true, upd, upd_mask):
        rows = [rows_true[b] for b, u in enumerate(upd) if u]
        if rows:
            k11.append(work.k11_work(st.cov.shape[-1], st.cov.element_size(),
                                     st.cams.q.shape[-2], H_buf.shape[1], rows))

    spans = trace.Spans()
    for name in LAYER_SPANS:
        spans.wrap(vio, name, name)
    spans.record(port["pyramid"], "build_pyramid_pair", on_k2)
    spans.record(port["step"], "apply_update_fleet", on_k11)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    try:
        if cuda:
            torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            fleet.run_fleet(config, frames, inputs.gyro_bias, inputs.acc_mean, state=state)
            if cuda:
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        spans.restore()
    red = trace.reduce_profile(prof, LAYER_SPANS)
    red.update(window_s=wall, steps=int(frames.timestamp.shape[0]), k2_calls=k2, k11_calls=k11)
    return red


def _ate(first, inputs, fps):
    """ATE rmse (aligned) of each instance over the first sweep's active
    frames: the largest of the instances (printed, not compared)."""
    fts = np.arange(inputs.steps) / fps
    worst = 0.0
    for b in range(inputs.batch):
        act = np.array([first[k][1][b] for k in range(inputs.steps)])
        if act.sum() < 3:
            continue
        p = np.stack([first[k][0][b] for k in range(inputs.steps)])[act]
        r = ate.ate(fts[act], p, fts[act], inputs.groundtruth[act, b])["rmse"]
        worst = max(worst, r) if math.isfinite(r) else math.inf
    return worst


def _select(pub, idx):
    return {k: v[idx].cpu() for k, v in pub.items()}


def _check(conf, checks, published, boundaries, frames, inputs, port, control):
    """The output check's readings by stretch (and, with ``control``, its
    control's): each checked stretch's published outputs and end state
    against the reference's on the same frames."""
    take = port["tree"].take
    focal = float(conf["calib"]["cam0_intrinsics"][0])
    parts, cparts = {}, {}
    threads = torch.get_num_threads()
    torch.set_num_threads(min(8, os.cpu_count() or 1))
    try:
        for key in ("start", "mid"):
            k0, n, idx = checks[key]
            if any(k not in published for k in range(k0, k0 + n)) or boundaries.get(k0 + n) is None:
                parts[key] = {"features": {"gaps": [], "diff": 0, "either": 0},
                              "filter": {"pose_gap_m": math.inf, "cov_gap_rel": math.inf}}
                log(f"check: the window did not reach steps {k0}-{k0 + n} of the first sweep")
                continue
            it = torch.as_tensor(idx)
            fr = {f: getattr(frames, f)[k0:k0 + n][:, it.to(frames.cam0.device)].cpu()
                  for f in frames._fields}
            prog = {f: torch.stack([published[k][f][it.to(published[k][f].device)].cpu()
                                    for k in range(k0, k0 + n)]) for f in published[k0]}
            end = take(boundaries[k0 + n], idx)
            prog_end = {"p": end.filter.imu.p.cpu(), "cov": end.filter.cov.cpu()}
            gb, am = inputs.gyro_bias[idx], inputs.acc_mean[idx]
            t0 = time.perf_counter()
            if key == "start":
                def reference(ctl):
                    pub, pub_end = ref_check.run_steps(conf, fr, gb, am, control=ctl)
                    return pub, pub, pub_end
            else:
                start = export_state(take(boundaries[k0], idx))
                prev = {c: getattr(frames, c)[k0 - 1][it.to(frames.cam0.device)].cpu()
                        for c in ("cam0", "cam1")}

                def reference(ctl):
                    return ref_check.run_split(conf, prev, fr, prog, start, control=ctl)
            ref_fe, ref_be, ref_end = reference(False)
            parts[key] = {"features": ref_compare.compare_features(prog, ref_fe, focal),
                          "filter": ref_compare.compare_filter(prog, ref_be, prog_end, ref_end)}
            log(f"check {key}: steps {k0}-{k0 + n}, instances {idx}: {_said(parts[key])} "
                f"(reference {time.perf_counter() - t0:.1f} s)")
            if control:
                ctl_fe, ctl_be, ctl_end = reference(True)
                cparts[key] = {"features": ref_compare.compare_features(ctl_fe, ref_fe, focal),
                               "filter": ref_compare.compare_filter(ctl_be, ref_be, ctl_end,
                                                                    ref_end)}
                log(f"control {key}: {_said(cparts[key])}")
    finally:
        torch.set_num_threads(threads)
    return parts, cparts


def _said(part):
    f = part["features"]
    return {**part["filter"], "features_matched": len(f["gaps"]),
            "feature_gap_p90_px": ref_compare.quantile(f["gaps"], 0.9),
            "feature_gap_max_px": max(f["gaps"], default=math.inf),
            "feature_set_diff": f["diff"] / f["either"] if f["either"] else math.inf}
