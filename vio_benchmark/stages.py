"""The stage table of a cell: one traced run with the port's recorder on.

    python3 -m vio_benchmark.stages --workload <cell> --seed <n> --seconds <s> [--out <file.json>]

Runs the cell as ``run.py --trace 1`` does (``fleet_sweep.run_cell``), with
the port's recorder (``uav_airvision_tpu_torch.utils.profiling``) on from the
window's start to the end of the profiled sub-window.  Prints on standard
error, for each of the program's spans: host ms a step over the window,
calls a step, and over the profiled steps the device ms a step (the union of
the intervals of the operations whose launch call lies inside the span) and
the launches a step; each counter a step; and the device's idle gaps of the
profiled steps named by the innermost program span running at each gap's
middle.  The spans' device-side copies are left out of the profile's device
events, so the breakdown's busy time is the operations' alone.

The benchmark's own runs (``run.py``) leave the recorder off, and their
numbers do not come from here: with the recorder on, each span costs a few
microseconds of host time.  Exits with 2 without a CUDA device or where the
program has no recorder (an older tree).
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

for _var, _dir in (("TRITON_CACHE_DIR", "triton_cache"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[_var] = os.path.join(os.getcwd(), "build", _dir)


def log(*args):
    print(*args, file=sys.stderr, flush=True)


def recorded_run(fleet_sweep, *args, **kwargs):
    """``fleet_sweep.run_cell(*args, **kwargs)`` with the recorder on over
    the window and the profiled sub-window; returns (its result, {"window",
    "profiled", "device", "launches", "idle_by_span"}).  The profile's
    reduction is given every declared span's name, so their device-side
    copies are not counted as device work."""
    from uav_airvision_tpu_torch.profile_main import count_under
    from uav_airvision_tpu_torch.utils import profiling

    trace, stages = fleet_sweep.trace, {}
    reduce_profile, profile = trace.reduce_profile, fleet_sweep._profile

    def reduce(prof, span_labels=()):
        events = prof.events()
        stages["device"] = profiling.device_by_span(events)
        stages["launches"] = count_under(events, profiling.SPANS)
        red = reduce_profile(prof, tuple(span_labels) + tuple(profiling.SPANS))
        named = set(profiling.SPANS) | set(fleet_sweep.LAYER_SPANS)
        stages["idle_by_span"] = trace.idle_gaps(
            red["device"], [h for h in red["host"] if h[0] in named], fleet_sweep.LAYER_SPANS,
            top=len(named))
        return red

    def recorded_profile(*a, **k):
        stages["window"] = profiling.snapshot()
        profiling.reset()
        try:
            return profile(*a, **k)
        finally:
            stages["profiled"] = profiling.snapshot()
            profiling.disable()

    def start_recording(port):
        profiling.reset()
        profiling.enable()

    trace.reduce_profile, fleet_sweep._profile = reduce, recorded_profile
    try:
        res = fleet_sweep.run_cell(*args, fault=start_recording, **kwargs)
    finally:
        trace.reduce_profile, fleet_sweep._profile = reduce_profile, profile
        profiling.disable()
    stages.setdefault("window", profiling.snapshot())
    return res, stages


def table(stages: dict, steps: int, profile_steps: int) -> dict:
    """{"spans": {name: [host ms a step, calls a step, device ms a step,
    launches a step]}, "counters": {name: a step}}: host figures over the
    window's ``steps``, device figures over the ``profile_steps``."""
    window = stages["window"]
    device, launches = stages.get("device", {}), stages.get("launches", {})
    spans = {}
    for name in sorted(set(window["spans"]) | set(device)):
        host_s, calls = window["spans"].get(name, (0.0, 0))
        spans[name] = [1e3 * host_s / steps, calls / steps,
                       1e3 * device.get(name, (0.0, 0))[0] / profile_steps,
                       launches.get(name, (0, 0))[0] / profile_steps]
    return {"spans": spans,
            "counters": {k: v / steps for k, v in sorted(window["counters"].items())}}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--out")
    args = parser.parse_args(argv)

    import torch

    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        log("needs a CUDA device")
        return 2
    from uav_airvision_tpu_torch.utils import profiling

    if not hasattr(profiling, "SPANS"):
        log("the program has no recorder (no SPANS in its utils/profiling.py)")
        return 2

    from . import fleet_sweep
    from .yardstick import peaks, trace

    log(f"card: {peaks.card()}")
    res, stages = recorded_run(fleet_sweep, args.workload, args.seed, args.seconds, True, T_START)
    t = res["trace"]
    if t["profile"] is None:
        log("the window did not reach the later checked stretch, so nothing was profiled")
        return 1
    p = t["profile"]
    busy_ms = 1e3 * trace.busy_seconds(p["device"]) / p["steps"]
    tab = table(stages, t["steps"], p["steps"])
    log(f"window {t['steps']} steps; profiled {p['steps']} steps, device busy {busy_ms:.4f} ms a step; "
        f"correct {res['correct']}")
    log("span: host ms a step (window), calls a step, device ms a step, launches a step (profiled)")
    for name, (host, calls, dev, n) in tab["spans"].items():
        log(f"{name:24s} {host:9.4f} {calls:7.3f} {dev:8.4f} {n:8.2f}")
    log(f"counters a step: {json.dumps(tab['counters'])}")
    log(f"idle gaps by program span (s): {json.dumps(stages['idle_by_span'])}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"workload": args.workload, "seed": args.seed, "correct": res["correct"],
                       "steps": t["steps"], "profile_steps": p["steps"],
                       "device_busy_ms_per_step": busy_ms, **tab,
                       "idle_by_span": stages["idle_by_span"]}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
