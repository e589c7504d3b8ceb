"""The port's benchmark: one run of one cell.

    python3 -m vio_benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout, which holds ``BENCHMARK.json``.  The cell's
configuration, traffic mix and limits are found by name (``registry.py``);
``fleet_sweep.run_cell`` runs it on the card.  Prints each set-up phase, the
run's information and the metrics on standard error, the numbers the output
check compared beside their limits as its last lines, and one JSON object as
the last line of standard output: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics with ``--trace 0``, its per-layer
metrics with ``--trace 1``), ``device`` and, traced, ``breakdown``; the
compared numbers last, under ``checked``.  Without a CUDA device, or with
fewer than the cell asks for, it prints no result and exits with 2.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

# every build and kernel cache inside the checkout, at fixed paths
for _var, _dir in (("TRITON_CACHE_DIR", "triton_cache"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[_var] = os.path.join(os.getcwd(), "build", _dir)


def log(*args):
    print(*args, file=sys.stderr, flush=True)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    parser.add_argument("--control", action="store_true",
                        help="also run the output check's control (the reference in TF32)")
    args = parser.parse_args(argv)

    import torch

    torch.set_num_threads(1)  # the program's host work is one thread; the check takes more

    from . import fleet_sweep, registry
    from .yardstick import peaks, trace

    bench = registry.load_benchmark("BENCHMARK.json")
    cell, _ = registry.cell(bench, args.workload)
    chips = int(cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"this cell needs {chips} CUDA device(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    card = peaks.card()
    log(f"card: {card}")
    res = fleet_sweep.run_cell(args.workload, args.seed, args.seconds, bool(args.trace), T_START,
                               control=args.control)
    for name, s in res["phases"].items():
        log(f"setup {name}: {s:.3f} s")
    log(f"info: {json.dumps(res['info'])}")
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
              "memory_peak_bytes": int(res["memory_peak_bytes"])}
    metrics, breakdown = {}, None
    if not args.trace:
        values = {"setup_s": res["setup_s"]}
        if res["device_busy_s"] is None:  # a window the profiler did not slow
            values["sweep_frames_per_s"] = res["instance_frames"] / res["window_s"]
        elif res["device_busy_s"] > 0:
            values["device_frames_per_s"] = res["instance_frames"] / res["device_busy_s"]
        for m in registry.metrics_of(bench, args.workload, "end_to_end"):
            if m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        t = res["trace"]
        gaps = sorted(t["step_s"])
        log(f"step ms median {1e3 * gaps[len(gaps) // 2]:.3f} over {len(gaps)} steps")
        for m in registry.metrics_of(bench, args.workload, "per_layer"):
            value = registry.load_reader(m["name"])(t)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        p = t["profile"]
        if p is None:
            log("the window did not reach the later checked stretch, so nothing was profiled")
            return 1
        device["busy_s"] = trace.busy_seconds(p["device"])
        device["window_s"] = p["window_s"]
        breakdown = {"device_ops": trace.device_ops(p["device"]),
                     "idle_gaps": trace.idle_gaps(p["device"], p["host"],
                                                  fleet_sweep.LAYER_SPANS)}
        log(f"breakdown: {json.dumps(breakdown)}")
    for name, m in metrics.items():
        log(f"metric {name}: {m['value']} {m['unit']}")
    if res["control"] is not None:
        log(f"control: {json.dumps(res['control'])}")
    line = {"correct": res["correct"], "attempted": res["attempted"], "failed": res["failed"],
            "metrics": metrics, "device": device, "card": card}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checked"] = {name: {k: (x if x is None or math.isfinite(x) else str(x))
                              for k, x in v.items()} for name, v in res["checked"].items()}
    for name, v in res["checked"].items():
        log(f"check {name}: {v['value']} limit {v['limit']}")
    bad = fleet_sweep.forbidden_modules()
    if bad:
        log(f"modules that the run may not load are loaded: {bad}")
        return 1
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
