"""The readings that a cell's limits are set from: the output check's numbers
on many seeds, and its control's (the reference one precision step down, in
the program's place) on some of them, in one process.

    python3 -m vio_benchmark.readings --workload <cell> --seconds 8 \
        --seeds <n> ... [--control-seeds <n> ...] [--out <file.jsonl>]

Each seed is a whole run of the cell at its own size (inputs, set-up, a
window long enough to reach the checked stretches, the check), without the
process start; one JSON line a seed: ``correct``, every number compared and
printed, and the control's numbers where asked.  The benchmark's own runs
do not run the control.
"""

import argparse
import gc
import json
import math
import os
import sys
import time

for _var, _dir in (("TRITON_CACHE_DIR", "triton_cache"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[_var] = os.path.join(os.getcwd(), "build", _dir)


def _plain(x):
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, float) and not math.isfinite(x):
        return str(x)
    return x


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--control-seeds", type=int, nargs="*", default=[])
    parser.add_argument("--out")
    args = parser.parse_args(argv)

    import torch

    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    from . import fleet_sweep

    out = open(args.out, "a") if args.out else None
    for seed in args.seeds:
        res = fleet_sweep.run_cell(args.workload, seed, args.seconds, False, time.perf_counter(),
                                   control=seed in args.control_seeds)
        line = {"workload": args.workload, "seed": seed, "correct": res["correct"],
                "checked": res["checked"], "control": res["control"],
                "frames_per_s": res["instance_frames"] / res["window_s"], "info": res["info"]}
        text = json.dumps(_plain(line))
        print(text, flush=True)
        if out:
            out.write(text + "\n")
            out.flush()
        del res
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
