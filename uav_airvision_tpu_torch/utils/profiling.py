"""Tracing / profiling utilities: the port's counterpart of
uav_airvision_tpu/utils/profiling.py.  ``StageTimer`` is its copy;
``device_trace`` and ``annotate`` stand on ``torch.profiler`` where the JAX
package's stand on ``jax.profiler``.

Replaces the reference's ad-hoc per-stage ``print(time.time()-t)`` lines
(reference src/msckf.py:184-223) with structured stage timers and profiler
trace hooks.  Device-side stage counters come back through StepOutput /
FrontendOutput fields rather than host prints.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict


class StageTimer:
    """Accumulating wall-clock stage timer with a one-line JSON report."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1

    def report(self):
        return {
            name: dict(
                total_s=round(self.totals[name], 4),
                count=self.counts[name],
                mean_ms=round(1000 * self.totals[name] / max(self.counts[name], 1), 3),
            )
            for name in self.totals
        }

    def dump(self, path=None):
        s = json.dumps(self.report(), indent=2)
        if path:
            with open(path, "w") as f:
                f.write(s)
        return s


TRACE_FILE = "trace.json"


@contextlib.contextmanager
def device_trace(log_dir, device="cuda"):
    """``torch.profiler`` over the block, CPU activity and, on the card, CUDA
    activity; writes a Chrome trace (chrome://tracing, Perfetto) to
    ``log_dir/trace.json`` when the block ends."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


def annotate(name):
    """Named region inside a traced run (a span in the trace)."""
    from torch.profiler import record_function

    return record_function(name)
