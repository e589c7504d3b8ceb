"""Tracing / profiling utilities: the port's counterpart of
uav_airvision_tpu/utils/profiling.py.  ``StageTimer`` is its copy;
``device_trace`` stands on ``torch.profiler`` where the JAX package's stands
on ``jax.profiler``.

Replaces the reference's ad-hoc per-stage ``print(time.time()-t)`` lines
(reference src/msckf.py:184-223) with structured stage timers and profiler
trace hooks.  Device-side stage counters come back through StepOutput /
FrontendOutput fields rather than host prints.

The recorder: the port marks its stages where the work happens, with
``span(name)`` around a stage and ``count(name, n)`` for the work it did,
under the names declared in ``SPANS`` and ``COUNTERS``.  It is off until
``enable()``: a span is then one flag check and a shared no-op, a count one
flag check, and neither calls into torch.  On, a span keeps ``(step, name,
parent, t0_ns, t1_ns)`` on the host clock (``time.perf_counter_ns``) and,
while a torch profiler runs, runs under ``torch.profiler.record_function(name)``,
so that it sits on the device trace's own clock with the kernels it launched
below it (``device_by_span``); without a profiler that scope would record
nothing and costs ~10 us, so it is left out.  A counter is fed only host values the step already
holds (Python ints), never a device tensor.  ``snapshot()`` sums both.  The
recorder keeps one thread's nesting: the port's runners step on one thread.
"""

from __future__ import annotations

import collections
import contextlib
import json
import numbers
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


# ---------------------------------------------------------------------------
# The recorder's names: every span and counter the port records, and what it
# covers (kernels by their number in PERF.md's table).
# ---------------------------------------------------------------------------

# Host reads (``device.to_host(t, site)``): each runs under the span
# ``sync.<site>``, the host's wait for the device to drain, and counts
# ``sync.<site>``.
SYNC_SITES = {
    "fleet.active": "run_fleet / make_fleet_step: the frames' active flags",
    "run.active": "run_sequence: the frames' active flags",
    "fe.seed_trust": "front-end: the seed counts of the starvation recovery",
    "be.candidates": "back-end: lost candidates and window counts",
    "be.lost_update": "back-end: a lost pass's updates, rows and overflow",
    "be.prune_two_view": "back-end: the prune's two-view counts",
    "be.prune_update": "back-end: the prune's updates",
    "be.reset": "back-end, single stream: the online reset's decision",
    "compat.features": "callback facade: a frame's published features",
    "compat.pose": "callback facade: a frame's pose",
}

STEP_SPAN = "fleet.step"  # a record's step counts these spans entered

SPANS = {
    "fleet.init": "init_fleet_state: each instance's initial state, stacked",
    "fleet.step": "run_fleet: one step of the fleet (front-end, then back-end)",
    "frontend": "the front-end layer (frontend_step_fleet)",
    "fe.pyramid": "both cameras' pyramids (K2)",
    "fe.first_frame": "the first-frame branch: detection, stereo, ranking (K4+K6, K5, K1, K7, K8)",
    "fe.predict": "the IMU-rotation prediction of a tracked frame (K7)",
    "fe.track": "temporal LK (K1) and its bounds check",
    "fe.detect": "FAST, the detection mask and the per-cell top-k (K4+K6, K5)",
    "fe.stereo": "stereo seeds, stereo LK and its gate (K7, K1)",
    "fe.select": "the per-cell selection (K8)",
    "fe.publish": "the undistorted publish (K7)",
    "backend": "the back-end layer (backend_step_fleet, backend_step)",
    "be.subset": "gathers and scatters of the instances a stage runs on; inactive skip rows",
    "be.propagate": "IMU propagation (K14)",
    "be.augment": "state augmentation",
    "be.observe": "the observation upsert and the lost candidates' count",
    "be.lost": "lost-feature marginalization, both passes",
    "be.lost.triangulate": "the lost pass's triangulation (K13)",
    "be.lost.jacobian": "the lost pass's Jacobian blocks (K9)",
    "be.lost.gate": "the lost pass's chi-square gate (K10)",
    "be.lost.stack": "the lost pass's row cap and stacked buffer, its read",
    "be.lost.update": "the lost pass's EKF update (K11)",
    "be.prune": "the camera-pair prune",
    "be.prune.redundant": "the two cameras to remove, the two-view features, their count",
    "be.prune.triangulate": "the prune's triangulation (K13)",
    "be.prune.jacobian": "the prune's Jacobian blocks (K9) in the two cameras' columns",
    "be.prune.gate": "the prune's chi-square gate (K10)",
    "be.prune.update": "the prune's update (K12, or K11 on the stacked buffer), its read",
    "be.prune.compact": "the window's compaction after the prune",
    "be.reset": "the online reset",
    **{f"sync.{site}": f"host read: {what}" for site, what in SYNC_SITES.items()},
}

COUNTERS = {
    "k11.updates.T1": "K11 instance-updates on the T1 row tier",
    "k11.updates.T2": "K11 instance-updates on the T2 row tier",
    "k11.updates.QR": "K11 instance-updates past T2 (QR first)",
    "k11.updates.all": "K11 instance-updates of every row of a buffer no taller than T2",
    "k11.rows": "true rows of K11's instance-updates, summed",
    "k12.updates": "K12 instance-updates (the rank-12 prune)",
    "be.lost.instances": "instances in a first lost pass",
    "be.lost.second_pass": "instances in an overflow (second) lost pass",
    "be.prune.instances": "instances in a prune",
    "be.subset.gathers": "stages that gathered and scattered because only some instances ran",
    "fe.stereo_unseeded": "instances in the front-end's starvation recovery",
    **{f"sync.{site}": f"host reads: {what}" for site, what in SYNC_SITES.items()},
}


class _Span:
    __slots__ = ("rec", "name", "parent", "t0", "scope")

    def __init__(self, rec, name):
        self.rec, self.name = rec, name

    def __enter__(self):
        import torch

        rec = self.rec
        if self.name == STEP_SPAN:
            rec.step += 1
        self.parent = rec.stack[-1] if rec.stack else None
        rec.stack.append(self.name)
        self.scope = None
        if torch._C._autograd._profiler_enabled():  # a profiler is running
            self.scope = torch.profiler.record_function(self.name)
            self.scope.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        if self.scope is not None:
            self.scope.__exit__(*exc)
        rec = self.rec
        rec.stack.pop()
        rec.records.append((rec.step, self.name, self.parent, self.t0, t1))
        return False


class Recorder:
    """The spans and counters of a run; off until ``on`` is set."""

    def __init__(self):
        self.on = False
        self.reset()

    def reset(self):
        self.records = []  # (step, name, parent, t0_ns, t1_ns)
        self.counters = collections.Counter()
        self.stack = []
        self.step = 0

    def span(self, name):
        if name not in SPANS:
            raise KeyError(f"undeclared span {name!r}")
        return _Span(self, name)

    def count(self, name, n):
        if name not in COUNTERS:
            raise KeyError(f"undeclared counter {name!r}")
        if not isinstance(n, numbers.Integral):  # a device tensor would make it a host read
            raise TypeError(f"counter {name!r} takes a host int, got {type(n).__name__}")
        self.counters[name] += int(n)

    def snapshot(self) -> dict:
        """{"spans": {name: [seconds, calls]}, "counters": {name: total}}."""
        spans = {}
        for _, name, _, t0, t1 in self.records:
            s = spans.setdefault(name, [0.0, 0])
            s[0] += (t1 - t0) / 1e9
            s[1] += 1
        return {"spans": spans, "counters": dict(self.counters)}


RECORDER = Recorder()
_OFF = contextlib.nullcontext()


def span(name: str):
    """The stage ``name`` (declared in ``SPANS``) as a context manager: a
    shared no-op while the recorder is off."""
    if not RECORDER.on:
        return _OFF
    return RECORDER.span(name)


def count(name: str, n: int = 1) -> None:
    """Add the host int ``n`` to the counter ``name`` (declared in
    ``COUNTERS``) while the recorder is on."""
    if RECORDER.on:
        RECORDER.count(name, n)


def enabled() -> bool:
    return RECORDER.on


def enable() -> None:
    RECORDER.on = True


def disable() -> None:
    RECORDER.on = False


def reset() -> None:
    RECORDER.reset()


def snapshot() -> dict:
    return RECORDER.snapshot()


@contextlib.contextmanager
def recording():
    """The recorder on over the block, from a reset, and off after it."""
    reset()
    enable()
    try:
        yield RECORDER
    finally:
        disable()


def records() -> list:
    """The spans recorded since the last ``reset()``: (step, name, parent,
    t0_ns, t1_ns), in the order they ended."""
    return list(RECORDER.records)


def device_by_span(events, names=SPANS) -> dict:
    """{span: [device seconds, device operations]} from a finished
    torch.profiler profile's ``events()``: each device operation is given to
    every span in ``names`` whose host interval holds the runtime call that
    launched it (``cuda*`` or ``cu*``, the call with the operation's
    correlation id), and a span's device seconds are the union of its
    operations' intervals.  The spans' own device-side copies are left out;
    device operations without a recorded launching call go to
    ``"(unattributed)"``."""
    import bisect

    import torch

    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    spans = collections.defaultdict(list)
    launched_at = {}
    for e in events:
        if e.device_type == cpu:
            if e.name in names:
                spans[e.name].append((e.time_range.start, e.time_range.end))
            elif e.name.startswith("cu"):
                launched_at[e.id] = e.time_range.start
    starts = {n: sorted(iv) for n, iv in spans.items()}  # one name's spans never overlap
    keys = {n: [a for a, _ in iv] for n, iv in starts.items()}

    def owners(t):
        out = []
        for n, iv in starts.items():
            i = bisect.bisect_right(keys[n], t) - 1
            if i >= 0 and iv[i][1] >= t:
                out.append(n)
        return out

    intervals = collections.defaultdict(list)
    for e in events:
        if e.device_type != cuda or e.name in names or getattr(e, "is_user_annotation", False):
            continue
        t = launched_at.get(e.id)
        for n in owners(t) if t is not None else ["(unattributed)"]:
            intervals[n].append((e.time_range.start, e.time_range.end))
    out = {}
    for name, iv in intervals.items():
        merged = []
        for a, b in sorted(iv):
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        out[name] = [sum(b - a for a, b in merged) / 1e6, len(iv)]
    return out
