"""Host spans, and the reduction of a torch.profiler trace to plain records.

``LAUNCH_CALLS`` and the span wrapper are frozen from
uav_airvision_tpu_torch/profile_main.py (``LAUNCH_CALLS``,
``span_functions``) at commit efd1109; the span wrapper here also sums each
span's host seconds.  ``reduce_profile`` turns a profile into the records
the per-layer readers take (``vio_benchmark/metrics/``), so a reader never
sees torch's event types:

- ``device``: [(name, start_us, end_us)] of every operation that ran on the
  device (kernels, copies, sets), the spans' device-side copies left out;
- ``host``: [(name, start_us, end_us)] of the profiled thread's host events;
- ``launches``: the kernel launch calls (``cudaLaunchKernel`` and its kin, ``cuLaunchKernel``).

``DeviceBusy`` takes the device's busy seconds over a whole window from the
profiler's device activity alone, in segments.
"""

from __future__ import annotations

import bisect
import collections
import functools
import re
import time

import numpy as np

LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
                "cudaLaunchCooperativeKernel")

_FN = re.compile(r"::([A-Za-z_][A-Za-z0-9_]*)\s*[<(]")


def kernel_name(key: str) -> str:
    """A device event's function name: ``update_kernel`` of ``void
    (anonymous namespace)::update_kernel<float, 8>(...)``; other names as
    they are, cut at their first parenthesis."""
    m = _FN.search(key)
    return m.group(1) if m else key.split("(")[0].strip()


class Spans:
    """Host seconds of named spans, summed: ``wrap(module, name,
    label)`` rebinds ``module.name`` so each call runs under a profiler span
    ``label`` and its host seconds add to ``seconds[label]``; ``restore()``
    puts the originals back."""

    def __init__(self):
        self.seconds = collections.Counter()
        self._originals = []

    def wrap(self, module, name, label):
        import torch

        fn = getattr(module, name)

        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                with torch.profiler.record_function(label):
                    return fn(*args, **kwargs)
            finally:
                self.seconds[label] += time.perf_counter() - t0

        self._originals.append((module, name, fn))
        setattr(module, name, spanned)

    def record(self, module, name, on_call):
        """Rebind ``module.name`` so ``on_call(*args)`` sees each call's
        arguments before it runs."""
        fn = getattr(module, name)

        @functools.wraps(fn)
        def recorded(*args, **kwargs):
            on_call(*args, **kwargs)
            return fn(*args, **kwargs)

        self._originals.append((module, name, fn))
        setattr(module, name, recorded)

    def restore(self):
        for module, name, fn in reversed(self._originals):
            setattr(module, name, fn)
        self._originals.clear()


def reduce_profile(prof, span_labels=()) -> dict:
    """{"device", "host", "launches"} from a finished torch.profiler profile."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    device, host_by_thread = [], collections.defaultdict(list)
    launches = 0
    for e in prof.events():
        start, end = float(e.time_range.start), float(e.time_range.end)
        if e.device_type == cuda:
            if e.name not in span_labels:
                device.append((e.name, start, end))
        else:
            launches += e.name in LAUNCH_CALLS
            host_by_thread[e.thread].append((e.name, start, end))
    host = max(host_by_thread.values(), key=len) if host_by_thread else []
    return {"device": device, "host": host, "launches": launches}


def union(intervals):
    """The merged (start, end) intervals covering ``intervals``."""
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            if b > merged[-1][1]:
                merged[-1][1] = b
        else:
            merged.append([a, b])
    return merged


def busy_seconds(device) -> float:
    """Seconds in which some operation ran on the device."""
    return sum(b - a for a, b in union((s, e) for _, s, e in device)) / 1e6


def kernel_seconds(device, names):
    """(seconds, events) of the device events whose function is in ``names``."""
    ev = [(s, e) for n, s, e in device if kernel_name(n) in names]
    return sum(e - s for s, e in ev) / 1e6, len(ev)


def device_ops(device, top=10):
    """[[function, seconds]] of the device operations that took most time."""
    per = collections.Counter()
    for n, s, e in device:
        per[kernel_name(n)] += (e - s) / 1e6
    return [[n, t] for n, t in per.most_common(top)]


def idle_gaps(device, host, layer_labels=(), top=10):
    """[[what the host was doing, seconds]]: the device's idle time between
    its first and last operation, each gap named by the innermost host event
    running at its middle (with the layer span around it), summed by name,
    the largest first."""
    busy = union((s, e) for _, s, e in device)
    gaps = [(busy[i][1], busy[i + 1][0]) for i in range(len(busy) - 1)]
    if not gaps:
        return []
    events = sorted(host, key=lambda x: (x[1], -x[2]))
    starts = [x[1] for x in events]
    per = collections.Counter()
    stack, i = [], 0
    for a, b in sorted(gaps):
        m = 0.5 * (a + b)
        j = bisect.bisect_right(starts, m)
        while i < j:
            while stack and stack[-1][2] <= events[i][1]:
                stack.pop()
            stack.append(events[i])
            i += 1
        while stack and stack[-1][2] < m:
            stack.pop()
        inner = stack[-1][0] if stack else "outside any host event"
        layer = next((x[0] for x in stack if x[0] in layer_labels), "harness")
        per[f"{layer}: {inner}"] += (b - a) / 1e6
    return [[n, t] for n, t in per.most_common(top)]


def _ns(e):
    """(start, end) of a profiler event in ns (older torch gives us)."""
    if hasattr(e, "start_ns"):
        return e.start_ns(), e.start_ns() + e.duration_ns()
    return 1000 * e.start_us(), 1000 * (e.start_us() + e.duration_us())


def union_ns(starts, ends) -> float:
    """The length of the union of the intervals [starts, ends) (arrays)."""
    if len(starts) == 0:
        return 0.0
    order = np.argsort(starts, kind="stable")
    s, reach = starts[order], np.maximum.accumulate(ends[order])
    first = np.flatnonzero(np.concatenate(([True], s[1:] > reach[:-1])))
    last = np.concatenate((first[1:], [len(s)])) - 1
    return float((reach[last] - s[first]).sum())


class DeviceBusy:
    """The device's busy seconds over a stretch of work: ``start()``, then
    ``cut()`` between steps, ``stop()``; ``seconds()`` is the union of the
    device intervals of every segment.  Each segment is one torch.profiler
    profile of the device activity alone (the host's operations are not
    recorded), so its events stay within the profiler's activity buffers
    however long the stretch; a profile's stop waits for the device, so each
    operation lies in the segment that launched it.  The events are read
    once ``stop()`` has returned."""

    def __init__(self, activity=None, device_type=None, skip=()):
        import torch

        self.activity = activity or torch.profiler.ProfilerActivity.CUDA
        self.device_type = device_type or torch.autograd.DeviceType.CUDA
        self.skip = set(skip)
        self._done, self._prof = [], None

    def start(self):
        import torch

        self._prof = torch.profiler.profile(activities=[self.activity])
        self._prof.start()

    def cut(self):
        self.stop()
        self.start()

    def stop(self):
        if self._prof is not None:
            self._prof.stop()
            self._done.append(self._prof)
            self._prof = None

    def read(self):
        """(busy seconds, [device events of each segment]); the profiles
        are released."""
        starts, ends, counts = [], [], []
        for prof in self._done:
            n = 0
            for e in prof.profiler.kineto_results.events():
                if e.device_type() != self.device_type or e.name() in self.skip:
                    continue
                if getattr(e, "is_user_annotation", lambda: False)():
                    continue
                a, b = _ns(e)
                starts.append(a)
                ends.append(b)
                n += 1
            counts.append(n)
        self._done.clear()
        busy = union_ns(np.asarray(starts, np.int64), np.asarray(ends, np.int64))
        return busy / 1e9, counts
