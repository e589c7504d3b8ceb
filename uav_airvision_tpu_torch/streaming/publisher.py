"""The PyTorch port's own copy of uav_airvision_tpu/streaming/publisher.py:
same names, same behaviour (tests/test_torch_standalone.py holds the two
equal), the pacing slack of the deadline included.

Real-time data publisher: replays a dataset iterable into a queue, pacing
wall-clock against dataset time (API-compatible with the reference
DataPublisher, src/streaming/publisher.py:8-53; semantics re-derived, not
copied: deadline-based monotonic pacing with an event-based stop).

The batch path (streaming/prebatch.py + models/vio.run_sequence) needs no
pacing; this threaded publisher feeds the streaming orchestrator (vio.py)
and reference-style launch scripts.

Contract (matches the reference observable behavior):
  * ``start(starttime)`` anchors dataset time to the given wall-clock epoch
    (``time.time()`` units) and begins replay on a daemon thread.
  * each message lands on ``out_queue`` no earlier than
    ``starttime + (msg.timestamp - dataset.starttime) / ratio``;
  * messages stamped before the dataset start are dropped;
  * a ``None`` sentinel terminates the stream — on exhaustion, on exceeding
    ``duration`` seconds of dataset time, and once more from ``stop()``.
"""

from __future__ import annotations

import time
from threading import Event, Thread

# Replay latency granularity. The reference busy-sleeps in 1 ms slices; we
# wait on the stop event instead so stop() interrupts a sleep immediately,
# and cap each wait so a far-future deadline still observes `stopped`.
_MAX_WAIT_SLICE_S = 0.05
# The reference's busy-sleep loop re-checks every 1 ms and releases only once
# elapsed*ratio >= interval + 1e-3, i.e. it delivers ~1 ms LATE.  Add the
# slack to the deadline to land on that side of the boundary (subtracting it
# would deliver ~1 ms early).
_PACING_SLACK_S = 1e-3


class DataPublisher:
    """Replays ``dataset`` into ``out_queue`` at ``ratio``x real time."""

    def __init__(self, dataset, out_queue, duration=float("inf"), ratio=1.0):
        self.dataset = dataset
        self.dataset_starttime = dataset.starttime
        self.out_queue = out_queue
        self.duration = duration
        self.ratio = ratio
        self.starttime = None
        self.started = False
        self._stop_event = Event()
        self.publish_thread = Thread(target=self.publish, daemon=True)

    # The reference exposes `stopped` as a plain attribute; keep it readable.
    @property
    def stopped(self):
        return self._stop_event.is_set()

    def start(self, starttime):
        """Begin replay, anchoring dataset time to wall-clock ``starttime``."""
        self.started = True
        self.starttime = starttime
        # Convert the caller's time.time() epoch to the monotonic clock once;
        # all pacing below is immune to wall-clock steps after this point.
        self._mono_anchor = time.monotonic() - (time.time() - starttime)
        self.publish_thread.start()

    def stop(self):
        self._stop_event.set()
        if self.started:
            self.publish_thread.join()
        self.out_queue.put(None)

    # -- internals ---------------------------------------------------------

    def _wait_until(self, deadline_mono):
        """Sleep until the monotonic deadline; False if stopped meanwhile."""
        while True:
            remaining = deadline_mono - time.monotonic()
            if remaining <= 0:
                return not self._stop_event.is_set()
            if self._stop_event.wait(min(remaining, _MAX_WAIT_SLICE_S)):
                return False

    def publish(self):
        stream = iter(self.dataset)
        for data in stream:
            if self._stop_event.is_set():
                return
            rel_t = data.timestamp - self.dataset_starttime
            if rel_t < 0:
                continue  # before the configured start offset: drop
            if rel_t > self.duration + _PACING_SLACK_S:
                self.out_queue.put(None)
                return
            deadline = self._mono_anchor + rel_t / self.ratio + _PACING_SLACK_S
            if not self._wait_until(deadline):
                return
            self.out_queue.put(data)
        self.out_queue.put(None)
