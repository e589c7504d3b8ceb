"""device: the share (%) of the profiled sub-window's wall time in which no
operation ran on the device (1 - the union of device intervals / the wall)."""

from vio_benchmark.yardstick import trace


def read(t):
    p = t.get("profile")
    if not p or not p["device"] or p["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_seconds(p["device"]) / p["window_s"])
