"""kernels: K11's (the EKF update's) share of its roofline (%) in the
profiled sub-window: the least time its recorded batched launches need
(``work.k11_work`` from each updating instance's rows) over the device time
the profiler lists for ``update_kernel``.  Nothing where the profiler lists
none."""

from vio_benchmark.yardstick import peaks, trace, work


def read(t):
    p = t.get("profile")
    if not p or not p["k11_calls"]:
        return None
    dev_s, n = trace.kernel_seconds(p["device"], work.KERNELS["K11"])
    if n == 0 or dev_s <= 0:
        return None
    return 100.0 * sum(peaks.bound(b, o)[0] for b, o in p["k11_calls"]) / dev_s
