"""kernels: K2's (the pyramids') share of its roofline (%) in the profiled
sub-window: the least time its recorded launches need (``work.k2_work``,
bytes over 3.35 TB/s or operations over 67 TFLOP/s) over the device time the
profiler lists for its kernels.  Nothing where the profiler lists none."""

from vio_benchmark.yardstick import peaks, trace, work


def read(t):
    p = t.get("profile")
    if not p or not p["k2_calls"]:
        return None
    dev_s, n = trace.kernel_seconds(p["device"], work.KERNELS["K2"])
    if n == 0 or dev_s <= 0:
        return None
    return 100.0 * sum(peaks.bound(b, o)[0] for b, o in p["k2_calls"]) / dev_s
