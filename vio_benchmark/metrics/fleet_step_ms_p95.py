"""runner: the 95th percentile of the window's step times (ms), each the gap
between consecutive ``on_frame`` stamps (the first from the window's start)."""

import math


def read(t):
    gaps = sorted(t["step_s"])
    if len(gaps) < 20:
        return None
    return 1e3 * gaps[math.ceil(0.95 * len(gaps)) - 1]
