"""runner: instance-frames completed in the window over its wall seconds, on
the host's clock (all the work over all the time; host-paced, so it swings
with the host's speed)."""


def read(t):
    return t["instance_frames"] / t["window_s"] if t["window_s"] > 0 else None
