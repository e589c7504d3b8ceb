"""runner: the port's device-to-host reads (``device.host_syncs``) a step of
the window."""


def read(t):
    return t["host_syncs"] / t["steps"] if t["steps"] else None
