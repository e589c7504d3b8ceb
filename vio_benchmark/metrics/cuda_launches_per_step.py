"""device: kernel launch calls (``trace.LAUNCH_CALLS``) a step of the
profiled sub-window."""


def read(t):
    p = t.get("profile")
    if not p or not p["launches"] or not p["steps"]:
        return None
    return p["launches"] / p["steps"]
