"""front-end: host ms a step inside ``frontend_step_fleet`` over the window
(a host-clock span, no synchronise: enqueue and the front-end's own reads)."""


def read(t):
    s = t["span_s"].get("frontend_step_fleet")
    return 1e3 * s / t["steps"] if s and t["steps"] else None
