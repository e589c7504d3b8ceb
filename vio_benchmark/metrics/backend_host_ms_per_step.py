"""back-end: host ms a step inside ``backend_step_fleet`` over the window
(a host-clock span: enqueue and the back-end's reads, which wait for the
device)."""


def read(t):
    s = t["span_s"].get("backend_step_fleet")
    return 1e3 * s / t["steps"] if s and t["steps"] else None
