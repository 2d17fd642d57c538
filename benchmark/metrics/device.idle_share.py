"""The percentage of the traced run's own (unprofiled) window in which
the device was idle: 1 - the window's supersteps x a superstep's device
time (the profiled jobs' device busy seconds over their supersteps) /
the window's seconds."""


def read(ctx):
    t = ctx["trace"]
    if t is None or not t["step_ms"]:
        return None
    w = ctx["window"]
    busy = sum(w["supersteps"]) * t["step_ms"] / 1e3
    return 100.0 * (1.0 - busy / w["seconds"])
