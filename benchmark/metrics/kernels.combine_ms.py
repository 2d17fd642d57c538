"""Per superstep, the milliseconds of the port's fenced ``combine`` span
(the SpMV) of ``execute_profiled``, over the traced run's profiled jobs
after the window."""


def read(ctx):
    t = ctx["trace"]
    if t is None or not t["split"]["supersteps"]:
        return None
    return (t["split"]["phases_s"].get("combine", 0.0)
            / t["split"]["supersteps"] * 1e3)
