"""Per superstep, the milliseconds of the port's fenced
``scatter_gather`` + ``exchange`` (on one card: the convergence vote) +
``apply`` spans of ``execute_profiled``, over the traced run's profiled
jobs after the window."""


def read(ctx):
    t = ctx["trace"]
    if t is None or not t["split"]["supersteps"]:
        return None
    p = t["split"]["phases_s"]
    glue = sum(p.get(k, 0.0) for k in ("scatter_gather", "exchange",
                                       "apply"))
    return glue / t["split"]["supersteps"] * 1e3
