"""The least time one superstep could take, its least bytes (counted from
the edge list alone, ``graph500.min_superstep_bytes``) over the card's
3.35 TB/s, as a percentage of a superstep's device time: the device busy
seconds the profiler saw over the traced run's profiled jobs, over their
supersteps (so each job's copies and convergence flush count in it)."""

PEAK_BYTES_PER_S = 3.35e12     # one H100 SXM, NVIDIA's data sheet


def read(ctx):
    t = ctx["trace"]
    if t is None or not t["step_ms"]:
        return None
    return 100.0 * (t["min_bytes"] / PEAK_BYTES_PER_S) / (t["step_ms"] / 1e3)
