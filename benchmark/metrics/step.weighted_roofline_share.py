"""The weighted SpMV's share of its roofline: the least bytes one
superstep of a weighted vertex program must move, whatever implements it
(``graph500.min_superstep_bytes``, counted from the edge list alone, plus
each stored edge's 4-byte weight read once), over the card's 3.35 TB/s,
as a percentage of a superstep's device time: the device busy seconds the
profiler saw over the traced run's profiled jobs, over their supersteps
(so each job's copies and convergence flush count in it)."""

PEAK_BYTES_PER_S = 3.35e12     # one H100 SXM, NVIDIA's data sheet
WEIGHT_BYTES = 4


def read(ctx):
    t = ctx["trace"]
    if t is None or not t["step_ms"]:
        return None
    least = t["min_bytes"] + WEIGHT_BYTES * ctx["stored_edges"]
    return 100.0 * (least / PEAK_BYTES_PER_S) / (t["step_ms"] / 1e3)
