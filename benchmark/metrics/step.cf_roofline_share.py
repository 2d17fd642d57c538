"""The CF run's share of its roofline: the least bytes a job's passes
must move, each over only its phase's edges (``cf_min_bytes.<phase>``,
``apps/pagerank_cf.py::phase_min_bytes``: ``graph500.min_superstep_bytes``
on the phase's edge subset), "first" once, "middle" for every superstep
after it and "last" for the flush, over the card's 3.35 TB/s, as a
percentage of a job's device time: a superstep's device time (the device
busy seconds the profiler saw over the traced jobs, over their
supersteps, so each job's flush counts in it) times the supersteps a
job runs (the window's mean; every job runs the same). None on a run
with no device timeline or no phase bytes."""

PEAK_BYTES_PER_S = 3.35e12     # one H100 SXM, NVIDIA's data sheet


def read(ctx):
    t, s = ctx["trace"], ctx["setup"]
    b = [s.get(f"cf_min_bytes.{ph}") for ph in ("first", "middle", "last")]
    if t is None or not t["step_ms"] or None in b:
        return None
    steps = ctx["window"]["supersteps"]
    n = sum(steps) / len(steps)
    least = b[0] + (n - 1) * b[1] + b[2]
    return 100.0 * (least / PEAK_BYTES_PER_S) / (t["step_ms"] / 1e3 * n)
