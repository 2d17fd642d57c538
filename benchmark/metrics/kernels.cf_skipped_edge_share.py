"""The share of edge reads that computation filtering (TCSC_CF) skips:
100 x (1 - the stored edges the CF phases read / (stored edges x the
passes that read them)), summed over the traced run's profiled jobs. The
port's executor counts ``cf_phase_edges`` under an open tracer, the
stored edges of the phase each superstep and each flush ran; the system
under test adds each profiled job's count, and its passes (supersteps
and the flush), to the set-up record under ``counters.cf_phase_edges``
and ``counters.cf_supersteps`` (``apps/pagerank_cf.py``). None where they
are absent: a program that does not count them, or an untraced run."""


def read(ctx):
    s = ctx["setup"]
    edges = s.get("counters.cf_phase_edges")
    passes = s.get("counters.cf_supersteps")
    if not edges or not passes:
        return None
    return 100.0 * (1.0 - edges / (ctx["stored_edges"] * passes))
