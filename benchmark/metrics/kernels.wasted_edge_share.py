"""The share of the SpMV's edge reads that no frontier vertex needed:
100 x (1 - frontier edges / relaxed edges), summed over the traced run's
profiled jobs. The port's executor counts both under an open tracer
(``relaxed_edges``: the stored edges a superstep's SpMV read;
``frontier_edges``: those whose source is in its frontier); the system
under test adds each profiled job's counts to the set-up record, under
``counters.relaxed_edges`` and ``counters.frontier_edges``, which reaches
a reader as ``ctx["setup"]`` (``apps/sssp.py``). None where they are
absent: a program that does not count them, or an untraced run."""


def read(ctx):
    s = ctx["setup"]
    relaxed = s.get("counters.relaxed_edges")
    frontier = s.get("counters.frontier_edges")
    if not relaxed or frontier is None:
        return None
    return 100.0 * (1.0 - frontier / relaxed)
