"""Plain float32 SSSP: synchronous frontier Bellman-Ford over a stored
edge list, the CPU tests' reference for the port's float SSSP.

The stored edge (i, j) with weight w lets column j reach row i. Each
level relaxes the edges whose source changed in the level before (the
root at the first): d[j] + w in float32, a min scatter into the rows,
then ``changed = new < old``; the run stops after the level that changes
nothing, so it counts that level too, as the port counts the superstep
whose vote closes. ``min`` is exact in any order and every d + w is one
float32 add, so the port must give these bits. Imports neither JAX nor
the port.
"""

from __future__ import annotations

from typing import Tuple

import torch


def sssp(rows, cols, w, nv: int, root: int
         ) -> Tuple[torch.Tensor, int, int]:
    """(distances (nv,) float32, +inf where unreached; the levels run;
    the sum over the levels of the frontier's stored out-edges)."""
    rows, cols = torch.as_tensor(rows).long(), torch.as_tensor(cols).long()
    w = torch.as_tensor(w, dtype=torch.float32)
    inf = float("inf")
    d = torch.full((nv,), inf, dtype=torch.float32)
    d[root] = 0.0
    frontier = torch.zeros(nv, dtype=torch.bool)
    frontier[root] = True
    steps = frontier_edges = 0
    while True:
        act = frontier[cols]
        steps += 1
        frontier_edges += int(act.sum())
        cand = torch.full((nv,), inf, dtype=torch.float32).scatter_reduce_(
            0, rows[act], d[cols[act]] + w[act], "amin")
        new = torch.minimum(d, cand)
        frontier = new < d
        d = new
        if not bool(frontier.any()):
            return d, steps, frontier_edges
