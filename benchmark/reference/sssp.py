"""Plain float32 SSSP (Graph500 kernel 3, GraphTap's min-plus program)
by synchronous frontier Bellman-Ford, and its comparison.

The stored matrix's edge (i, j), of weight ``g500_weights.pair_weights(i,
j)``, lets column j reach row i. Each level relaxes the edges whose
source changed in the level before (the root at the first): d[j] + w in
float32, a min scatter into the rows, then ``changed = new < old``; the
run stops after the level that changes nothing, which it counts (the
program counts the superstep whose vote closes). The root has distance 0,
unreached vertices +inf. ``min`` is exact in any order and each d + w is
one float32 add, so the program must give these bits. Imports nothing of
the program.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from benchmark.g500_weights import pair_weights

QUANTUM = 1.0 / 128     # the coarse-weight control's step


class Reference:
    """SSSP over one stored edge list, on the edges' device."""

    def __init__(self, rows, cols, nv: int):
        self.rows, self.cols = torch.as_tensor(rows), torch.as_tensor(cols)
        self.w = pair_weights(self.rows, self.cols)
        self.nv = nv

    def run(self, root: int, dtype=torch.float32,
            quantum: Optional[float] = None) -> Tuple[np.ndarray, int]:
        """(distances, levels) of the query from ``root``. The controls:
        ``dtype`` bfloat16 rounds each relaxed distance to it; ``quantum``
        rounds each weight down to a multiple of it."""
        dev = self.rows.device
        w = self.w if quantum is None else \
            torch.floor(self.w / quantum) * quantum
        d = torch.full((self.nv,), float("inf"), dtype=torch.float32,
                       device=dev)
        d[root] = 0.0
        frontier = torch.zeros(self.nv, dtype=torch.bool, device=dev)
        frontier[root] = True
        steps = 0
        while True:
            act = frontier[self.cols]
            steps += 1
            vals = (d[self.cols[act]] + w[act]).to(dtype).float()
            cand = torch.full_like(d, float("inf")).scatter_reduce_(
                0, self.rows[act], vals, "amin")
            new = torch.minimum(d, cand)
            frontier = new < d
            d = new
            if not bool(frontier.any()):
                return d.cpu().numpy(), steps

    def compare(self, answer: Dict) -> Dict[str, float]:
        """The numbers ``correct`` is decided on, for one query (its
        ``root``, its ``distance`` in vertex order and its
        ``supersteps``), both exact:

        - ``distance_mismatch``: vertices whose float32 distance differs
          from the reference's in any bit;
        - ``supersteps_mismatch``: 1 if the query ran another number of
          supersteps than the reference's levels, else 0."""
        d, steps = self.run(int(answer["root"]))
        got = np.asarray(answer["distance"], np.float32)
        return {"distance_mismatch": int(np.count_nonzero(
                    got.view(np.int32) != d.view(np.int32))),
                "supersteps_mismatch": int(int(answer["supersteps"])
                                           != steps)}


def control_answers(ref: Reference, roots, dtype=torch.bfloat16,
                    quantum: Optional[float] = None) -> List[Dict]:
    """A control, one answer per root: the reference with its distances
    in bfloat16, the type below the configuration's float32 (or, given
    ``quantum``, with its weights rounded down to that step)."""
    out = []
    for root in roots:
        d, steps = ref.run(int(root), dtype, quantum)
        out.append({"root": int(root), "distance": d, "supersteps": steps})
    return out
