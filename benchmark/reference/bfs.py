"""Plain level-synchronous BFS with the min-select parent, and its
comparison.

The stored matrix's edge (i, j) lets a frontier vertex j reach row i.
Each superstep, every unvisited row with a frontier column gets hops =
superstep + 1 and parent = the least such column; the new rows are the
next frontier, and the run stops after the superstep that reaches none
(so a query runs max hops + 1 supersteps). The root has parent = itself
and hops 0; unreached vertices keep parent 0 and hops INF. Imports
nothing of the program.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

INF = 2147483647


class Reference:
    """BFS over one stored edge list, on the edges' device."""

    def __init__(self, rows, cols, nv: int):
        self.rows, self.cols = torch.as_tensor(rows), torch.as_tensor(cols)
        self.nv = nv

    def run(self, root: int, message_dtype=torch.int64
            ) -> Tuple[np.ndarray, np.ndarray, int]:
        """(parent, hops, supersteps) of the query from ``root``; the
        messages (vertex ids) are held in ``message_dtype`` (int64: the
        reference; int16: the control, whose ids wrap). A row's parent is
        the least message among its frontier columns."""
        dev = self.rows.device
        parent = torch.zeros(self.nv, dtype=torch.int64, device=dev)
        hops = torch.full((self.nv,), INF, dtype=torch.int64, device=dev)
        parent[root], hops[root] = root, 0
        frontier = torch.zeros(self.nv, dtype=torch.bool, device=dev)
        frontier[root] = True
        ids = torch.arange(self.nv, device=dev).to(message_dtype).long()
        none = torch.iinfo(torch.int64).max
        steps = 0
        while True:
            act = frontier[self.cols] & (hops[self.rows] == INF)
            steps += 1
            if not bool(act.any()):
                return parent.cpu().numpy(), hops.cpu().numpy(), steps
            least = torch.full((self.nv,), none, dtype=torch.int64,
                               device=dev).scatter_reduce_(
                0, self.rows[act], ids[self.cols[act]], "amin")
            frontier = least != none
            hops[frontier] = steps
            parent[frontier] = least[frontier]

    def compare(self, answer: Dict) -> Dict[str, float]:
        """The numbers ``correct`` is decided on, for one query (its
        ``root``, its ``parent`` and ``hops`` in vertex order and its
        ``supersteps``), all exact:

        - ``hops_mismatch``: vertices whose hops differ from the
          reference's;
        - ``parent_mismatch``: vertices whose parent differs;
        - ``supersteps_mismatch``: 1 if the query ran another number of
          supersteps than the reference's levels + 1, else 0."""
        parent, hops, steps = self.run(int(answer["root"]))
        return {"hops_mismatch": int(np.count_nonzero(
                    answer["hops"].astype(np.int64) != hops)),
                "parent_mismatch": int(np.count_nonzero(
                    answer["parent"].astype(np.int64) != parent)),
                "supersteps_mismatch": int(int(answer["supersteps"])
                                           != steps)}


def control_answers(ref: Reference, roots) -> List[Dict]:
    """The control: the reference with its messages in int16, the type
    below the configuration's int32, one answer per root."""
    out = []
    for root in roots:
        parent, hops, steps = ref.run(int(root), torch.int16)
        out.append({"root": int(root), "parent": parent, "hops": hops,
                    "supersteps": steps})
    return out
