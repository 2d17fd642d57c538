"""Plain PageRank to tolerance as GraphTap's pr.cpp runs it on a TCSC_CF
graph (computation filtering), and its comparison.

The stored matrix's edge (i, j) adds column j's message into row i. The
vertex classes come from the stored edges: a vertex is regular when its
row and its column each hold a stored edge, a source row when only its
row does. The degree phase counts each column's stored edges; PageRank
hands a vertex its degree only where its row has a stored edge (its I
bit), so a column with no row sends 0. Every superstep sets, on the
regular rows, rank = alpha + (1 - alpha) * sum of rank[j] / degree[j]
over the row's columns; a regular vertex has changed iff its rank moved
by more than ``tol``, and the run stops after the first superstep in
which none has. Then one flush: the same sum over the last superstep's
messages, applied on every row with a stored edge (source rows get their
rank there). It returns the ranks and the supersteps (the flush not
counted). Imports nothing of the program.

Departures from pr.h (pr.h:12-13, 35-47; vertex_program.hpp:407-441):

- float64 throughout, where pr.h's state is the binary's value type and
  the configuration's is float32;
- the vote counts regular vertices only, and the source rows wait for
  the flush: TCSC_CF's phase apply masks (vertex_program.hpp:1671-1692),
  which pr.cpp's ``_TCSC_CF_`` load selects, written out here on the
  edges instead of as three edge subsets; the sink columns the phases
  drop send 0, so the sums are the same;
- the flush applies the last superstep's messages, as the reference's
  convergence loop does (:425-429).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from benchmark.reference.pagerank import degrees, has_in_edge

CONTROL_SUPERSTEPS = 1000   # the control's cap: bfloat16 may never settle


def classes(rows, cols, nv: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(has a stored in-edge: its row holds an edge, regular: its row
    and its column each hold one), per vertex, on the edges' device."""
    r, c = torch.as_tensor(rows), torch.as_tensor(cols)
    has_row = torch.bincount(r, minlength=nv) > 0
    has_col = torch.bincount(c, minlength=nv) > 0
    return has_row, has_row & has_col


def pagerank_cf(rows, cols, nv: int, alpha: float, tol: float,
                dtype=torch.float64, max_supersteps: Optional[int] = None
                ) -> Tuple[np.ndarray, int]:
    """(ranks as float64, supersteps) of the run to tolerance and its
    flush, every operation in ``dtype`` on the edges' device (float64:
    the reference; a lower type: its control, which stops at
    ``max_supersteps`` if it has not settled by then)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    r, c = torch.as_tensor(rows), torch.as_tensor(cols)
    dev = r.device
    has_in, regular = classes(r, c, nv)
    deg = torch.bincount(c, minlength=nv).to(dtype)
    deg = torch.where(has_in, deg, torch.zeros_like(deg))
    one = torch.ones_like(deg)
    a = torch.tensor(alpha, dtype=dtype, device=dev)
    rank = torch.full((nv,), alpha, dtype=dtype, device=dev)

    def sums(x):
        return torch.zeros(nv, dtype=dtype, device=dev).index_add_(0, r,
                                                                    x[c])

    steps = 0
    while True:
        x = torch.where(deg > 0, rank / torch.where(deg > 0, deg, one),
                        torch.zeros_like(rank))
        new = torch.where(regular, a + (1 - a) * sums(x), rank)
        changed = regular & ((new - rank).abs() > tol)
        rank = new
        steps += 1
        if not bool(changed.any()) or steps == max_supersteps:
            break
    rank = torch.where(has_in, a + (1 - a) * sums(x), rank)
    return rank.double().cpu().numpy(), steps


class Reference:
    """The reference answers of one graph: the degrees, the degrees
    handed to PageRank, the ranks after the flush and the supersteps."""

    def __init__(self, rows, cols, nv: int, alpha: float, tol: float):
        self.degree = degrees(rows, cols, nv)
        self.handed = np.where(has_in_edge(rows, nv), self.degree, 0.0)
        self.rank, self.supersteps = pagerank_cf(rows, cols, nv, alpha, tol)

    def compare(self, answer: Dict, degree: np.ndarray) -> Dict[str, float]:
        """The numbers ``correct`` is decided on, for the degree phase's
        ``degree`` and one PageRank ``answer`` (its ``rank`` and
        ``degree`` in vertex order, and its ``supersteps``):

        - ``degree_mismatch``: vertices whose degree, in the degree phase
          or as handed to PageRank, differs from the count;
        - ``rank_rel_err``: the largest |rank - reference| / reference
          over every vertex;
        - ``supersteps_off``: |the answer's supersteps - the
          reference's|."""
        bad = np.count_nonzero(degree.astype(np.float64) != self.degree)
        bad += np.count_nonzero(answer["degree"].astype(np.float64)
                                != self.handed)
        err = np.max(np.abs(answer["rank"].astype(np.float64) - self.rank)
                     / self.rank)
        return {"degree_mismatch": int(bad), "rank_rel_err": float(err),
                "supersteps_off": abs(int(answer["supersteps"])
                                      - self.supersteps)}


def control_answers(rows, cols, nv: int, alpha: float, tol: float
                    ) -> Dict:
    """The control: the reference in bfloat16, the type below the
    configuration's float32, as one answer in the program's place (at
    most ``CONTROL_SUPERSTEPS`` supersteps)."""
    rank, steps = pagerank_cf(rows, cols, nv, alpha, tol, torch.bfloat16,
                              CONTROL_SUPERSTEPS)
    return {"rank": rank, "supersteps": steps,
            "degree": np.where(has_in_edge(rows, nv),
                               degrees(rows, cols, nv), 0.0)}
