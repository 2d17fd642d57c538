"""Plain PageRank with GraphTap's degree handoff, and its comparison.

The stored matrix's edge (i, j) adds column j's message into row i. The
degree phase counts each column's stored edges (the out-degree of the
untransposed graph); PageRank hands a vertex its degree only where its
row has a stored edge (its I bit), and every superstep sets, on those
rows, rank = alpha + (1 - alpha) * sum of rank[j] / degree[j] over the
row's columns (a column of degree 0 sends 0); other rows keep alpha.
Imports nothing of the program.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def degrees(rows, cols, nv: int) -> np.ndarray:
    """Each vertex's stored-column count, as float64."""
    return torch.bincount(torch.as_tensor(cols), minlength=nv).double() \
        .cpu().numpy()


def has_in_edge(rows, nv: int) -> np.ndarray:
    """Whether each vertex's stored row holds an edge (its I bit)."""
    return (torch.bincount(torch.as_tensor(rows), minlength=nv) > 0) \
        .cpu().numpy()


def pagerank(rows, cols, nv: int, iters: int, alpha: float,
             dtype=torch.float64) -> np.ndarray:
    """``iters`` supersteps of PageRank on the edges' device, every
    operation in ``dtype`` (float64: the reference; a lower type: its
    control), as float64."""
    r, c = torch.as_tensor(rows), torch.as_tensor(cols)
    dev = r.device
    has_in = torch.zeros(nv, dtype=torch.bool, device=dev)
    has_in[r] = True
    deg = torch.bincount(c, minlength=nv).to(dtype)
    deg = torch.where(has_in, deg, torch.zeros_like(deg))
    rank = torch.full((nv,), alpha, dtype=dtype, device=dev)
    a = torch.tensor(alpha, dtype=dtype, device=dev)
    for _ in range(iters):
        x = torch.where(deg > 0, rank / torch.where(deg > 0, deg,
                                                    torch.ones_like(deg)),
                        torch.zeros_like(rank))
        y = torch.zeros(nv, dtype=dtype, device=dev).index_add_(0, r, x[c])
        rank = torch.where(has_in, a + (1 - a) * y, rank)
    return rank.double().cpu().numpy()


class Reference:
    """The reference answers of one graph: the degrees, the degrees
    handed to PageRank, and the ranks after ``iters`` supersteps."""

    def __init__(self, rows, cols, nv: int, iters: int, alpha: float):
        self.degree = degrees(rows, cols, nv)
        self.handed = np.where(has_in_edge(rows, nv), self.degree, 0.0)
        self.rank = pagerank(rows, cols, nv, iters, alpha)

    def compare(self, answer: Dict[str, np.ndarray], degree: np.ndarray
                ) -> Dict[str, float]:
        """The numbers ``correct`` is decided on, for the degree phase's
        ``degree`` and one PageRank ``answer`` (its ``rank`` and
        ``degree``, in vertex order):

        - ``degree_mismatch``: vertices whose degree, in the degree phase
          or as handed to PageRank, differs from the count;
        - ``rank_rel_err``: the largest |rank - reference| / reference
          over every vertex."""
        bad = np.count_nonzero(degree.astype(np.float64) != self.degree)
        bad += np.count_nonzero(answer["degree"].astype(np.float64)
                                != self.handed)
        err = np.max(np.abs(answer["rank"].astype(np.float64) - self.rank)
                     / self.rank)
        return {"degree_mismatch": int(bad), "rank_rel_err": float(err)}


def control_answers(rows, cols, nv: int, iters: int, alpha: float
                    ) -> Dict[str, np.ndarray]:
    """The control: the reference in bfloat16, the type below the
    configuration's float32, as one answer in the program's place."""
    rank = pagerank(rows, cols, nv, iters, alpha, torch.bfloat16)
    return {"rank": rank, "degree": np.where(has_in_edge(rows, nv),
                                             degrees(rows, cols, nv), 0.0)}
