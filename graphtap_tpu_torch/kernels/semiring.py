"""Semirings: the (multiply, add, identity) triple of a vertex program.

Counterpart of ``graphtap_tpu/kernels/semiring.py`` over torch tensors.
``reduce_kind`` names the ⊕-fold ('sum' | 'min' | 'max'); ``identity``
is the ⊕-identity used for padding lanes, fill slots and inactive
messages (the reference's ``infinity()``, vertex_program.hpp:40).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch

INF_I32 = 2147483647  # INT32_MAX sentinel (reference: bfs.h:12, sssp.h:12)


def inf_of(dtype: torch.dtype):
    """The min semirings' INF in ``dtype``: INT32_MAX for int32, as the
    reference's sentinel; +inf for a float type (Graph500's float
    distances), which ``min`` and ``+`` keep as it is."""
    return float("inf") if dtype.is_floating_point else INF_I32

_SCATTER_REDUCE = {"sum": "sum", "min": "amin", "max": "amax"}


@dataclass(frozen=True)
class Semiring:
    """A semiring (⊕, ⊗, id⊕) acting on message values; ``mul(x, w)``
    combines a gathered message with an edge weight (w None = unweighted).
    ``mul_kind`` names that ⊗ for a hand kernel that applies it itself
    ('mul': x * w; 'add_sat': ``_add_sat``); None where only ``mul``
    computes it."""

    name: str
    add: Callable[[Any, Any], Any]
    mul: Callable[[Any, Optional[Any]], Any]
    identity: Any
    reduce_kind: str  # 'sum' | 'min' | 'max'
    mul_kind: Optional[str] = None

    def identity_like(self, dtype: torch.dtype, device=None) -> torch.Tensor:
        """The ⊕-identity as a 0-d tensor, filled on ``device`` (no copy
        from the host: the superstep makes one every call)."""
        return torch.full((), self.identity, dtype=dtype, device=device)

    def segment_reduce(self, data: torch.Tensor, segment_ids: torch.Tensor,
                       num_segments: int) -> torch.Tensor:
        """⊕ of ``data`` into ``num_segments`` rows by ``segment_ids``;
        empty segments hold the ⊕-identity."""
        out = torch.full((num_segments,), self.identity, dtype=data.dtype,
                         device=data.device)
        return out.scatter_reduce_(0, segment_ids.long(), data,
                                   _SCATTER_REDUCE[self.reduce_kind],
                                   include_self=True)

    def axis_reduce(self, data: torch.Tensor, axis: int) -> torch.Tensor:
        """⊕-fold along a tensor axis."""
        if self.reduce_kind == "sum":
            return data.sum(dim=axis)
        if self.reduce_kind == "min":
            return data.amin(dim=axis)
        if self.reduce_kind == "max":
            return data.amax(dim=axis)
        raise ValueError(self.reduce_kind)


def _add_sat(x, w, inf):
    """x ⊗ w for the min semirings: INF stays INF, so INF + w never wraps
    in int32 (valid path lengths are assumed << INT32_MAX); over floats
    ``inf`` is +inf, which the guard keeps as it is."""
    return torch.where(x >= inf, torch.full_like(x, inf), x + w)


def plus_times() -> Semiring:
    """(+, *, 0): degree and PageRank (reference: pr.h:35-41, deg.h:43-49)."""
    def mul(x, w):
        return x if w is None else x * w
    return Semiring(name="plus_times", add=torch.add, mul=mul,
                    identity=0, reduce_kind="sum", mul_kind="mul")


def min_plus(inf=INF_I32) -> Semiring:
    """(min, +w, INF): SSSP (reference: sssp.h:49-56), with the INF guard
    on ⊗ (``add_sat``); ``inf`` is ``inf_of`` the value type (+inf over
    floats)."""
    def mul(x, w):
        return x if w is None else _add_sat(x, w, inf)
    return Semiring(name="min_plus", add=torch.minimum, mul=mul,
                    identity=inf, reduce_kind="min", mul_kind="add_sat")


def min_select(inf=INF_I32) -> Semiring:
    """(min, id, INF): CC label propagation and BFS parent-min
    (reference: cc.h:43-49, bfs.h:57-64)."""
    def mul(x, w):
        return x if w is None else _add_sat(x, w, inf)
    return Semiring(name="min_select", add=torch.minimum, mul=mul,
                    identity=inf, reduce_kind="min", mul_kind="add_sat")
