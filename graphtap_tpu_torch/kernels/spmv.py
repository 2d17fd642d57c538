"""Semiring SpMV over one device tile, in plain torch.

Counterpart of ``graphtap_tpu/kernels/spmv.py``. These are the portable
paths; the JAX package leaves them to XLA (no Pallas), so plain torch
ops are their faithful port. The degree phase of PageRank runs through
``spmv_sorted_scan`` (the JAX bench's own choice at scale >= 21,
``bench.py:129-134``); degrees are integer sums, exact in f32.

The reference's hot loop ``y[IA[i]] ⊕= x[j] ⊗ A[i]``
(vertex_program.hpp:1116-1327) becomes: gather x per edge, ⊗ with the
weight, mask padding to the ⊕-identity, then a segment-⊕ over the
(sorted) destination rows.
"""

from __future__ import annotations

from typing import Optional

import torch

from graphtap_tpu_torch.kernels.semiring import Semiring


def edge_contributions(
    x: torch.Tensor,                  # (ncols_local,) gathered message block
    cols: torch.Tensor,               # (Ep,) local col per edge
    weights: Optional[torch.Tensor],  # (Ep,) or None
    nnz: int,                         # valid-edge count
    semiring: Semiring,
) -> torch.Tensor:
    """Per-edge x[col] ⊗ w with padding masked to the ⊕-identity."""
    contrib = semiring.mul(x[cols.long()], weights)
    valid = torch.arange(cols.shape[0], device=cols.device) < nnz
    return torch.where(valid, contrib,
                       semiring.identity_like(contrib.dtype, contrib.device))


def spmv_segment(x, rows, cols, weights, nnz: int, num_segments: int,
                 semiring: Semiring) -> torch.Tensor:
    """Segment-reduce SpMV: y over [0, num_segments)."""
    contrib = edge_contributions(x, cols, weights, nnz, semiring)
    return semiring.segment_reduce(contrib, rows, num_segments)


def spmv_sorted_scan(x, rows, cols, weights, nnz: int,
                     ja: torch.Tensor, semiring: Semiring) -> torch.Tensor:
    """SpMV over destination-sorted edges (the JAX package's segmented
    scan + pointer gather) into the NR = len(ja) - 1 compact rows; rows
    with no edge (``ja[k+1] == ja[k]``) keep the ⊕-identity, exactly as
    the scan version leaves them. Float sums fold each row's run of edges
    by ``torch.segment_reduce`` over the pointers ``ja``, which adds in a
    fixed order on either device: the card's ``scatter_reduce`` adds with
    atomics in no fixed order, and then f32 PageRank's absolute
    convergence vote does not close (ROADMAP F8). Integer sums, min and
    max are exact in any order and take ``scatter_reduce``."""
    if semiring.reduce_kind == "sum" and x.dtype.is_floating_point:
        contrib = edge_contributions(x, cols, weights, nnz, semiring)
        return torch.segment_reduce(contrib[:nnz], "sum",
                                    offsets=ja.long(), initial=0)
    return spmv_segment(x, rows, cols, weights, nnz, ja.shape[0] - 1,
                        semiring)


def scatter_to_dense(y_compact: torch.Tensor, ir: torch.Tensor,
                     dense_len: int, semiring: Semiring) -> torch.Tensor:
    """Expand a renumbered accumulator (NR,) to the dense row block
    (dense_len,) by ``ir``, the dense local row of each renumbered row;
    padding entries of ``ir`` point past the end and are dropped, as the
    reference's IR scatter on update (tcsc_spmspv2.hpp:531-536); an index
    in [-dense_len, 0) counts from the end, as numpy's. Rows no entry
    reaches hold the ⊕-identity."""
    y = torch.full((dense_len,), semiring.identity, dtype=y_compact.dtype,
                   device=y_compact.device)
    ir = ir.long()
    ir = torch.where(ir < 0, ir + dense_len, ir)
    keep = (ir >= 0) & (ir < dense_len)
    y[ir[keep]] = y_compact[keep]
    return y


def expand_compact(y_compact: torch.Tensor, iv_dense: torch.Tensor,
                   semiring: Semiring) -> torch.Tensor:
    """Gather-based inverse of the TCSC renumbering: dense row block from
    the compact accumulator (-1 in ``iv_dense`` = no row = ⊕-identity)."""
    iv = iv_dense.long()
    y = y_compact[iv.clamp(0, y_compact.shape[0] - 1)]
    return torch.where(iv >= 0, y,
                       semiring.identity_like(y_compact.dtype,
                                              y_compact.device))


def spmv_dense_reference(x, rows, cols, weights, nnz: int,
                         num_segments: int,
                         semiring: Semiring) -> torch.Tensor:
    """Ground-truth SpMV via explicit one-hot expansion (tiny tiles only)."""
    contrib = edge_contributions(x, cols, weights, nnz, semiring)
    onehot = rows.long()[:, None] == torch.arange(
        num_segments, device=rows.device)[None, :]
    expanded = torch.where(onehot, contrib[:, None],
                           semiring.identity_like(contrib.dtype,
                                                  contrib.device))
    return semiring.axis_reduce(expanded, axis=0)
