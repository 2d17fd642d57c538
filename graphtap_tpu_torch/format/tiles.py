"""Tile construction: filtering, renumbering, compression (numpy).

Counterpart of ``graphtap_tpu/format/tiles.py`` (``build_tileset``,
``classify_vertices``, ``build_cf_tilesets``) for every format (CSC,
DCSC, TCSC, TCSC_CF): the same arrays, byte for byte, without the device
placement (``device_arrays``). On a mesh of D > 1 ranks (``mesh=``) each
rank holds only its shard's edges (after ``exchange_edges``), so the
filter masks are OR-combined across the ranks and the per-device counts
max- and sum-reduced, at the JAX package's three points
(``parallel/multihost.py``): every rank then holds the (D, ...) tiles of
the JAX multi-process layout, its own row equal to the single-process
build's. TCSC_CF renumbers rows as TCSC does; its first/middle/last edge
subsets are ``build_cf_tilesets``'s, and the engine runs them as phases
(``engine/executor.py``); ``build_cf_subsets`` takes the same subsets
from the full build's sorted edges, with no second bin or sort. DCSC
(reference: compressed_column.hpp:156-271) renumbers the columns into the
compact nnz-col space and keeps the JC table, compact id -> dense local
col, through which the engine gathers x (dcsc_spmv.hpp:216-230). The
engine moves the fields it needs to the device itself.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from graphtap_tpu_torch import native
from graphtap_tpu_torch.config import Compression
from graphtap_tpu_torch.parallel import multihost as mh
from graphtap_tpu_torch.parallel.layout import Mesh, Partition
from graphtap_tpu_torch.tools import timing


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass
class TileSet:
    """Device-stacked (leading axis D = R*C), padded tile arrays."""

    part: Partition
    compression: Compression
    has_weight: bool
    Ep: int                      # padded edges per device
    NR: int                      # padded segment-space size for the y reduction
    nnz_total: int               # total (deduped) edge count across devices

    rows: np.ndarray             # (D, Ep) int32, ⊕-segment ids, sorted ascending
    cols: np.ndarray             # (D, Ep) int32, local col in [0, R*L)
                                 # (DCSC: compact nnz-col id)
    weights: Optional[np.ndarray]  # (D, Ep) or None
    nnz: np.ndarray              # (D, 1) int32 valid-edge counts
    ja: np.ndarray               # (D, NR+1) int32 row pointer over valid edges
    ir: Optional[np.ndarray]     # (D, NR) int32 renumbered->dense local row
    iv_dense: Optional[np.ndarray]  # (D, C*L) int32 dense row -> renumbered id
    nnzrows: np.ndarray          # (D, 1) int32 nnz rows of the row group
    i_own: np.ndarray            # (D, L) bool — in-edge mask of the owner segment
    j_own: np.ndarray            # (D, L) bool — out-edge mask of the owner segment
    regular_own: np.ndarray      # (D, L) bool — i_own & j_own
    source_own: np.ndarray       # (D, L) bool — i_own & ~j_own
    sink_own: np.ndarray         # (D, L) bool — j_own & ~i_own
    nnzcols: np.ndarray          # (D, 1) int32 nnz cols of the col group
    # DCSC only: compact col id -> dense local col (reference JC,
    # compressed_column.hpp:163), NCp = nnz cols rounded up to 128
    jc: Optional[np.ndarray] = None   # (D, NCp) int32 or None
    # every device's valid-edge count across the mesh (nnz holds only
    # this rank's row on a mesh), and the mesh the tiles were built on
    dev_nnz: Optional[np.ndarray] = None   # (D,) int64
    mesh: Optional[Mesh] = field(default=None, repr=False, compare=False)

    def edge_balance(self) -> dict:
        """Imbalance report (analog of Matrix::balance, matrix.hpp:563-687)."""
        counts = (self.nnz[:, 0] if self.dev_nnz is None
                  else self.dev_nnz).astype(np.float64)
        mean = counts.mean() if counts.size else 0.0
        return {
            "per_device": counts.astype(np.int64).tolist(),
            "mean": float(mean),
            "max": float(counts.max() if counts.size else 0),
            "imbalance": float((counts.max() / mean - 1.0) if mean > 0
                               else 0.0),
        }

    def balance_report(self, threshold: float = 0.2) -> str:
        """The one-line balance report printed at load (the reference
        prints per-rank/rowgroup/colgroup imbalance with skip threshold
        0.2, matrix.hpp:617-685 — report only, like there)."""
        b = self.edge_balance()
        line = (f"Edge balance: edges={self.nnz_total} "
                f"mean/dev={b['mean']:.0f} max/dev={b['max']:.0f} "
                f"imbalance={b['imbalance']:.3f}")
        if b["imbalance"] > threshold:
            line += f" (exceeds threshold {threshold})"
        return line


@dataclass
class SortedEdges:
    """A build's edges as its ``tiles.sort`` left them, parallel ones
    dropped where the config drops them: for each device, the index of
    each kept edge in the build's input list, and its weight (the least
    of its run where parallel edges were dropped), or None unweighted."""

    idx: List[np.ndarray]
    w: Optional[List[np.ndarray]]


def classify_vertices(r: np.ndarray, c: np.ndarray, n_pad: int,
                      mesh: Optional[Mesh] = None):
    """Vertex classes over the stored matrix (reference:
    classify_vertices, matrix.hpp:1125-1282): regular = row and col
    present, source rows = rows without cols, sink cols = cols without
    rows. On a mesh each rank holds its share of the edges, so the
    presence bitvectors are OR-combined across the ranks (matrix.hpp:
    990-1006)."""
    has_row = np.zeros(n_pad, dtype=bool)
    has_col = np.zeros(n_pad, dtype=bool)
    has_row[np.asarray(r, np.int64)] = True
    has_col[np.asarray(c, np.int64)] = True
    has_row = mh.global_or(has_row, mesh)
    has_col = mh.global_or(has_col, mesh)
    return {"regular": has_row & has_col,
            "source_row": has_row & ~has_col,
            "sink_col": has_col & ~has_row}


def build_cf_tilesets(r: np.ndarray, c: np.ndarray, w: Optional[np.ndarray],
                      part: Partition, parallel_edges: bool = True,
                      edge_align: int = 1024, weight_dtype=np.int32,
                      mesh: Optional[Mesh] = None):
    """TCSC_CF: the full tileset and three edge-subset tilesets for the
    first / middle / last iteration phases (reference: the JA/JC pointer
    sets of TCSC_CF_BASE, compressed_column.hpp:606-1120, run per phase in
    spmv_stationary, vertex_program.hpp:1243-1320):

      first  — regular-row edges, all columns
      middle — regular rows x regular columns
      last   — everything except regular-row x sink-col

    Sink columns' messages are zero under the I-masked degree handoff
    (vertex_program.hpp:476-483), which makes dropping regular-row x
    sink-col edges after iteration 0 sound."""
    r = np.asarray(r, np.int64)
    c = np.asarray(c, np.int64)
    cls = classify_vertices(r, c, part.n_pad, mesh)
    row_is_source = cls["source_row"][r]
    col_is_sink = cls["sink_col"][c]

    def subset(mask):
        return build_tileset(r[mask], c[mask],
                             w[mask] if w is not None else None, part,
                             compression=Compression.TCSC_CF,
                             parallel_edges=parallel_edges,
                             edge_align=edge_align,
                             weight_dtype=weight_dtype, mesh=mesh)

    full = build_tileset(r, c, w, part, compression=Compression.TCSC_CF,
                         parallel_edges=parallel_edges,
                         edge_align=edge_align, weight_dtype=weight_dtype,
                         mesh=mesh)
    return {"full": full,
            "first": subset(~row_is_source),
            "middle": subset(~row_is_source & ~col_is_sink),
            "last": subset(~(~row_is_source & col_is_sink))}


def build_cf_subsets(full: TileSet, srt: SortedEdges, r: np.ndarray,
                     c: np.ndarray, edge_align: int = 1024,
                     weight_dtype=np.int32) -> Dict[str, TileSet]:
    """The "first", "middle" and "last" tilesets of ``build_cf_tilesets``
    taken from ``full`` and ``srt``, the TCSC_CF build of the same edges
    ``r``, ``c`` and its sorted edges (``build_tileset_sorted``): each
    phase masks the sorted edges instead of binning and sorting its
    subset again. The result is the same, byte for byte: the sort is
    stable with ties in input order, so filtering the sorted list gives
    the stably sorted filtered list; the phase masks hold a vertex class
    of each end, so a run of parallel edges is kept or dropped whole.
    Each phase renumbers and fills on its own, a ``tiles.cf_subset`` span
    (``phase``)."""
    part, mesh = full.part, full.mesh
    r = np.asarray(r, np.int64)
    c = np.asarray(c, np.int64)
    cls = classify_vertices(r, c, part.n_pad, mesh)
    regular_row = ~cls["source_row"][r]
    sink_col = cls["sink_col"][c]
    keeps = {"first": regular_row, "middle": regular_row & ~sink_col,
             "last": ~(regular_row & sink_col)}
    R, C, L = part.R, part.C, part.L
    out = {}
    for ph, keep in keeps.items():
        with timing.span("tiles.cf_subset", phase=ph):
            per_rows, per_cols, per_w = [], [], []
            rows_mask = np.zeros((R, C * L), dtype=bool)
            cols_mask = np.zeros((C, R * L), dtype=bool)
            for b, idx in enumerate(srt.idx):
                i, j = divmod(b, C)
                m = keep[idx]
                sel = idx[m]
                blr, blc = part.local_row(r[sel]), part.local_col(c[sel])
                rows_mask[i, blr] = True
                cols_mask[j, blc] = True
                per_rows.append(blr)
                per_cols.append(blc)
                per_w.append(srt.w[b][m] if srt.w is not None else None)
            out[ph] = _fill(part, Compression.TCSC_CF,
                            _group_masks(rows_mask, cols_mask,
                                         Compression.TCSC_CF, mesh),
                            per_rows, per_cols, per_w, srt.w is not None,
                            edge_align, weight_dtype, mesh)
    return out


def build_tileset(*args, **kwargs) -> TileSet:
    """Build the tiled, compressed representation from a host edge list:
    ``build_tileset_sorted``'s tileset alone."""
    return build_tileset_sorted(*args, **kwargs)[0]


def build_tileset_sorted(
    r: np.ndarray,
    c: np.ndarray,
    w: Optional[np.ndarray],
    part: Partition,
    compression: Compression = Compression.TCSC,
    parallel_edges: bool = True,
    edge_align: int = 1024,
    weight_dtype=np.int32,
    mesh: Optional[Mesh] = None,
) -> Tuple[TileSet, Optional[SortedEdges]]:
    """The tiled, compressed representation of a host edge list (global,
    already transformed row/col ids; ``w`` optional weights), and, for
    TCSC_CF, its sorted edges, from which ``build_cf_subsets`` takes the
    phases (None for the other compressions). Dedup of parallel edges
    keeps the minimum weight. ``mesh``: the ranks whose edge shares
    together make the matrix (see the module docstring); None on one
    process."""
    keep_sorted = compression == Compression.TCSC_CF
    with timing.span("tiles.masks"):
        R, C, L, D = part.R, part.C, part.L, part.D
        r = np.asarray(r, dtype=np.int64)
        c = np.asarray(c, dtype=np.int64)
        if r.size and (r.max() >= part.n_pad or c.max() >= part.n_pad):
            raise ValueError("vertex id exceeds padded space")

        dev = part.edge_device(r, c)
        lr = part.local_row(r)
        lc = part.local_col(c)
        i_e = dev // C  # mesh row of each edge
        j_e = dev % C   # mesh col of each edge

        # filtering: nnz-row mask per row group, nnz-col mask per col
        # group (reference: filter_vertices, matrix.hpp:861-1122)
        rows_mask = np.zeros((R, C * L), dtype=bool)
        rows_mask[i_e, lr] = True
        cols_mask = np.zeros((C, R * L), dtype=bool)
        cols_mask[j_e, lc] = True
        # each rank sees only its shard's edges: OR the partial bitvectors
        # (reference: the leader combine, matrix.hpp:990-1006)
        masks = _group_masks(rows_mask, cols_mask, compression, mesh)

    with timing.span("tiles.bin"):
        # per-device binning (native counting sort when available)
        if r.size and r.max() < (1 << 32) and c.max() < (1 << 32):
            order, counts = native.bin_edges(r, c, part.L, R, C)
        else:
            order = np.argsort(dev, kind="stable")
            counts = np.bincount(dev, minlength=D)
        lr_s, lc_s = lr[order], lc[order]
        w_s = w[order] if w is not None else None
        ends = np.cumsum(counts)
        starts = ends - counts

    with timing.span("tiles.sort"):
        per_rows, per_cols, per_w, per_idx = [], [], [], []
        for b in range(D):
            s, e = starts[b], ends[b]
            blr, blc = lr_s[s:e], lc_s[s:e]
            bw = w_s[s:e] if w_s is not None else None
            # sort by destination row, then col, ties in input order: the
            # JAX package's lexsort((blc, blr)) order, as one stable sort
            # of an int64 key (about half lexsort's time at RMAT-18)
            key = blr * np.int64(R * L) + blc
            o = np.argsort(key, kind="stable")
            blr, blc, key = blr[o], blc[o], key[o]
            bw = bw[o] if bw is not None else None
            bidx = order[s:e][o] if keep_sorted else None
            if not parallel_edges and blr.size:
                # dedup on (row, col), each run of one key (sorted) keeping
                # its least weight: the JAX package's two lexsorts in one
                # pass (fmin skips a NaN, which its sort puts last)
                keep = np.concatenate(([True], key[1:] != key[:-1]))
                if bw is not None:
                    bw = np.fmin.reduceat(bw, np.flatnonzero(keep))
                blr, blc = blr[keep], blc[keep]
                bidx = bidx[keep] if keep_sorted else None
            per_rows.append(blr)
            per_cols.append(blc)
            per_w.append(bw)
            per_idx.append(bidx)

    with timing.span("tiles.fill"):
        ts = _fill(part, compression, masks, per_rows, per_cols, per_w,
                   w is not None, edge_align, weight_dtype, mesh)
    srt = SortedEdges(per_idx, per_w if w is not None else None) \
        if keep_sorted else None
    return ts, srt


@dataclass
class _GroupMasks:
    """The nnz-row mask of each row group and the nnz-col mask of each
    col group, reduced over the mesh, and what is taken from them."""

    rows: np.ndarray                 # (R, C*L) bool
    cols: np.ndarray                 # (C, R*L) bool
    iv: np.ndarray                   # (R, C*L) row prefix renumbering
    jv: Optional[np.ndarray]         # (C, R*L) col renumbering, DCSC only
    nnzrows: np.ndarray              # (R,) int64
    nnzcols: np.ndarray              # (C,) int64


def _group_masks(rows_mask: np.ndarray, cols_mask: np.ndarray,
                 compression: Compression, mesh: Optional[Mesh]
                 ) -> _GroupMasks:
    """This rank's partial masks OR-combined over the mesh (reference: the
    leader combine, matrix.hpp:990-1006), and the prefix renumberings."""
    rows_mask = mh.global_or(rows_mask, mesh)
    cols_mask = mh.global_or(cols_mask, mesh)
    # prefix renumbering IV (reference: matrix.hpp:1044-1097); DCSC: the
    # col-side prefix renumbering JV (reference: DCSC_BASE::populate,
    # compressed_column.hpp:237-271)
    return _GroupMasks(
        rows=rows_mask, cols=cols_mask,
        iv=np.cumsum(rows_mask, axis=1, dtype=np.int64) - 1,
        jv=(np.cumsum(cols_mask, axis=1, dtype=np.int64) - 1
            if compression == Compression.DCSC else None),
        nnzrows=rows_mask.sum(axis=1).astype(np.int64),
        nnzcols=cols_mask.sum(axis=1).astype(np.int64))


def _fill(part: Partition, compression: Compression, masks: _GroupMasks,
          per_rows, per_cols, per_w, has_weight: bool, edge_align: int,
          weight_dtype, mesh: Optional[Mesh]) -> TileSet:
    """The padded (D, ...) tile arrays of each device's sorted local
    (row, col) edges and weights."""
    R, C, L, D = part.R, part.C, part.L, part.D
    rows_mask, cols_mask = masks.rows, masks.cols
    iv, jv = masks.iv, masks.jv
    nnzrows_grp, nnzcols_grp = masks.nnzrows, masks.nnzcols
    renumber = compression in (Compression.TCSC, Compression.TCSC_CF)
    renumber_cols = jv is not None
    per_nnz = [blr.size for blr in per_rows]
    # per-device counts are exact on the owning rank and zero (or,
    # from every edge, exact) elsewhere, so the global counts are
    # their max (reference invariant: matrix.hpp:802-804)
    per_nnz_g = mh.global_max(np.asarray(per_nnz, np.int64), mesh)
    nnz_total = int(per_nnz_g.sum())
    Ep = _round_up(int(max(int(per_nnz_g.max()) if per_nnz_g.size
                           else 0, 1)), edge_align)
    NR = _round_up(int(max(nnzrows_grp.max(), 1)), 128) if renumber \
        else C * L

    rows_arr = np.zeros((D, Ep), dtype=np.int32)
    cols_arr = np.zeros((D, Ep), dtype=np.int32)
    w_arr = np.zeros((D, Ep), dtype=weight_dtype) if has_weight \
        else None
    nnz_arr = np.zeros((D, 1), dtype=np.int32)
    ja_arr = np.zeros((D, NR + 1), dtype=np.int32)
    ir_arr = np.full((D, NR), C * L, dtype=np.int32) if renumber else None
    iv_arr = np.full((D, C * L), -1, dtype=np.int32) if renumber else None
    nnzrows_arr = np.zeros((D, 1), dtype=np.int32)
    nnzcols_arr = np.zeros((D, 1), dtype=np.int32)
    jc_arr = None
    if renumber_cols:
        NCp = _round_up(int(max(nnzcols_grp.max(), 1)), 128)
        jc_arr = np.zeros((D, NCp), dtype=np.int32)

    for b in range(D):
        i, j = divmod(b, C)
        n = per_nnz[b]
        blr, blc, bw = per_rows[b], per_cols[b], per_w[b]
        seg_ids = iv[i, blr] if renumber else blr
        rows_arr[b, :n] = seg_ids
        if n < Ep:  # pad with last valid id to keep sortedness
            rows_arr[b, n:] = seg_ids[-1] if n else 0
        if renumber_cols:
            cols_arr[b, :n] = jv[j, blc]
            nzc = np.flatnonzero(cols_mask[j])
            jc_arr[b, :nzc.size] = nzc
        else:
            cols_arr[b, :n] = blc
        if w_arr is not None and bw is not None:
            w_arr[b, :n] = bw
        nnz_arr[b, 0] = n
        nnzrows_arr[b, 0] = nnzrows_grp[i]
        nnzcols_arr[b, 0] = nnzcols_grp[j]
        ja_arr[b] = np.searchsorted(rows_arr[b, :n], np.arange(NR + 1))
        if renumber:
            nz = np.flatnonzero(rows_mask[i])
            ir_arr[b, :nz.size] = nz
            iv_arr[b] = np.where(rows_mask[i], iv[i], -1)

    # owner-segment masks: device (i, j) owns segment s = j*R + i
    i_own = np.zeros((D, L), dtype=bool)
    j_own = np.zeros((D, L), dtype=bool)
    for b in range(D):
        i, j = divmod(b, C)
        i_own[b] = rows_mask[i, j * L:(j + 1) * L]
        j_own[b] = cols_mask[j, i * L:(i + 1) * L]

    return TileSet(
        part=part, compression=compression, has_weight=has_weight,
        Ep=Ep, NR=NR, nnz_total=nnz_total,
        rows=rows_arr, cols=cols_arr, weights=w_arr, nnz=nnz_arr,
        ja=ja_arr, ir=ir_arr, iv_dense=iv_arr,
        nnzrows=nnzrows_arr, i_own=i_own, j_own=j_own,
        regular_own=i_own & j_own, source_own=i_own & ~j_own,
        sink_own=j_own & ~i_own, nnzcols=nnzcols_arr, jc=jc_arr,
        dev_nnz=per_nnz_g, mesh=mesh,
    )
