"""The blocked one-hot SpMV reduce: host plan, CUDA wrapper, plain torch
version, count.

Counterpart of ``graphtap_tpu/kernels/pallas_spmv.py`` (the port has no
Pallas; the name says what it computes). The ⊕-fold
``y[row] ⊕= contrib[e]`` over row-sorted edges (reference:
vertex_program.hpp:1162-1185) runs over a host regrouping of the edges by
128-row destination block (``RB``), each block's run padded to whole
chunks of ``CHUNK`` contributions:

  * ``PallasPlan`` / ``build_pallas_plan``: the port's copy of the plan,
    numpy only, byte-identical to the JAX package's;
  * ``segment_reduce`` (K5): the wrapper, which checks dtype, shape,
    device and contiguity, then runs the plain version for a CPU tensor or
    launches the hand-written Hopper kernel (``csrc/onehot.cu``) for a
    CUDA tensor — never a fallback; ``segment_reduce_plain`` is its plain
    torch version, which folds floats in the kernel's fixed order
    (``fold_order.py``), and ``LAUNCHES`` its launch count;
  * ``segment_reduce_gather`` (K5 from the plan): the same fold, whose
    contributions the kernel makes itself, x gathered by the plan's cols,
    ⊗ by its weights and the padding the ⊕-identity (the JAX package
    leaves those to XLA before K5), so no contribution array is built;
    the kernel reads the plan through ``gather_tables`` (each chunk's
    edges by col, with their places in the fold order;
    ``gather_tables_plain`` folds them as the kernel does); the CPU runs
    ``segment_reduce_gather_plain``, those contributions in plain torch
    (``gather_contrib``, which ``onehot_contrib`` runs too) and
    ``segment_reduce_plain``; ``LAUNCHES`` counts each kernel apart;
  * ``fold_tables``: K5's chunk list and scratch, the plan's weights in
    the value type where they are of another, and on the card the gather
    tables, kept in the device dict once per upload;
  * ``spmv_onehot``: K5 from the plan on x where the kernel knows the
    semiring's ⊗ (``Semiring.mul_kind``), else K5 on the contributions
    of the semiring's own ``mul``.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property
from typing import Dict, Optional

import numpy as np
import torch

from graphtap_tpu_torch.format.tiles import TileSet
from graphtap_tpu_torch.kernels import _cuda
from graphtap_tpu_torch.kernels.fold_order import (chunk_fold_plain,
                                                   chunk_lists, fold_args)
from graphtap_tpu_torch.kernels.fold_order import \
    fold_tables as _fold_tables
from graphtap_tpu_torch.kernels.panel_kernels import (_DTYPES, _MUL_KINDS,
                                                      _REDUCE_KINDS,
                                                      _REDUCE_OK, _on_cuda,
                                                      _stream)
from graphtap_tpu_torch.kernels.semiring import Semiring, _add_sat
from graphtap_tpu_torch.kernels.shuffle_kernels import _check, _check_values
from graphtap_tpu_torch.parallel import multihost as mh
from graphtap_tpu_torch.tools import timing

RB = 128          # rows per block = lane width
CHUNK = 2048      # contributions per chunk

# the ⊕ kinds K5 takes on each value type: the shared kinds, and f32 min
# and max (SSSP's float distances), which only K5 has been tested in
_K5_REDUCE_OK = {**_REDUCE_OK, torch.float32: ("sum", "min", "max")}

# launches of the CUDA kernels, K5 from contributions and K5 from the plan
# (the plain versions are not counted)
LAUNCHES = {"segment_reduce": 0, "segment_reduce_gather": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@dataclass
class PallasPlan:
    """Host-side edge regrouping for the blocked reduce (arrays
    device-stacked, leading D axis, like TileSet fields; a shard's own
    plan has one row)."""
    Ep: int                   # padded edge-array length (multiple of CHUNK)
    nblocks: int              # number of RB-row blocks (NR rounded up)
    nchunks: int              # Ep // CHUNK
    lrows: np.ndarray         # (D, Ep) int32 row offset within block [0, RB)
    cols: np.ndarray          # (D, Ep) int32 local col (for the x gather)
    weights: Optional[np.ndarray]  # (D, Ep) or None
    evalid: np.ndarray        # (D, Ep) bool — real edge vs block padding
    chunk_block: np.ndarray   # (D, nchunks) int32 row block of each chunk

    @property
    def has_w(self) -> bool:
        return self.weights is not None

    @cached_property
    def col_bound(self) -> int:
        """One past the largest column the plan reads: the fewest values
        x may hold (read from ``cols`` once)."""
        return int(self.cols.max(initial=-1)) + 1

    @property
    def arrays(self) -> Dict[str, np.ndarray]:
        """The arrays the one-hot superstep reads, as the JAX executor
        uploads them (``_tile_pytree``)."""
        out = {"oh_lrows": self.lrows, "oh_cols": self.cols,
               "oh_evalid": self.evalid.astype(np.int8),
               "oh_chunk_block": self.chunk_block}
        if self.weights is not None:
            out["oh_w"] = self.weights
        return out


def build_pallas_plan(rows: np.ndarray, cols: np.ndarray,
                      weights: Optional[np.ndarray], nnz: np.ndarray,
                      NR: int) -> PallasPlan:
    """Regroup per-device row-sorted edge arrays into block-chunked form.

    ``rows``/``cols``/``weights``: (D, Ep_in); ``nnz``: (D, 1) valid counts.
    """
    D = rows.shape[0]
    nblocks = -(-NR // RB)
    per_dev = []
    max_len = 1
    for b in range(D):
        n = int(nnz[b, 0])
        r = rows[b, :n].astype(np.int64)
        blk = r // RB
        # pad each block's edge run to a multiple of CHUNK
        counts = np.bincount(blk, minlength=nblocks)
        padded = ((counts + CHUNK - 1) // CHUNK) * CHUNK
        # blocks with zero edges get zero chunks
        total = int(padded.sum())
        max_len = max(max_len, total)
        per_dev.append((n, r, blk, counts, padded))

    Ep = ((max_len + CHUNK - 1) // CHUNK) * CHUNK
    nchunks = Ep // CHUNK

    lrows = np.zeros((D, Ep), dtype=np.int32)
    cols_out = np.zeros((D, Ep), dtype=np.int32)
    w_out = np.zeros((D, Ep), dtype=weights.dtype) \
        if weights is not None else None
    evalid = np.zeros((D, Ep), dtype=bool)
    chunk_block = np.zeros((D, nchunks), dtype=np.int32)

    for b in range(D):
        n, r, blk, counts, padded = per_dev[b]
        starts_in = np.concatenate([[0], np.cumsum(counts)])
        starts_out = np.concatenate([[0], np.cumsum(padded)])
        # vectorized placement: output position of edge e
        pos = starts_out[blk] + (np.arange(n) - starts_in[blk])
        lrows[b, pos] = (r % RB).astype(np.int32)
        cols_out[b, pos] = cols[b, :n]
        if w_out is not None:
            w_out[b, pos] = weights[b, :n]
        evalid[b, pos] = True
        # chunk -> block map; trailing (all-padding) chunks point at the
        # last real block and contribute identity
        nch = (padded // CHUNK)
        cb = np.repeat(np.arange(nblocks), nch)
        chunk_block[b, :cb.size] = cb
        if cb.size < nchunks:
            chunk_block[b, cb.size:] = cb[-1] if cb.size else 0

    return PallasPlan(Ep=Ep, nblocks=nblocks, nchunks=nchunks,
                      lrows=lrows, cols=cols_out, weights=w_out,
                      evalid=evalid, chunk_block=chunk_block)


def build_onehot_plan(tiles: TileSet, value_dtype=None) -> PallasPlan:
    """The one-hot plan of this rank's shard of ``tiles``, validated
    (``value_dtype`` is unused: the plan keeps the tiles' weight type, as
    the JAX executor's does). On a mesh its length is the mesh's longest
    (``multihost.global_max``), so it equals row b of the JAX package's
    single-process plan: pad chunks hold no valid edge and point at the
    shard's last chunk's block. Every rank must call it."""
    b = mh.shard_of(tiles.part, tiles.mesh)
    rows = slice(b, b + 1)
    plan = build_pallas_plan(
        tiles.rows[rows], tiles.cols[rows],
        None if tiles.weights is None else tiles.weights[rows],
        tiles.nnz[rows], tiles.NR)
    ep = int(mh.global_max(plan.Ep, tiles.mesh))
    if ep > plan.Ep:
        pad = ep - plan.Ep

        def grow(a, fill=0):
            return np.concatenate([a, np.full((1, pad), fill, a.dtype)],
                                  axis=1)
        cb = plan.chunk_block
        plan = PallasPlan(
            Ep=ep, nblocks=plan.nblocks, nchunks=ep // CHUNK,
            lrows=grow(plan.lrows), cols=grow(plan.cols),
            weights=None if plan.weights is None else grow(plan.weights),
            evalid=grow(plan.evalid),
            chunk_block=np.concatenate(
                [cb, np.full((1, pad // CHUNK), cb[0, -1], cb.dtype)],
                axis=1))
    validate_pallas_plan(plan, tiles.part.tile_cols)
    return plan


def validate_pallas_plan(plan: PallasPlan, ncols: int) -> None:
    """Check every index the one-hot SpMV follows: lrows in [0, 128),
    chunk_block below nblocks, cols in [0, ncols), and the shapes of one
    shard's row (a leading axis of 1). Raises ValueError."""
    ep, nch = plan.Ep, plan.nchunks
    if plan.lrows.shape[0] != 1:
        raise ValueError("one-hot plan: one shard's row (a leading axis of "
                         "1) only")
    if ep != nch * CHUNK or plan.nblocks < 1:
        raise ValueError(f"one-hot plan: Ep {ep}, {nch} chunks, "
                         f"{plan.nblocks} blocks")
    for nm, a, shape in (("lrows", plan.lrows, (1, ep)),
                         ("cols", plan.cols, (1, ep)),
                         ("evalid", plan.evalid, (1, ep)),
                         ("chunk_block", plan.chunk_block, (1, nch))) + (
            (("weights", plan.weights, (1, ep)),)
            if plan.weights is not None else ()):
        if a.shape != shape:
            raise ValueError(f"one-hot plan: {nm} shape {a.shape}, "
                             f"expected {shape}")
    for nm, a, hi in (("lrows", plan.lrows, RB),
                      ("chunk_block", plan.chunk_block, plan.nblocks),
                      ("cols", plan.cols, ncols)):
        if a.size and (int(a.min()) < 0 or int(a.max()) >= hi):
            raise ValueError(f"one-hot plan: {nm} outside [0, {hi})")


# --------------------------------------------------------- plain version
def segment_reduce_plain(contrib, lrows, chunk_block, nblocks: int, NR: int,
                         reduce_kind: str, identity):
    """y (nblocks, 128): each chunk folds each lane's contributions in
    runs of RUN in index order, then the runs' results; then each block
    folds its chunks' lane partials in chunk order from the identity (the
    kernel's fixed order, ``fold_order.chunk_fold_plain``); returns
    y.reshape(-1)[:NR]."""
    return chunk_fold_plain(contrib, lrows, None, CHUNK, chunk_block,
                            nblocks, reduce_kind, identity).reshape(-1)[:NR]


# ---------------------------------------------------------------- wrapper
def segment_reduce(contrib, lrows, chunk_block, nblocks: int, NR: int,
                   reduce_kind: str, identity, lists=None, scratch=None):
    """K5: ⊕-fold the chunked contributions (Ep,) into the compact row
    space (NR,). Padding must carry the ⊕-identity (``spmv_onehot`` masks
    it); the kernel reads no validity mask, as the Pallas one reads none.
    Float sums fold in a fixed order, the plain version's, so a call gives
    the same bits every time; f32 min and max (exact in any order) keep
    that order too. ``lists``: the chunk list
    (``fold_order.chunk_lists(chunk_block, nblocks)``, built here if
    None); ``scratch``: the lists' and their runs' lane partials
    (allocated here if None); the plain version reads neither. Replaces
    ``pallas_spmv.py::pallas_segment_reduce``."""
    _check_values("contrib", contrib)
    dev = contrib.device
    _check("chunk_block", chunk_block, torch.int32, device=dev)
    if chunk_block.dim() != 1:
        raise ValueError("chunk_block: expected a 1-D tensor")
    nchunks = chunk_block.shape[0]
    ep = nchunks * CHUNK
    _check("contrib", contrib, None, (ep,), dev)
    _check("lrows", lrows, torch.int32, (ep,), dev)
    if reduce_kind not in _K5_REDUCE_OK[contrib.dtype]:
        raise ValueError(f"segment_reduce: {reduce_kind} on {contrib.dtype}")
    if not 0 <= NR <= nblocks * RB:
        raise ValueError(f"NR {NR} outside [0, {nblocks * RB}]")
    if not _on_cuda(contrib):
        return segment_reduce_plain(contrib, lrows, chunk_block, nblocks,
                                    NR, reduce_kind, identity)
    if lists is None:
        lists = chunk_lists(chunk_block, nblocks)
    rptr, gptr, chunks, part, gpart = fold_args(
        lists, scratch, nblocks, lists[2].shape[0], contrib.dtype, dev)
    lib = _cuda.library()
    y = torch.empty((nblocks * RB,), dtype=contrib.dtype, device=dev)
    with torch.cuda.device(dev):
        rc = lib.gt_segment_reduce(
            contrib.data_ptr(), lrows.data_ptr(), chunks.data_ptr(),
            rptr.data_ptr(), gptr.data_ptr(), part.data_ptr(),
            gpart.data_ptr(), y.data_ptr(), chunks.shape[0], nblocks,
            gptr.shape[0] - 1,
            _DTYPES[contrib.dtype], _REDUCE_KINDS[reduce_kind],
            float(identity), _stream(contrib))
    LAUNCHES["segment_reduce"] += 1
    _cuda.check(rc, "segment_reduce")
    return y[:NR]


def gather_contrib(x, cols, evalid, weights, mul, identity):
    """Per-slot ``mul(x[cols], weights)``, the padding slots (evalid 0)
    the ⊕-identity: the one-hot contributions in plain torch."""
    c = mul(torch.index_select(x, 0, cols), weights)
    return torch.where(evalid != 0, c,
                       torch.full((), identity, dtype=c.dtype,
                                  device=c.device))


def _kind_mul(mul_kind: str, identity):
    """The ⊗ ``mul_kind`` names ('none', 'mul' or 'add_sat', saturating
    at the identity), in the semirings' own torch ops."""
    if mul_kind == "mul":
        return lambda c, w: c * w
    if mul_kind == "add_sat":
        return lambda c, w: _add_sat(c, w, identity)
    return lambda c, w: c


def gather_tables(cols, evalid, lrows, weights, NC: int):
    """K5 from the plan's gather tables, from the plan's slots (chunks of
    CHUNK consecutive slots): (ecol, edest, ew, eptr, lcount). ``lcount``
    (nchunks, 128) int16: each chunk's slots of each lane, padding
    included. The slots that hold an edge (``evalid`` set), by chunk and,
    within a chunk, by col (stably): ``ecol`` int32 their cols, ``edest``
    int16 their places in the chunk's fold order (by lane, then slot: the
    order K5 folds a chunk in), ``ew`` their weights (None without);
    ``eptr`` (nchunks + 1,) int32: chunk c's are ``eptr[c] ..
    eptr[c + 1] - 1``. ``NC``: past the largest col. Two stable sorts on
    the slots' device (int32 keys where they fit, the temporaries let go
    as soon as they are used); the edge count is read back once."""
    dev, nch = cols.device, cols.shape[0] // CHUNK
    slot = torch.arange(cols.shape[0], dtype=torch.int32, device=dev)
    chunk = slot // CHUNK
    key = chunk * RB + lrows
    dest = torch.empty(cols.shape[0], dtype=torch.int16, device=dev)
    dest[torch.sort(key, stable=True).indices] = (slot % CHUNK).to(
        torch.int16)
    lcount = torch.bincount(key, minlength=nch * RB).view(nch, RB)
    del slot, key
    edge = torch.nonzero(evalid).squeeze(1)
    edge = edge[torch.sort(chunk[edge].long() * max(NC, 1) + cols[edge],
                           stable=True).indices]
    eptr = torch.zeros(nch + 1, dtype=torch.int32, device=dev)
    eptr[1:] = torch.cumsum(torch.bincount(chunk[edge], minlength=nch), 0)
    return (cols[edge], dest[edge], None if weights is None
            else weights[edge], eptr, lcount.to(torch.int16))


def gather_tables_plain(x, tables, chunk_block, nblocks: int, NR: int,
                        reduce_kind: str, mul_kind: str, identity):
    """K5 from the plan as its kernel runs it from ``gather_tables``, in
    plain torch: each chunk's fold order filled with the ⊕-identity, each
    edge's x[ecol] ⊗ ew placed at edest, then folded lane by lane
    (``chunk_fold_plain`` on the lane-sorted values); equals
    ``segment_reduce_gather_plain`` of the plan bit for bit."""
    ecol, edest, ew, eptr, lcount = tables
    nch = lcount.shape[0]
    val = torch.full((nch, CHUNK), identity, dtype=x.dtype, device=x.device)
    echunk = torch.repeat_interleave(
        torch.arange(nch, device=x.device), (eptr[1:] - eptr[:-1]).long())
    val[echunk, edest.long()] = _kind_mul(mul_kind, identity)(
        torch.index_select(x, 0, ecol), ew)
    lanes = torch.repeat_interleave(
        torch.arange(RB, device=x.device).repeat(nch),
        lcount.reshape(-1).long())
    return chunk_fold_plain(val.reshape(-1), lanes, None, CHUNK, chunk_block,
                            nblocks, reduce_kind, identity).reshape(-1)[:NR]


def segment_reduce_gather_plain(x, cols, evalid, weights, lrows, chunk_block,
                                nblocks: int, NR: int, NC: int,
                                reduce_kind: str, mul_kind: str, identity):
    """``segment_reduce_plain`` of ``gather_contrib``'s contributions by
    the ⊗ ``mul_kind`` names (``NC`` is not read: the gather checks x)."""
    return segment_reduce_plain(
        gather_contrib(x, cols, evalid, weights,
                       _kind_mul(mul_kind, identity), identity),
        lrows, chunk_block, nblocks, NR, reduce_kind, identity)


def segment_reduce_gather(x, cols, evalid, weights, lrows, chunk_block,
                          nblocks: int, NR: int, NC: int, reduce_kind: str,
                          mul_kind: str, identity, lists=None, scratch=None,
                          tables=None):
    """K5 from the plan: ⊕-fold x[cols[e]] ⊗ weights[e] (the padding,
    evalid 0, the ⊕-identity) into the compact row space (NR,), in K5's
    order, so the result is ``segment_reduce`` of the same contributions
    bit for bit; no contribution array is made. x (NC,) of the values'
    type; cols and lrows int32 and evalid int8 of the plan's length;
    weights of x's type, present exactly when ``mul_kind`` is not 'none'.
    ``NC``: the plan's ``col_bound``, which x must reach; the cols are not
    read back here (``validate_pallas_plan`` held them below the column
    count). ``lists``, ``scratch``: as ``segment_reduce``; ``tables``:
    ``gather_tables`` of the plan (built here if None), which the card's
    kernel reads in place of cols, evalid, lrows and weights. On the card
    one launch counts as ``segment_reduce_gather``'s and adds the plan's
    length to the open tracer's ``onehot_gathered_slots``."""
    _check_values("x", x)
    if x.dim() != 1:
        raise ValueError(f"x: expected a 1-D tensor, got {tuple(x.shape)}")
    dev = x.device
    _check("x", x, None, device=dev)
    if x.shape[0] < NC:
        raise ValueError(f"x: {x.shape[0]} values, but the plan reads "
                         f"columns below {NC}")
    _check("chunk_block", chunk_block, torch.int32, device=dev)
    if chunk_block.dim() != 1:
        raise ValueError("chunk_block: expected a 1-D tensor")
    ep = chunk_block.shape[0] * CHUNK
    _check("cols", cols, torch.int32, (ep,), dev)
    _check("evalid", evalid, torch.int8, (ep,), dev)
    _check("lrows", lrows, torch.int32, (ep,), dev)
    if mul_kind not in _MUL_KINDS:
        raise ValueError(f"mul_kind {mul_kind!r}")
    if (weights is None) != (mul_kind == "none"):
        raise ValueError(f"mul_kind {mul_kind!r} with weights "
                         f"{'absent' if weights is None else 'given'}")
    if weights is not None:
        _check("weights", weights, x.dtype, (ep,), dev)
    if reduce_kind not in _K5_REDUCE_OK[x.dtype]:
        raise ValueError(f"segment_reduce_gather: {reduce_kind} on "
                         f"{x.dtype}")
    if not 0 <= NR <= nblocks * RB:
        raise ValueError(f"NR {NR} outside [0, {nblocks * RB}]")
    if not _on_cuda(x):
        return segment_reduce_gather_plain(x, cols, evalid, weights, lrows,
                                           chunk_block, nblocks, NR, NC,
                                           reduce_kind, mul_kind, identity)
    if lists is None:
        lists = chunk_lists(chunk_block, nblocks)
    rptr, gptr, chunks, part, gpart = fold_args(
        lists, scratch, nblocks, lists[2].shape[0], x.dtype, dev)
    if tables is None:
        tables = gather_tables(cols, evalid, lrows, weights, NC)
    ecol, edest, ew, eptr, lcount = tables
    nch = chunk_block.shape[0]
    nedges = ecol.shape[0]
    for name, t, dtype, shape in (
            ("ecol", ecol, torch.int32, (nedges,)),
            ("edest", edest, torch.int16, (nedges,)),
            ("eptr", eptr, torch.int32, (nch + 1,)),
            ("lcount", lcount, torch.int16, (nch, RB))):
        _check(name, t, dtype, shape, dev)
    if (ew is None) != (weights is None):
        raise ValueError("gather tables: ew present exactly with weights")
    if ew is not None:
        _check("ew", ew, x.dtype, (nedges,), dev)
    lib = _cuda.library()
    y = torch.empty((nblocks * RB,), dtype=x.dtype, device=dev)
    with torch.cuda.device(dev):
        rc = lib.gt_segment_reduce_gather(
            x.data_ptr(), ecol.data_ptr(), edest.data_ptr(),
            None if ew is None else ew.data_ptr(), eptr.data_ptr(),
            lcount.data_ptr(), chunks.data_ptr(), rptr.data_ptr(),
            gptr.data_ptr(), part.data_ptr(), gpart.data_ptr(), y.data_ptr(),
            chunks.shape[0], nblocks, gptr.shape[0] - 1, _DTYPES[x.dtype],
            _MUL_KINDS[mul_kind], _REDUCE_KINDS[reduce_kind],
            float(identity), _stream(x))
    LAUNCHES["segment_reduce_gather"] += 1
    _cuda.check(rc, "segment_reduce_gather")
    timing.count("onehot_gathered_slots", ep)
    return y[:NR]


def plan_weights(t: Dict[str, torch.Tensor], dtype):
    """The plan's weights (``oh_w``) in the value type ``dtype``, or None:
    ``oh_w`` itself, or its copy in ``dtype`` (``oh_wv``), made once where
    torch's promotion of the two types already gives ``dtype`` (so the ⊗
    rounds as before: an int32 weight by an f32 value, an f32 weight by an
    f64 one); any other pair raises TypeError."""
    w = t.get("oh_w")
    if w is None or w.dtype == dtype:
        return w
    if torch.promote_types(w.dtype, dtype) != dtype:
        raise TypeError(f"one-hot plan: {w.dtype} weights by {dtype} "
                        f"values do not give {dtype}")
    wv = t.get("oh_wv")
    if wv is None or wv.dtype != dtype:
        wv = t["oh_wv"] = w.to(dtype)
    return wv


_GATHER_KEYS = ("oh_ecol", "oh_edest", "oh_ew", "oh_eptr", "oh_lcount")


def fold_tables(t: Dict[str, torch.Tensor], plan: PallasPlan, dtype):
    """K5's chunk list and scratch, the plan's weights in ``dtype``
    (``plan_weights``) and, on the card, K5 from the plan's
    ``gather_tables`` (``oh_ecol``, ...), kept in ``t`` (once per upload;
    the tables anew for weights of another type); returns
    segment_reduce's (lists, scratch) arguments."""
    w = plan_weights(t, dtype)
    ew = t.get("oh_ew")
    if t["oh_cols"].is_cuda and ("oh_ecol" not in t or (
            w is not None and (ew is None or ew.dtype != w.dtype))):
        tabs = gather_tables(t["oh_cols"], t["oh_evalid"], t["oh_lrows"], w,
                             plan.col_bound)
        t.update((k, v) for k, v in zip(_GATHER_KEYS, tabs)
                 if v is not None)
    return _fold_tables(t, "oh", lambda: chunk_lists(t["oh_chunk_block"],
                                                      plan.nblocks), dtype)


def onehot_contrib(x: torch.Tensor, t: Dict[str, torch.Tensor],
                   semiring: Semiring) -> torch.Tensor:
    """Per-slot x[cols] ⊗ w by the semiring's own ``mul``, the padding
    slots the ⊕-identity: K5's input on its own."""
    return gather_contrib(x, t["oh_cols"], t["oh_evalid"], t.get("oh_w"),
                          semiring.mul, semiring.identity)


def spmv_onehot(x: torch.Tensor, t: Dict[str, torch.Tensor],
                plan: PallasPlan, semiring: Semiring,
                NR: int) -> torch.Tensor:
    """One-device one-hot SpMV: x (NC,) -> the compact y (NR,): K5 from
    the plan where the kernel knows the semiring's ⊗
    (``Semiring.mul_kind``), else K5 on ``onehot_contrib``'s
    contributions."""
    folds = fold_tables(t, plan, x.dtype)
    if semiring.mul_kind is None:
        return segment_reduce(onehot_contrib(x, t, semiring), t["oh_lrows"],
                              t["oh_chunk_block"], plan.nblocks, NR,
                              semiring.reduce_kind, semiring.identity,
                              **folds)
    w = plan_weights(t, x.dtype)
    tables = (tuple(t.get(k) for k in _GATHER_KEYS) if "oh_ecol" in t
              else None)
    return segment_reduce_gather(x, t["oh_cols"], t["oh_evalid"], w,
                                 t["oh_lrows"], t["oh_chunk_block"],
                                 plan.nblocks, NR, plan.col_bound,
                                 semiring.reduce_kind,
                                 "none" if w is None else semiring.mul_kind,
                                 semiring.identity, tables=tables, **folds)
