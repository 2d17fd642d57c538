"""The fixed fold order of the port's float ⊕-folds (K3, K5, K8).

The Pallas kernels fold in sequential grid order, so a float sum comes
out the same on every call. The CUDA kernels first folded with unordered
atomics, so an f32 sum moved by an ulp from call to call, and PageRank's
absolute convergence vote (``abs(new - old) > tol``) never closed where a
rank's ulp exceeds tol. They now fold in a fixed order, in two passes:

  (a) K3: each routed 8-row band folds its entries into 128 lane
      partials, in index order, into a scratch table. K5 and K8: each
      chunk folds the entries of each lane in two levels: the lane's
      entries, taken in index order, are cut into runs of RUN (the
      lane's last run fewer); each run folds from the ⊕-identity, then
      the lane folds its runs' results in order from the ⊕-identity. A
      hub chunk (2,048 entries of one lane in K5) so folds in a chain of
      RUN + 64 steps, not 2,048, and its runs spread over 64 threads;
  (b) each (row, lane) of y folds the partials of its row, taken in
      list order, in two levels: each run of up to GROUP consecutive
      partials of the row's list is folded from the ⊕-identity, then
      the row folds its runs' results in order from the ⊕-identity and
      writes y once. A hub row's list (hundreds of chunks on an RMAT-20
      degree SpMV) is so cut into a chain of GROUP loads and one of
      len/GROUP; a list of at most GROUP partials folds as one
      sequential fold (the identity changes no value).

Folding the ⊕-identity changes no bits at any position: a sum starts
from +0.0, so its accumulator is never -0.0, and x + 0.0 == x for every
other x; min and max return the other operand. So where padding (which
carries the identity) falls in the order does not matter, and a chunk
left out of a list (K8's chunks with no valid slot) leaves its row's
other partials' runs to be cut anew, which the plain version does too.

``fold_lists`` builds K3's lists of pass (b) from each partial's target
row, once per upload: the partials in list order (``idx``), the runs'
starts in it (``gptr``) and each row's first run (``rptr``);
``row_lists`` the same lists without the runs, for K13, which folds each
row's chunks as one chain in ascending chunk order, the Pallas grid's.
``chunk_lists`` builds K5's and K8's in the same form, with ``idx`` the
chunks by row block, in chunk order, the chunks that hold no kept entry
left out and one null item (-1, identity partials) for a row block left
with none; pass (a) runs over that list, so a list position is its
partial's index. ``ordered_fold`` is the plain torch version of one sequential
fold, ``list_fold`` composes it into pass (b), ``lane_partials`` into
K5's and K8's pass (a) and ``chunk_fold_plain`` into their two passes,
in the kernels' order, so the kernels can be held against their plain
versions bit for bit. ``fold_tables`` keeps a fold's lists and scratch
in a device dict, so the executor builds them once and counts them in
its ``device_bytes``.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

LANES = 128
GROUP = 64          # partials per run of pass (b)'s first level
RUN = 32            # entries per run of K5's and K8's pass (a)

_OPS = {"sum": torch.add, "min": torch.minimum, "max": torch.maximum}
_SCATTER = {"sum": "sum", "min": "amin", "max": "amax"}


def fold_lists(target: torch.Tensor, nrows: int
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(rptr (nrows + 1,), gptr (ngroups + 1,), idx (n,)), int32, on
    target's device. ``idx`` lists the partials by target row, ascending
    within a row; run g covers ``idx[gptr[g]:gptr[g + 1]]`` (GROUP
    partials, the row's last run fewer); row r's runs are ``rptr[r] ..
    rptr[r + 1] - 1``. Raises ValueError if a target lies outside [0,
    nrows)."""
    t = target.long().reshape(-1)
    if t.numel() and (int(t.min()) < 0 or int(t.max()) >= nrows):
        raise ValueError(f"fold target outside [0, {nrows})")
    dev = t.device
    idx = torch.sort(t, stable=True).indices
    counts = torch.bincount(t, minlength=nrows)
    runs = (counts + GROUP - 1) // GROUP
    ptr = torch.zeros(nrows + 1, dtype=torch.long, device=dev)
    ptr[1:] = torch.cumsum(counts, 0)
    rptr = torch.zeros(nrows + 1, dtype=torch.long, device=dev)
    rptr[1:] = torch.cumsum(runs, 0)
    grow = torch.repeat_interleave(torch.arange(nrows, device=dev), runs)
    gstart = ptr[grow] + (torch.arange(grow.numel(), device=dev)
                          - rptr[grow]) * GROUP
    gptr = torch.cat([gstart, ptr[-1:]])
    return rptr.to(torch.int32), gptr.to(torch.int32), idx.to(torch.int32)


def row_lists(target: torch.Tensor, nrows: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ptr (nrows + 1,), idx (n,)), int32: ``fold_lists`` without its
    runs, for a fold that takes each row's list as one sequential chain
    (K13, the Pallas grid's order): row r's partials are ``idx[ptr[r]:
    ptr[r + 1]]``, ascending."""
    rptr, gptr, idx = fold_lists(target, nrows)
    return gptr[rptr.long()].contiguous(), idx


def fold_args(lists, scratch, nrows: int, nparts: int, dtype, device):
    """(rptr, gptr, idx, part, gpart) of one launch: ``lists`` (K3's
    ``fold_lists``, K5's and K8's ``chunk_lists``) and ``scratch`` (the
    (nparts, 128) and (ngroups, 128) partials of ``dtype``, allocated
    here if None), checked. The list values are not read back: the
    builder checked them."""
    rptr, gptr, idx = lists
    ngroups = gptr.shape[0] - 1
    for name, t, n in (("rptr", rptr, nrows + 1), ("gptr", gptr, ngroups + 1),
                       ("idx", idx, nparts)):
        if (not isinstance(t, torch.Tensor) or t.dtype != torch.int32
                or tuple(t.shape) != (n,) or not t.is_contiguous()
                or t.device != device):
            raise ValueError(f"fold {name}: expected a contiguous ({n},) "
                             f"int32 tensor on {device}")
    if scratch is None:
        scratch = tuple(torch.empty((n, LANES), dtype=dtype, device=device)
                        for n in (nparts, ngroups))
    for name, t, n in zip(("part", "gpart"), scratch, (nparts, ngroups)):
        if (t.dtype != dtype or tuple(t.shape) != (n, LANES)
                or not t.is_contiguous() or t.device != device):
            raise ValueError(f"fold {name}: expected a contiguous ({n}, "
                             f"{LANES}) {dtype} tensor on {device}")
    return (rptr, gptr, idx) + tuple(scratch)


def fold_tables(t: Dict[str, torch.Tensor], prefix: str, build, dtype):
    """Keep one fold's tables in the device dict ``t`` (the executor's
    upload, or any meta's tensors): ``<prefix>_frptr``, ``_fgptr`` and
    ``_fidx``, the lists ``build()`` gives (``fold_lists`` or
    ``chunk_lists``), built once, and the scratch partials
    ``<prefix>_fpart`` (len(idx), 128) and ``_fgpart`` (ngroups, 128) of
    ``dtype`` (made anew for another dtype). Returns the wrappers'
    (lists, scratch) keyword arguments."""
    keys = [prefix + k for k in ("_frptr", "_fgptr", "_fidx")]
    if keys[0] not in t:
        for k, v in zip(keys, build()):
            t[k] = v
    lists = tuple(t[k] for k in keys)
    scratch = []
    for k, n in (("_fpart", lists[2].shape[0]),
                 ("_fgpart", lists[1].shape[0] - 1)):
        part = t.get(prefix + k)
        if part is None or part.dtype != dtype:
            part = t[prefix + k] = torch.empty((n, LANES), dtype=dtype,
                                               device=lists[0].device)
        scratch.append(part)
    return {"lists": lists, "scratch": tuple(scratch)}


def ordered_fold(vals: torch.Tensor, seg: torch.Tensor, nseg: int,
                 reduce_kind: str, identity) -> torch.Tensor:
    """(nseg, *vals.shape[1:]): out[s] = identity ⊕ vals[i0] ⊕ vals[i1]
    ⊕ ... over the i with seg[i] == s, folded one at a time in ascending
    i, as the CUDA folds do. Integer ⊕ (two's-complement sum, min, max)
    gives the same bits in any order, so integers take one scatter_reduce.
    On the CPU, ``torch.segment_reduce`` over the stably sorted values is
    that fold in one call (it folds each segment one value at a time from
    ``initial``). Elsewhere the fold is vectorized over the rank of each i
    within its segment: one step per rank, each updating distinct
    segments (``_fold_by_rank``)."""
    out = torch.full((nseg,) + tuple(vals.shape[1:]), identity,
                     dtype=vals.dtype, device=vals.device)
    s = seg.long().reshape(-1)
    if s.numel() == 0:
        return out
    if not vals.dtype.is_floating_point:
        idx = s.view((-1,) + (1,) * (vals.dim() - 1)).expand(vals.shape)
        return out.scatter_reduce_(0, idx, vals, _SCATTER[reduce_kind])
    order = torch.sort(s, stable=True).indices
    if vals.device.type == "cpu":
        return torch.segment_reduce(
            vals[order], reduce_kind,
            lengths=torch.bincount(s, minlength=nseg), initial=identity)
    return _fold_by_rank(out, vals, s, order, reduce_kind)


def _fold_by_rank(out, vals, s, order, reduce_kind: str):
    """``ordered_fold`` off the CPU: out[s[i]] ⊕= vals[i], one step per
    rank of i within its segment (``order`` sorts s stably), each step
    updating distinct segments."""
    ss = s[order]
    rank = (torch.arange(s.numel(), device=s.device)
            - torch.searchsorted(ss, ss, side="left"))
    perm = order[torch.sort(rank, stable=True).indices]
    counts = torch.bincount(rank).tolist()
    for sel, tgt in zip(torch.split(perm, counts),
                        torch.split(s[perm], counts)):
        if reduce_kind == "sum":        # distinct targets: one add each
            out.index_add_(0, tgt, vals[sel])
        else:
            out[tgt] = _OPS[reduce_kind](out[tgt], vals[sel])
    return out


def list_fold(parts: torch.Tensor, target: torch.Tensor, nrows: int,
              reduce_kind: str, identity) -> torch.Tensor:
    """Pass (b), plain: (nrows, *parts.shape[1:]), each row folding the
    parts i with ``target[i] == r`` in the kernels' two-level order
    (``fold_lists``): runs of GROUP from the identity, then the runs'
    results in order from the identity."""
    rptr, gptr, idx = (a.long() for a in fold_lists(target, nrows))
    ngroups = gptr.numel() - 1
    gid = torch.repeat_interleave(torch.arange(ngroups, device=idx.device),
                                  gptr[1:] - gptr[:-1])
    runs = ordered_fold(parts[idx], gid, ngroups, reduce_kind, identity)
    grow = torch.repeat_interleave(torch.arange(nrows, device=idx.device),
                                   rptr[1:] - rptr[:-1])
    return ordered_fold(runs, grow, nrows, reduce_kind, identity)


def _chunk_items(chunk_block: torch.Tensor, nblocks: int, live=None):
    """(chunk (nitems,), row (nitems,)), int64: ``chunk_lists``' items."""
    cb = chunk_block.long().reshape(-1)
    if cb.numel() and (int(cb.min()) < 0 or int(cb.max()) >= nblocks):
        raise ValueError(f"chunk_block outside [0, {nblocks})")
    dev = cb.device
    keep = (torch.arange(cb.numel(), device=dev) if live is None
            else torch.nonzero(live.reshape(-1)).squeeze(1))
    has = torch.zeros(nblocks, dtype=torch.bool, device=dev)
    has[cb[keep]] = True
    empty = torch.nonzero(~has).squeeze(1)
    row = torch.cat([cb[keep], empty])
    order = torch.sort(row, stable=True).indices
    return torch.cat([keep, torch.full_like(empty, -1)])[order], row[order]


def chunk_lists(chunk_block: torch.Tensor, nblocks: int, live=None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K5's and K8's lists (rptr, gptr, chunks), int32, on chunk_block's
    device: ``chunks`` (nitems,) the chunks by row block, ascending
    within a block, leaving out the chunks where ``live`` is False (None:
    none left out), and one null item -1 for a row block left with no
    chunk; ``rptr`` (nblocks + 1,) and ``gptr`` (ngroups + 1,) cut the
    list positions into pass (b)'s runs (``fold_lists`` of the items'
    rows). Raises ValueError if a chunk_block entry lies outside [0,
    nblocks)."""
    chunk, row = _chunk_items(chunk_block, nblocks, live)
    rptr, gptr, _ = fold_lists(row, nblocks)
    return rptr, gptr, chunk.to(torch.int32)


def _kept(contrib, lanes, keep, chunk: int, nchunks: int):
    """The kept entries' values and (chunk * 128 + lane) segments, in
    index order."""
    n = nchunks * chunk
    c = contrib.reshape(-1)[:n]
    seg = (torch.arange(n, device=c.device) // chunk * LANES
           + lanes.reshape(-1)[:n].long())
    if keep is not None:
        k = keep.reshape(-1)[:n]
        c, seg = c[k], seg[k]
    return c, seg


def _ranks(seg: torch.Tensor):
    """(order, seg[order], rank): ``order`` sorts seg stably, and rank is
    each sorted entry's place among the entries of its segment."""
    order = torch.sort(seg, stable=True).indices
    ss = seg[order]
    rank = (torch.arange(ss.numel(), device=ss.device)
            - torch.searchsorted(ss, ss, side="left"))
    return order, ss, rank


def lane_partials(contrib, lanes, keep, chunk: int, nchunks: int,
                  reduce_kind: str, identity) -> torch.Tensor:
    """Pass (a) of K5 and K8, plain: (nchunks, 128), the kept entries
    (``keep``; None: all) of each chunk of ``chunk`` consecutive entries
    folded into lane ``lanes[e]`` in two levels: runs of RUN of the
    lane's entries in index order, each from the identity, then the
    runs' results in order from the identity."""
    c, seg = _kept(contrib, lanes, keep, chunk, nchunks)
    if seg.numel() == 0:
        return torch.full((nchunks, LANES), identity, dtype=contrib.dtype,
                          device=contrib.device)
    order, ss, rank = _ranks(seg)
    key = ss * (chunk // RUN + 1) + rank // RUN
    first = torch.ones_like(key, dtype=torch.bool)
    first[1:] = key[1:] != key[:-1]
    run = torch.cumsum(first, 0) - 1
    runs = ordered_fold(c[order], run, run.numel() and int(run[-1]) + 1,
                        reduce_kind, identity)
    return ordered_fold(runs, ss[first], nchunks * LANES, reduce_kind,
                        identity).view(nchunks, LANES)


def chunk_fold_plain(contrib: torch.Tensor, lanes: torch.Tensor,
                     keep, chunk: int, chunk_block: torch.Tensor,
                     nblocks: int, reduce_kind: str,
                     identity) -> torch.Tensor:
    """K5's and K8's fold, (nblocks, 128): pass (a), each chunk of
    ``chunk`` consecutive entries folds the ones ``keep`` marks (None:
    all) into lane ``lanes[e]`` (``lane_partials``); pass (b), each row
    block folds its list's lane partials in list order (``list_fold``).
    The list (``chunk_lists``) leaves out the chunks with no kept entry
    where ``keep`` is given, as K8's does."""
    nchunks = chunk_block.shape[0]
    part = lane_partials(contrib, lanes, keep, chunk, nchunks, reduce_kind,
                         identity)
    live = (None if keep is None else
            keep.reshape(-1)[:nchunks * chunk].view(nchunks, chunk).any(1))
    chunk_id, row = _chunk_items(chunk_block, nblocks, live)
    parts = torch.where((chunk_id >= 0)[:, None],
                        part[chunk_id.clamp(min=0)],
                        torch.tensor(identity, dtype=part.dtype,
                                     device=part.device))
    return list_fold(parts, row, nblocks, reduce_kind, identity)

