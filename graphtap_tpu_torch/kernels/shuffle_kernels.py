"""The v1 shuffle-SpMV kernels: CUDA wrappers, plain torch versions, counts.

Counterpart of ``graphtap_tpu/kernels/shuffle_kernels.py``. Each of its
three Pallas kernels has here

  * a wrapper (``expand_stream``, ``group_stream``, ``grouped_reduce``)
    that checks dtype, shape, device and contiguity, then runs the plain
    version for a CPU tensor or launches the hand-written Hopper kernel
    (``csrc/shuffle.cu``) for a CUDA tensor — never a fallback;
  * a plain torch version (``*_plain``) of the same function, which the
    CPU tests hold against the Pallas kernels and the ``gpu`` tests
    (``tests/test_torch_cuda.py``) hold against the CUDA kernels;
  * a launch count in ``LAUNCHES``, incremented only where the wrapper
    launches the CUDA kernel.

K7's radix passes compose: each moves every occupied slot of a super to
one slot of the same super, so the whole regroup is one gather,
``grouped[d] = contrib[src[d]]`` (``src[d] = -1``: the fill).
``group_index`` composes the passes' plan bytes into ``src``, and
``group_tables`` keeps it in the plan tensors once per upload; the CUDA
kernel is that gather, one launch per call. K8's float sums fold in a
fixed order (``fold_order.py``), which its plain version follows;
``reduce_tables`` keeps its chunk list (the chunks with a valid slot, by
row block) and scratch in the plan tensors once per upload, with the
stamp of the ev_r it came from, which ``grouped_reduce`` checks.

The plans come from ``kernels/shuffle_plan.py``; ``shuffle_engine.
validate_shuffle_plans`` checks every index the kernels follow before a
plan reaches the card.
"""

from __future__ import annotations

import torch

from graphtap_tpu_torch.kernels import _cuda
from graphtap_tpu_torch.kernels.fold_order import (chunk_fold_plain,
                                                   chunk_lists, fold_args,
                                                   fold_tables)
from graphtap_tpu_torch.kernels.panel_kernels import (_DTYPES, _MUL_KINDS,
                                                      _REDUCE_KINDS,
                                                      _REDUCE_OK, _on_cuda,
                                                      _stream)
from graphtap_tpu_torch.kernels.shuffle_plan import LANES, RED_ROWS, SUB, \
    WROWS

# launches of each CUDA kernel (the plain versions are not counted)
LAUNCHES = {"expand_stream": 0, "group_stream": 0, "grouped_reduce": 0}
# K7's composed index is int32: a stream of this many slots or more
# does not fit
INDEX_LIMIT = 2 ** 31


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# --------------------------------------------------------- plain versions
def expand_stream_plain(x3d, grp, slot, lane, evalid, weights, fill,
                        mul_kind: str = "none"):
    """out[r, l] = ev[r, l] ? x3d[grp[r // 8], slot[r, l], lane[r, l]] ⊗
    w[r, l] : fill."""
    rows = slot.shape[0]
    win = grp[:rows // SUB].long().repeat_interleave(SUB)
    src = (win[:, None] * WROWS + slot.long()) * LANES + lane.long()
    acc = x3d.reshape(-1)[src]
    f = torch.tensor(fill, dtype=acc.dtype, device=acc.device)
    if mul_kind == "mul":
        acc = acc * weights
    elif mul_kind == "add_sat":
        acc = torch.where(acc >= f, f, acc + weights)
    return torch.where(evalid != 0, acc, f)


def group_pass_plain(buf, frag_dst, frag_idx, p: int, rows_per_super: int,
                     fill):
    """Radix pass ``p`` over every super: out[s, frag_dst[s,p,r,j], l] =
    buf[s, r, frag_idx[s,p,r,j*128+l]] where both are >= 0; every other
    slot holds ``fill``."""
    nsup, _, rps, smax = frag_dst.shape
    d = frag_dst[:, p].long()                              # (S, rps, smax)
    idx = frag_idx[:, p].reshape(nsup, rps, smax, LANES).long()
    hit = (idx >= 0) & (d >= 0)[..., None]
    srow = (torch.arange(nsup, device=buf.device)[:, None] * rps
            + torch.arange(rps, device=buf.device)[None, :])
    src = (srow[:, :, None, None] * LANES + idx)[hit]
    lane = torch.arange(LANES, device=buf.device)
    drow = torch.arange(nsup, device=buf.device)[:, None, None] * rps + d
    dst = (drow[..., None] * LANES + lane)[hit]
    out = torch.full_like(buf, fill)
    out.view(-1)[dst] = buf.reshape(-1)[src]
    return out


def group_stream_plain(contrib, frag_dst, frag_idx, rows_per_super: int,
                       npasses: int, fill):
    buf = contrib
    for p in range(npasses):
        buf = group_pass_plain(buf, frag_dst, frag_idx, p, rows_per_super,
                               fill)
    return buf


def group_index(frag_dst, frag_idx, rows_per_super: int, npasses: int
                ) -> torch.Tensor:
    """K7's passes composed into one gather: the (nsupers * rps, 128) int32
    map ``src`` whose entry at a grouped slot is the flat contrib slot
    (row * 128 + lane) it holds after all ``npasses`` passes, -1 where no
    chain of passes writes it. Built from the plan bytes the kernels read:
    pass p moves slot (s*rps + r)*128 + frag_idx[s,p,r,j*128+l] to
    (s*rps + frag_dst[s,p,r,j])*128 + l where both are >= 0; a slot no pass
    writes holds the fill, so -1 propagates. Plain torch, on the plans'
    device. Raises ValueError for a stream of INDEX_LIMIT slots or more."""
    nsup, _, rps, smax = frag_dst.shape
    n = nsup * rps * LANES
    if n >= INDEX_LIMIT:
        raise ValueError(f"group_index: {n} stream slots do not fit an "
                         f"int32 index (limit {INDEX_LIMIT})")
    dev = frag_dst.device
    src = torch.arange(n, device=dev)
    for p in range(npasses):
        d = frag_dst[:, p].reshape(-1)                  # (S*rps*smax,)
        idx = frag_idx[:, p].reshape(-1)                # (S*rps*smax*128,)
        hit = (idx.view(-1, LANES) >= 0) & (d >= 0)[:, None]
        f = torch.nonzero(hit.view(-1)).squeeze(1)      # (fragment, lane)
        frag = f // LANES
        srow = frag // smax                             # s*rps + r
        drow = srow - srow % rps + d[frag].long()       # s*rps + frag_dst
        inv = torch.full((n,), -1, dtype=torch.long, device=dev)
        inv[drow * LANES + f % LANES] = srow * LANES + idx[f].long()
        src = torch.where(inv >= 0, src[inv.clamp(min=0)], -1)
    return src.to(torch.int32).view(nsup * rps, LANES)


def group_gather_plain(contrib, src, fill):
    """K7 as one gather: out[d] = contrib[src[d]], the fill where src[d]
    is -1 (``src``: ``group_index``)."""
    f = torch.tensor(fill, dtype=contrib.dtype, device=contrib.device)
    s = src.long()
    return torch.where(s >= 0, contrib.reshape(-1)[s.clamp(min=0)].view(
        s.shape), f)


def grouped_reduce_plain(contrib, lr, evalid, chunk_block, nblocks: int,
                         reduce_kind: str, identity):
    """y (nblocks, 128): each 8-row chunk folds its elements with ev set
    into lane lr, each lane's in runs of RUN in index order and then the
    runs' results; then each block folds the lane partials of its chunks
    with a valid slot in chunk order from the identity (the kernel's
    fixed order, ``fold_order.chunk_fold_plain``)."""
    return chunk_fold_plain(contrib, lr, evalid != 0, RED_ROWS * LANES,
                            chunk_block, nblocks, reduce_kind,
                            identity).view(nblocks, LANES)


def live_chunks(evalid) -> torch.Tensor:
    """(nchunks,) bool: the 8-row chunks with a valid slot, the ones K8's
    chunk list holds."""
    return (evalid.reshape(-1, RED_ROWS * LANES) != 0).any(1)


def expand_figures(grp, evalid) -> dict:
    """What K6's design turns on, for one expand plan: steps, slots, valid
    slots, distinct windows, runs of steps on one window (their mean and
    median length), and the share of 4-slot groups whose ev bytes are all
    0 (the kernel loads no slot, lane or weight for them)."""
    n = grp.numel()
    new = torch.ones(n, dtype=torch.bool, device=grp.device)
    new[1:] = grp[1:] != grp[:-1]
    starts = torch.nonzero(new).squeeze(1)
    runs = torch.diff(starts, append=starts.new_full((1,), n)).double()
    valid = evalid != 0
    return {"steps": n, "slots": evalid.numel(), "valid": int(valid.sum()),
            "windows": int(grp.unique().numel()), "runs": runs.numel(),
            "mean_run": float(runs.mean()) if n else 0.0,
            "median_run": float(runs.median()) if n else 0.0,
            "empty4": float((~valid.reshape(-1, 4).any(1)).double().mean())
            if n else 0.0}


# ------------------------------------------------------------- validation
def _check(name, t, dtype, shape=None, device=None):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor")
    if dtype is not None and t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
    if device is not None and t.device != device:
        raise ValueError(f"{name} on {t.device}, expected {device}")


def _check_values(name, t):
    if t.dtype not in _DTYPES:
        raise TypeError(f"{name}: dtype {t.dtype} not in f32/f64/i32")


def _check_rows(name, t, device, rows=None):
    if t.dim() != 2 or t.shape[1] != LANES or (rows is not None
                                               and t.shape[0] != rows):
        want = f"({rows if rows is not None else 'rows'}, {LANES})"
        raise ValueError(f"{name}: expected {want}, got {tuple(t.shape)}")
    _check(name, t, None, device=device)


# --------------------------------------------------------------- wrappers
def expand_stream(x3d, grp, slot, lane, evalid, weights, fill,
                  mul_kind: str = "none"):
    """K6: x table (Sx3, 64, 128) -> (rows, 128) per-edge contributions,
    each the x value at (window grp[r//8], slot, lane) ⊗ its weight, or
    the fill where ev is 0. ``mul_kind``: 'none' | 'mul' | 'add_sat'
    (saturating at the fill). On the card one block resolves each 8-row
    step, four slots a thread. Replaces ``shuffle_kernels.py::
    expand_stream``."""
    if x3d.dim() != 3 or x3d.shape[1:] != (WROWS, LANES):
        raise ValueError(f"x3d: expected (windows, {WROWS}, {LANES}), got "
                         f"{tuple(x3d.shape)}")
    _check("x3d", x3d, None)
    _check_values("x3d", x3d)
    dev = x3d.device
    _check_rows("slot", slot, dev)
    rows = slot.shape[0]
    if rows % SUB:
        raise ValueError(f"slot: {rows} rows, not whole {SUB}-row steps")
    for nm, t in (("slot", slot), ("lane", lane), ("evalid", evalid)):
        _check(nm, t, torch.int8, (rows, LANES), dev)
    _check("grp", grp, torch.int32, (rows // SUB,), dev)
    if mul_kind not in _MUL_KINDS:
        raise ValueError(f"mul_kind {mul_kind!r}")
    if (weights is None) != (mul_kind == "none"):
        raise ValueError(f"mul_kind {mul_kind!r} with weights "
                         f"{'absent' if weights is None else 'given'}")
    if weights is not None:
        _check("weights", weights, x3d.dtype, (rows, LANES), dev)
    if not _on_cuda(x3d):
        return expand_stream_plain(x3d, grp, slot, lane, evalid, weights,
                                   fill, mul_kind)
    if rows * LANES >= 2 ** 32:
        raise ValueError(f"expand_stream: {rows} rows exceed the kernel's "
                         f"32-bit slot index")
    for nm, t, a in (("slot", slot, 4), ("lane", lane, 4),
                     ("evalid", evalid, 4), ("weights", weights, 16)):
        if t is not None and t.data_ptr() % a:
            raise ValueError(f"{nm}: not {a}-byte aligned")
    lib = _cuda.library()
    out = torch.empty((rows, LANES), dtype=x3d.dtype, device=dev)
    if rows == 0:
        return out
    with torch.cuda.device(dev):
        rc = lib.gt_expand_stream(
            x3d.data_ptr(), grp.data_ptr(), slot.data_ptr(), lane.data_ptr(),
            evalid.data_ptr(), None if weights is None else
            weights.data_ptr(), out.data_ptr(), rows, _DTYPES[x3d.dtype],
            _MUL_KINDS[mul_kind], float(fill), _stream(x3d))
    LAUNCHES["expand_stream"] += 1
    _cuda.check(rc, "expand_stream")
    return out


def group_stream(contrib, frag_dst, frag_idx, rows_per_super: int,
                 npasses: int, fill, src=None):
    """K7: regroup the (nsupers * rps, 128) contribution stream by
    destination row block through ``npasses`` radix passes; lanes no pass
    writes (holes the reduce plan masks) hold ``fill``, the ⊕-identity.
    frag_dst (nsupers, npasses, rps, SMAX) int32, frag_idx (nsupers,
    npasses, rps, SMAX*128) int8, -1 = idle. On the card the passes run as
    one gather through their composed index ``src`` (``group_index``,
    built here if None; ``group_tables`` keeps it per upload), one launch
    per call; the plain version, on a CPU tensor, runs the passes one by
    one and reads no ``src``. Replaces ``shuffle_kernels.py::
    group_stream``."""
    _check_values("contrib", contrib)
    dev = contrib.device
    if frag_dst.dim() != 4:
        raise ValueError("frag_dst: expected (nsupers, npasses, rps, SMAX)")
    nsup, npl, rps, smax = frag_dst.shape
    if rps != rows_per_super or npl < npasses:
        raise ValueError(f"frag_dst {tuple(frag_dst.shape)}: rps "
                         f"{rows_per_super}, {npasses} passes expected")
    _check_rows("contrib", contrib, dev, nsup * rps)
    _check("frag_dst", frag_dst, torch.int32, device=dev)
    _check("frag_idx", frag_idx, torch.int8, (nsup, npl, rps, smax * LANES),
           dev)
    if src is not None:
        _check("src", src, torch.int32, tuple(contrib.shape), dev)
    if not _on_cuda(contrib):
        return group_stream_plain(contrib, frag_dst, frag_idx,
                                  rows_per_super, npasses, fill)
    if src is None:
        src = group_index(frag_dst, frag_idx, rows_per_super, npasses)
    if src.data_ptr() % 16:
        raise ValueError("src: not 16-byte aligned")
    lib = _cuda.library()
    out = torch.empty_like(contrib)
    with torch.cuda.device(dev):
        rc = lib.gt_group_gather(contrib.data_ptr(), src.data_ptr(),
                                 out.data_ptr(), contrib.numel(),
                                 _DTYPES[contrib.dtype], float(fill),
                                 _stream(contrib))
    LAUNCHES["group_stream"] += 1
    _cuda.check(rc, "group_stream")
    return out


def group_tables(t, meta):
    """K7's composed index for the plan tensors ``t`` (``frag_dst``,
    ``frag_idx`` there; ``meta`` gives rows_per_super and npasses), kept
    in ``t`` as ``group_src`` (once per upload) and checked once to lie in
    [-1, stream slots); returns group_stream's ``src`` argument."""
    src = t.get("group_src")
    if src is None:
        src = group_index(t["frag_dst"], t["frag_idx"],
                          meta.rows_per_super, meta.npasses)
        n = src.numel()
        if n and (int(src.min()) < -1 or int(src.max()) >= n):
            raise ValueError(f"group_index outside [-1, {n})")
        t["group_src"] = src
    return {"src": src}


def grouped_reduce(contrib, lr, evalid, chunk_block, nblocks: int,
                   reduce_kind: str, identity, lists=None, scratch=None):
    """K8: ⊕-fold a row-block-grouped stream into (nblocks, 128) that
    starts at the identity: each 8-row chunk i folds its valid elements
    into row chunk_block[i], lane lr. Float sums fold in a fixed order, the
    plain version's, so a call gives the same bits every time. ``lists``:
    the chunk list of the chunks with a valid slot and the evalid it was
    built from (``reduce_lists``, built here if None; raises ValueError
    if built from another evalid); ``scratch``: the lists' and their
    runs' lane partials (allocated here if None); the plain version reads
    neither.
    Replaces ``shuffle_kernels.py::grouped_reduce``."""
    _check_values("contrib", contrib)
    dev = contrib.device
    _check("chunk_block", chunk_block, torch.int32, device=dev)
    if chunk_block.dim() != 1:
        raise ValueError("chunk_block: expected a 1-D tensor")
    nchunks = chunk_block.shape[0]
    rows = nchunks * RED_ROWS
    _check_rows("contrib", contrib, dev, rows)
    _check("lr", lr, torch.int8, (rows, LANES), dev)
    _check("evalid", evalid, torch.int8, (rows, LANES), dev)
    if reduce_kind not in _REDUCE_OK[contrib.dtype]:
        raise ValueError(f"grouped_reduce: {reduce_kind} on {contrib.dtype}")
    if nblocks < 1:
        raise ValueError(f"nblocks {nblocks}")
    if lists is not None and lists[3:] != (ev_stamp(evalid),):
        raise ValueError("grouped_reduce: lists built from another evalid")
    if not _on_cuda(contrib):
        return grouped_reduce_plain(contrib, lr, evalid, chunk_block,
                                    nblocks, reduce_kind, identity)
    if lists is None:
        lists = reduce_lists(chunk_block, nblocks, evalid)
    rptr, gptr, chunks, part, gpart = fold_args(
        lists[:3], scratch, nblocks, lists[2].shape[0], contrib.dtype, dev)
    lib = _cuda.library()
    y = torch.empty((nblocks, LANES), dtype=contrib.dtype, device=dev)
    with torch.cuda.device(dev):
        rc = lib.gt_grouped_reduce(
            contrib.data_ptr(), lr.data_ptr(), evalid.data_ptr(),
            chunks.data_ptr(), rptr.data_ptr(), gptr.data_ptr(),
            part.data_ptr(), gpart.data_ptr(), y.data_ptr(),
            chunks.shape[0], nblocks, gptr.shape[0] - 1,
            _DTYPES[contrib.dtype], _REDUCE_KINDS[reduce_kind],
            float(identity), _stream(contrib))
    LAUNCHES["grouped_reduce"] += 1
    _cuda.check(rc, "grouped_reduce")
    return y


def ev_stamp(evalid):
    """What ties K8's chunk list to the evalid it was built from: its
    device, address and shape."""
    return (str(evalid.device), evalid.data_ptr(), tuple(evalid.shape))


def reduce_lists(chunk_block, nblocks: int, evalid):
    """K8's lists: ``fold_order.chunk_lists`` of the chunks with a valid
    slot, and ``ev_stamp(evalid)``."""
    return chunk_lists(chunk_block, nblocks,
                       live_chunks(evalid)) + (ev_stamp(evalid),)


def reduce_tables(t, nblocks: int, dtype):
    """K8's lists (``reduce_lists`` of ``chunk_block`` and ``ev_r`` in the
    plan tensors ``t``; the stamp kept as ``rd_fev``) and scratch, kept in
    ``t`` (once per upload); returns grouped_reduce's (lists, scratch)
    arguments."""
    ev = t["ev_r"]
    folds = fold_tables(t, "rd", lambda: chunk_lists(
        t["chunk_block"], nblocks, live_chunks(ev)), dtype)
    folds["lists"] += (t.setdefault("rd_fev", ev_stamp(ev)),)
    return folds
