"""The v2 windowed-gather SpMV of one shard: host plans and x (NC,) ->
y_dense.

Counterpart of ``graphtap_tpu/kernels/gather_engine.py``:
``build_spmv2_meta`` plans this rank's shard and gives row b of the JAX
package's single-process (D, ...) arrays, byte for byte, with a leading
axis of 1 (its ``multihost.global_max`` normalizations run across the
mesh's ranks); ``validate_spmv2_meta`` checks every
index K9 and K8 follow, once, on the host; ``spmv2_stages`` /
``spmv2_local`` run the pipeline

  x -> pad to whole 8-row, 128-lane windows -> K9 exp (⊗ w_stream)
    -> K9 p0 .. p3 (the radix passes)
    -> K8 grouped_reduce (8-row chunks, compact y blocks)
    -> K9 mx over the (nblocks, 128) y table -> the dense row block.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch

from graphtap_tpu_torch.format.tiles import TileSet
from graphtap_tpu_torch.kernels.gather_kernels import (SID_INVALID,
                                                       seg_round_rows,
                                                       windowed_gather)
from graphtap_tpu_torch.kernels.gather_plan import (LANES, NPASSES, SUB,
                                                    GatherPlan,
                                                    build_spmv2_plan)
from graphtap_tpu_torch.kernels.semiring import Semiring
from graphtap_tpu_torch.kernels.shuffle_engine import mul_kind
from graphtap_tpu_torch.kernels.shuffle_kernels import (grouped_reduce,
                                                        reduce_tables)
from graphtap_tpu_torch.parallel import multihost as mh

STAGES = ("exp",) + tuple(f"p{p}" for p in range(NPASSES)) + ("mx",)
_PLAN_KEYS = ("wsel", "base", "nact", "cidx", "meta")


@dataclass
class Spmv2Meta:
    """Static meta + this shard's plan arrays (dict of (1, ...) numpy)."""
    NC: int
    nblocks: int            # padded compact y rows (mult of 8)
    dense_rows: int
    final_rows: int
    npasses: int
    has_w: bool
    nsub: Dict[str, int]    # per stage
    out_rows: Dict[str, int]
    arrays: Dict[str, np.ndarray]


def _pad_steps(g: GatherPlan, nsteps: int, nsub: int,
               cidx_blocks: int) -> Dict[str, np.ndarray]:
    """A stage's kernel arrays, padded to the mesh-common ``nsteps``,
    ``nsub`` and ``cidx_blocks`` as the JAX package's ``_pad_gather_plan``
    pads them. Extra subops repeat a step's last window; pad steps repeat
    the last step's windows and have nact 0, all-invalid meta and a base
    of the total, so they read nothing; cidx grows by zero blocks that no
    step streams."""
    gn = g.out_rows // SUB
    wsel = g.wsel.reshape(gn, g.nsub)
    if nsub > g.nsub:
        wsel = np.concatenate(
            [wsel, np.repeat(wsel[:, -1:], nsub - g.nsub, axis=1)], axis=1)
    nact, base, meta = g.nact, g.base, g.meta
    if nsteps > gn:
        pad = nsteps - gn
        wsel = np.concatenate([wsel, np.repeat(wsel[-1:], pad, axis=0)
                               if gn else np.zeros((pad, nsub), np.int32)])
        nact = np.concatenate([nact, np.zeros(pad, np.int32)])
        base = np.concatenate([base, np.full(pad, np.int32(g.nact.sum()),
                                             np.int32)])
        meta = np.concatenate([meta, np.full((pad, SUB, LANES),
                                             SID_INVALID << 3, np.uint8)])
    cidx = g.cidx
    if cidx_blocks > cidx.shape[0]:
        cidx = np.concatenate([cidx, np.zeros(
            (cidx_blocks - cidx.shape[0], SUB, LANES), np.int8)])
    return {"wsel": wsel.reshape(-1), "base": base, "nact": nact,
            "cidx": cidx, "meta": meta}


def x_rows(nc: int) -> int:
    """Rows of the padded (rows, 128) x table of an NC-column tile."""
    rows = -(-nc // LANES)
    return -(-rows // SUB) * SUB


def build_spmv2_meta(tiles: TileSet, value_dtype=np.float32,
                     bchg_cap: int = 10) -> Spmv2Meta:
    """The v2 plans of this rank's shard of ``tiles``, validated; every
    normalized dimension (y blocks, dense rows, each stage's subops, rows
    and cidx blocks) is the mesh's maximum, as the JAX package's
    ``multihost.global_max`` makes it. On a mesh every rank must call it:
    the maxima are collectives."""
    part, mesh = tiles.part, tiles.mesh
    b = mh.shard_of(part, mesh)
    n = int(tiles.nnz[b, 0])
    w = tiles.weights[b, :n] if tiles.weights is not None else None
    iv = tiles.iv_dense[b] if tiles.ir is not None else None
    p = build_spmv2_plan(tiles.rows[b, :n].astype(np.int64),
                         tiles.cols[b, :n].astype(np.int64), w, tiles.NR,
                         part.tile_cols, part.tile_rows, iv,
                         value_dtype=value_dtype, bchg_cap=bchg_cap)

    def gmax(v):
        return int(mh.global_max(v, mesh))

    nblocks = -(-gmax(p.nblocks) // SUB) * SUB
    dense_rows = seg_round_rows(gmax(p.dense_rows))
    stage = dict(zip(STAGES, [p.expand, *p.passes, p.mexp]))
    nsub, out_rows, arrs = {}, {}, {}
    for k in STAGES:
        g = stage[k]
        nsub[k] = gmax(g.nsub)
        out_rows[k] = dense_rows if k == "mx" \
            else seg_round_rows(gmax(g.out_rows))
    for k in STAGES:
        for a, v in _pad_steps(stage[k], out_rows[k] // SUB, nsub[k],
                               gmax(stage[k].cidx.shape[0])).items():
            arrs[f"{k}_{a}"] = v
    final_rows = out_rows[f"p{NPASSES - 1}"]
    lr = np.zeros((final_rows, LANES), np.int8)
    lr[:p.lr.shape[0]] = p.lr
    ev = np.zeros((final_rows, LANES), np.int8)
    ev[:p.ev_r.shape[0]] = p.ev_r
    cb = np.zeros(final_rows // SUB, np.int32)
    cb[:p.chunk_block.size] = p.chunk_block
    arrs.update(lr=lr, ev_r=ev, chunk_block=cb)
    has_w = tiles.weights is not None
    if has_w:
        ws = np.zeros((out_rows["exp"] // SUB, SUB, LANES), dtype=value_dtype)
        if p.w_stream is not None:
            ws[:p.w_stream.shape[0]] = p.w_stream
        arrs["w_stream"] = ws
    meta = Spmv2Meta(NC=part.tile_cols, nblocks=nblocks,
                     dense_rows=dense_rows, final_rows=final_rows,
                     npasses=NPASSES, has_w=has_w, nsub=nsub,
                     out_rows=out_rows,
                     arrays={k: np.ascontiguousarray(v)[None]
                             for k, v in arrs.items()})
    validate_spmv2_meta(meta)
    return meta


def stage_src_rows(meta: Spmv2Meta, k: str) -> int:
    """Rows of the source table stage ``k`` gathers from: the x table,
    the previous stage's stream, or the y table."""
    if k == "exp":
        return x_rows(meta.NC)
    if k == "mx":
        return meta.nblocks
    return meta.out_rows[STAGES[STAGES.index(k) - 1]]


def _fail(msg):
    raise ValueError(f"v2 plans: {msg}")


def _shape(nm, a, shape):
    if a.shape != tuple(shape):
        _fail(f"{nm} shape {a.shape}, expected {tuple(shape)}")


def validate_spmv2_meta(meta: Spmv2Meta) -> None:
    """Check every index K9 and K8 follow, so no kernel reads or writes
    out of bounds: per stage, 1 <= nsub <= 31 and nact in [0, nsub]; each
    active subop's window inside the source table (wsel*8 + 7 <
    src_rows); base[i] + nact[i] within the cidx blocks; cidx lanes in
    [0, 128); and for the fold, chunk_block below nblocks and lr in
    [0, 128). Pad steps (nact 0, all-invalid meta) pass. Raises
    ValueError."""
    if any(v.shape[0] != 1 for v in meta.arrays.values()):
        _fail("one shard's row (a leading axis of 1) only")
    a = {k: v[0] for k, v in meta.arrays.items()}
    if meta.has_w != ("w_stream" in a):
        _fail("has_w and w_stream disagree")
    if meta.npasses != NPASSES or set(meta.nsub) != set(STAGES) or \
            set(meta.out_rows) != set(STAGES):
        _fail("stages")
    if meta.nblocks % SUB or meta.out_rows["mx"] != meta.dense_rows or \
            meta.final_rows != meta.out_rows[f"p{NPASSES - 1}"]:
        _fail("row counts")
    for k in STAGES:
        nsub, rows = meta.nsub[k], meta.out_rows[k]
        if not 1 <= nsub <= SID_INVALID or rows % SUB:
            _fail(f"{k}: nsub {nsub}, out_rows {rows}")
        nsteps = rows // SUB
        _shape(f"{k}_wsel", a[f"{k}_wsel"], (nsteps * nsub,))
        _shape(f"{k}_base", a[f"{k}_base"], (nsteps,))
        _shape(f"{k}_nact", a[f"{k}_nact"], (nsteps,))
        _shape(f"{k}_meta", a[f"{k}_meta"], (nsteps, SUB, LANES))
        cidx = a[f"{k}_cidx"]
        if cidx.ndim != 3 or cidx.shape[1:] != (SUB, LANES):
            _fail(f"{k}_cidx shape {cidx.shape}")
        if cidx.size and int(cidx.min()) < 0:
            _fail(f"{k}_cidx: a lane outside [0, {LANES})")
        nact = a[f"{k}_nact"].astype(np.int64)
        base = a[f"{k}_base"].astype(np.int64)
        if nact.size and (nact.min() < 0 or nact.max() > nsub):
            _fail(f"{k}_nact outside [0, {nsub}]")
        if nact.size and (base.min() < 0
                          or (base + nact).max() > cidx.shape[0]):
            _fail(f"{k}_base: active blocks past the {cidx.shape[0]} cidx "
                  f"blocks")
        wsel = a[f"{k}_wsel"].reshape(nsteps, nsub)
        act = np.arange(nsub)[None, :] < nact[:, None]
        wins = stage_src_rows(meta, k) // SUB
        if act.any() and (wsel[act].min() < 0 or wsel[act].max() >= wins):
            _fail(f"{k}_wsel: an active window outside the {wins} source "
                  f"windows")
    fr = meta.final_rows
    _shape("lr", a["lr"], (fr, LANES))
    _shape("ev_r", a["ev_r"], (fr, LANES))
    _shape("chunk_block", a["chunk_block"], (fr // SUB,))
    if a["lr"].size and int(a["lr"].min()) < 0:
        _fail(f"lr outside [0, {LANES})")
    cb = a["chunk_block"]
    if cb.size and (int(cb.min()) < 0 or int(cb.max()) >= meta.nblocks):
        _fail(f"chunk_block outside [0, {meta.nblocks})")
    if meta.has_w:
        _shape("w_stream", a["w_stream"],
               (meta.out_rows["exp"] // SUB, SUB, LANES))


def stage_plan(t: Dict[str, torch.Tensor], k: str):
    """Stage ``k``'s (wsel, base, nact, cidx, meta) tensors."""
    return tuple(t[f"{k}_{a}"] for a in _PLAN_KEYS)


def pad_x(x: torch.Tensor, fill) -> torch.Tensor:
    """x (NC,) -> the (rows, 128) x table, padded with ``fill`` to whole
    8-row windows."""
    rows = x_rows(x.shape[0])
    out = torch.full((rows * LANES,), fill, dtype=x.dtype, device=x.device)
    out[:x.shape[0]] = x
    return out.view(rows, LANES)


def spmv2_stages(x: torch.Tensor, t: Dict[str, torch.Tensor],
                 meta: Spmv2Meta, semiring: Semiring,
                 dense_len: int) -> Dict[str, torch.Tensor]:
    """Every stage of one SpMV: the x table ``x2d``, the streams ``exp``,
    ``p0`` .. ``p3``, the compact ``y_blocks``, the dense table ``mx`` and
    the result ``y`` (dense_len,). ``t``: the plan arrays as tensors on
    the run's device (``tools/convert.py::meta_from_numpy``)."""
    fill = semiring.identity
    st = {"x2d": pad_x(x, fill)}
    st["exp"] = windowed_gather(st["x2d"], *stage_plan(t, "exp"),
                                t.get("w_stream"), fill, meta.nsub["exp"],
                                mul_kind(meta, semiring))
    buf = st["exp"]
    for p in range(meta.npasses):
        k = f"p{p}"
        buf = st[k] = windowed_gather(buf, *stage_plan(t, k), None, fill,
                                      meta.nsub[k])
    st["y_blocks"] = grouped_reduce(buf, t["lr"], t["ev_r"],
                                    t["chunk_block"], meta.nblocks,
                                    semiring.reduce_kind, fill,
                                    **fold_tables(t, meta, x.dtype))
    st["mx"] = windowed_gather(st["y_blocks"], *stage_plan(t, "mx"), None,
                               fill, meta.nsub["mx"])
    st["y"] = st["mx"].reshape(-1)[:dense_len]
    return st


def fold_tables(t: Dict[str, torch.Tensor], meta: Spmv2Meta, dtype):
    """K8's block -> chunks list and scratch, kept in ``t`` once per
    upload (``shuffle_kernels.reduce_tables``)."""
    return reduce_tables(t, meta.nblocks, dtype)


def spmv2_local(x: torch.Tensor, t: Dict[str, torch.Tensor],
                meta: Spmv2Meta, semiring: Semiring,
                dense_len: int) -> torch.Tensor:
    """One-device v2 SpMV: x (NC,) -> y_dense (dense_len,)."""
    return spmv2_stages(x, t, meta, semiring, dense_len)["y"]
