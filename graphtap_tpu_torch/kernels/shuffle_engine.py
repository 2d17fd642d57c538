"""The v1 shuffle SpMV of one shard: host plans and x (NC,) -> y_dense.

Counterpart of ``graphtap_tpu/kernels/shuffle_engine.py``:
``build_shuffle_plans`` plans this rank's shard and gives row b of the
JAX package's single-process (D, ...) arrays, byte for byte, with a
leading axis of 1 (on a mesh the super size, pass count, supers and
fragment width are the mesh's maxima);
``validate_shuffle_plans`` checks every index K6-K8 follow, once, on the
host; ``spmv_stages`` / ``spmv_local`` run the pipeline

  x -> pad to whole 8192-column windows -> K6 expand_stream (⊗ w)
    -> K7 group_stream (its radix passes composed into one gather: one
       launch)
    -> K8 grouped_reduce (compact y blocks)
    -> compact -> dense: two more K6 calls (mexp A and B windows of the
       compact y), merged by the B-validity mask.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch

from graphtap_tpu_torch.format.tiles import TileSet
from graphtap_tpu_torch.kernels.semiring import Semiring
from graphtap_tpu_torch.kernels.shuffle_kernels import (expand_stream,
                                                        group_stream,
                                                        group_tables,
                                                        grouped_reduce,
                                                        reduce_tables)
from graphtap_tpu_torch.kernels.shuffle_plan import (LANES, RED_ROWS, SUB,
                                                     WROWS, build_spmv_plan,
                                                     plan_monotone_expand)
from graphtap_tpu_torch.parallel import multihost as mh

WIN = WROWS * LANES          # columns per x window (8192)


@dataclass
class ShufflePlans:
    """Static meta + this shard's plan arrays (dict of (1, ...) numpy)."""
    NWIN: int
    total_rows: int
    rows_per_super: int
    nsupers: int
    npasses: int
    SMAX: int
    nblocks: int
    NR: int
    NC: int
    has_w: bool
    mexp_rows: int           # dense-expand output rows (C*L/128)
    arrays: Dict[str, np.ndarray]


def _pad_to(a: np.ndarray, shape, fill) -> np.ndarray:
    out = np.full(shape, fill, dtype=a.dtype)
    out[tuple(slice(0, n) for n in a.shape)] = a
    return out


def build_shuffle_plans(tiles: TileSet, value_dtype=np.float32,
                        nwin: int = 8, rows_per_super: int = 4096
                        ) -> ShufflePlans:
    """The shuffle plans of this rank's shard of ``tiles``, validated. As
    the JAX package normalizes its devices' plans (one program runs them
    all): a shard whose super size is below the mesh's largest re-plans
    with it, then one whose pass count is below the mesh's re-plans with
    that count (extra passes are the identity); the supers and the
    fragment width pad to the mesh's maxima. On a mesh every rank must
    call it: the maxima are collectives."""
    part, mesh = tiles.part, tiles.mesh
    b = mh.shard_of(part, mesh)
    n = int(tiles.nnz[b, 0])
    r = tiles.rows[b, :n].astype(np.int64)
    c = tiles.cols[b, :n].astype(np.int64)
    w = tiles.weights[b, :n] if tiles.weights is not None else None

    def plan(rps, force_npasses=None):
        return build_spmv_plan(r, c, w, tiles.NR, part.tile_cols, nwin=nwin,
                               rows_per_super=rps, value_dtype=value_dtype,
                               force_npasses=force_npasses)

    def gmax(v):
        return int(mh.global_max(v, mesh))

    p = plan(rows_per_super)
    rps = gmax(p.rows_per_super)
    if p.rows_per_super != rps:
        p = plan(rps)
    npasses = gmax(p.npasses)
    if p.npasses != npasses:
        p = plan(rps, npasses)
    nsupers, smax = gmax(p.nsupers), gmax(p.SMAX)
    rows = nsupers * rps
    mp = plan_monotone_expand(tiles.iv_dense[b].astype(np.int64))
    arrs = {"grp": _pad_to(p.grp, (rows // SUB,), 0)}
    for k in ("slot", "lane", "ev_x", "w_stream"):
        if k != "w_stream" or w is not None:
            arrs[k] = _pad_to(getattr(p, k), (rows, LANES), 0)
    arrs.update(
        frag_dst=_pad_to(p.frag_dst, (nsupers, npasses, rps, smax), -1),
        frag_idx=_pad_to(p.frag_idx, (nsupers, npasses, rps, smax * LANES),
                         -1),
        chunk_block=_pad_to(p.chunk_block, (rows // RED_ROWS,), 0),
        lr=_pad_to(p.lr, (rows, LANES), 0),
        ev_r=_pad_to(p.ev_r, (rows, LANES), 0),
        mexp_grp_a=mp.grp_a, mexp_grp_b=mp.grp_b, mexp_slot_a=mp.slot_a,
        mexp_slot_b=mp.slot_b, mexp_lane=mp.lane, mexp_ev_a=mp.ev_a,
        mexp_ev_b=mp.ev_b)
    plans = ShufflePlans(
        NWIN=nwin, total_rows=rows, rows_per_super=rps, nsupers=nsupers,
        npasses=npasses, SMAX=smax, nblocks=p.nblocks, NR=tiles.NR,
        NC=part.tile_cols, has_w=w is not None, mexp_rows=mp.out_rows,
        arrays={k: np.ascontiguousarray(v)[None] for k, v in arrs.items()})
    validate_shuffle_plans(plans)
    return plans


def x_windows(nc: int) -> int:
    """Windows of the padded x table of an NC-column tile."""
    return max(1, -(-nc // WIN))


def ytab_windows(nblocks: int) -> int:
    """Windows of the compact-y table the dense expansion reads (one more
    than the y blocks fill: an 8-row step may straddle two windows)."""
    return -(-nblocks * LANES // WIN) + 1


def _in(nm, a, lo, hi):
    if a.size and (int(a.min()) < lo or int(a.max()) >= hi):
        raise ValueError(f"shuffle plans: {nm} outside [{lo}, {hi})")


def _shape(nm, a, shape):
    if a.shape != tuple(shape):
        raise ValueError(f"shuffle plans: {nm} shape {a.shape}, expected "
                         f"{tuple(shape)}")


def validate_shuffle_plans(meta: ShufflePlans) -> None:
    """Check every index K6-K8 follow, so no kernel reads or writes out
    of bounds, and that K7's scatter is order-free: x and compact-y
    windows inside their tables, slot < 64 and lane < 128, frag_dst below
    rows_per_super, chunk_block below nblocks, lr < 128, and in each super
    and pass no (destination row, lane) written twice. Raises
    ValueError."""
    if any(v.shape[0] != 1 for v in meta.arrays.values()):
        raise ValueError("shuffle plans: one shard's row (a leading axis "
                         "of 1) only")
    a = {k: v[0] for k, v in meta.arrays.items()}
    rows, rps, S, P = (meta.total_rows, meta.rows_per_super, meta.nsupers,
                       meta.npasses)
    smax, mrows = meta.SMAX, meta.mexp_rows
    if rows != S * rps or rows % RED_ROWS or mrows % SUB:
        raise ValueError("shuffle plans: row counts")
    if meta.has_w != ("w_stream" in a):
        raise ValueError("shuffle plans: has_w and w_stream disagree")
    for nm in ("slot", "lane", "ev_x", "lr", "ev_r") + (
            ("w_stream",) if meta.has_w else ()):
        _shape(nm, a[nm], (rows, LANES))
    _shape("grp", a["grp"], (rows // SUB,))
    _shape("frag_dst", a["frag_dst"], (S, P, rps, smax))
    _shape("frag_idx", a["frag_idx"], (S, P, rps, smax * LANES))
    _shape("chunk_block", a["chunk_block"], (rows // RED_ROWS,))
    for nm in ("mexp_slot_a", "mexp_slot_b", "mexp_lane", "mexp_ev_a",
               "mexp_ev_b"):
        _shape(nm, a[nm], (mrows, LANES))
    for nm in ("mexp_grp_a", "mexp_grp_b"):
        _shape(nm, a[nm], (mrows // SUB,))
    _in("grp", a["grp"], 0, x_windows(meta.NC))
    for nm in ("mexp_grp_a", "mexp_grp_b"):
        _in(nm, a[nm], 0, ytab_windows(meta.nblocks))
    for nm in ("slot", "mexp_slot_a", "mexp_slot_b"):
        _in(nm, a[nm], 0, WROWS)
    for nm in ("lane", "mexp_lane", "lr"):
        _in(nm, a[nm], 0, LANES)
    _in("frag_dst", a["frag_dst"], -1, rps)
    _in("frag_idx", a["frag_idx"], -1, LANES)
    _in("chunk_block", a["chunk_block"], 0, meta.nblocks)
    lane = np.arange(LANES, dtype=np.int64)
    for s in range(S):
        for p in range(P):
            d = a["frag_dst"][s, p]                      # (rps, smax)
            hit = (a["frag_idx"][s, p].reshape(rps, smax, LANES) >= 0) \
                & (d >= 0)[..., None]
            r, j, l = np.nonzero(hit)
            key = d[r, j].astype(np.int64) * LANES + lane[l]
            if key.size and np.bincount(key).max() > 1:
                raise ValueError(f"shuffle plans: super {s} pass {p} "
                                 f"writes a (row, lane) twice")


def mul_kind(meta: ShufflePlans, semiring: Semiring) -> str:
    if not meta.has_w:
        return "none"
    return "mul" if semiring.reduce_kind == "sum" else "add_sat"


def _pad_windows(v: torch.Tensor, nwin: int, fill) -> torch.Tensor:
    """v (n,) -> (nwin, 64, 128), padded with ``fill``."""
    out = torch.full((nwin * WIN,), fill, dtype=v.dtype, device=v.device)
    out[:v.shape[0]] = v
    return out.view(nwin, WROWS, LANES)


def spmv_stages(x: torch.Tensor, t: Dict[str, torch.Tensor],
                meta: ShufflePlans, semiring: Semiring,
                dense_len: int) -> Dict[str, torch.Tensor]:
    """Every stage of one SpMV: the x table ``x3d``, the contribution
    stream ``contrib``, the regrouped ``grouped``, the compact
    ``y_blocks``, the compact-y table ``ytab``, the two expansions
    ``ya``/``yb`` and the result ``y`` (dense_len,). ``t``: the plan
    arrays as tensors on the run's device (``tools/convert.py::
    meta_from_numpy``)."""
    fill, kind = semiring.identity, semiring.reduce_kind
    x3d = _pad_windows(x, x_windows(x.shape[0]), fill)
    contrib = expand_stream(x3d, t["grp"], t["slot"], t["lane"], t["ev_x"],
                            t.get("w_stream"), fill, mul_kind(meta, semiring))
    grouped = group_stream(contrib, t["frag_dst"], t["frag_idx"],
                           meta.rows_per_super, meta.npasses, fill,
                           **group_tables(t, meta))
    y_blocks = grouped_reduce(grouped, t["lr"], t["ev_r"], t["chunk_block"],
                              meta.nblocks, kind, fill,
                              **fold_tables(t, meta, x.dtype))
    ytab = _pad_windows(y_blocks.view(-1), ytab_windows(meta.nblocks), fill)
    ya = expand_stream(ytab, t["mexp_grp_a"], t["mexp_slot_a"],
                       t["mexp_lane"], t["mexp_ev_a"], None, fill)
    yb = expand_stream(ytab, t["mexp_grp_b"], t["mexp_slot_b"],
                       t["mexp_lane"], t["mexp_ev_b"], None, fill)
    y = torch.where(t["mexp_ev_b"] != 0, yb, ya)
    return {"x3d": x3d, "contrib": contrib, "grouped": grouped,
            "y_blocks": y_blocks, "ytab": ytab, "ya": ya, "yb": yb,
            "y": y.reshape(-1)[:dense_len]}


def fold_tables(t: Dict[str, torch.Tensor], meta: ShufflePlans, dtype):
    """K8's block -> chunks list and scratch, kept in ``t`` once per
    upload (``shuffle_kernels.reduce_tables``), beside K7's composed index
    (``shuffle_kernels.group_tables``: 4 bytes a stream slot)."""
    group_tables(t, meta)
    return reduce_tables(t, meta.nblocks, dtype)


def spmv_local(x: torch.Tensor, t: Dict[str, torch.Tensor],
               meta: ShufflePlans, semiring: Semiring,
               dense_len: int) -> torch.Tensor:
    """One-device v1 shuffle SpMV: x (NC,) -> y_dense (dense_len,)."""
    return spmv_stages(x, t, meta, semiring, dense_len)["y"]
