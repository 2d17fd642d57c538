"""The v3 panel SpMV on one device: x (NC,) -> y_dense, through K1-K4.

Counterpart of ``graphtap_tpu/kernels/panel_engine.py::spmv3_local``,
static and frontier-gated branches. The glue the JAX package leaves to
XLA stays plain torch here: the x padding and its appended fill block, the
gating maps, the five-call chain, the ``f2_segok`` mask and the final
slice. The meta (``kernels/panel_meta.py``) is built on the host; ``t`` is
its arrays as tensors on the run's device
(``tools/convert.py::meta_from_numpy``).

  x -> K1 route_xr_exp (x_ext in shared memory, ⊗w) -> s0
    -> K2 route_passa (corner turn) -> s1
    -> K3 route_fold (fixr, segmented y_mid) -> K4 hub_fold
    -> K3 route_fold (fix2, straight into the dense y)

``spmv3_staged`` computes the same y through the staged (unfused)
pipeline, the composition the JAX package keeps K11 and K13 for
(``tests/test_panel.py:145-210``), on the same meta:

  x -> K2 route_passa, single-layer (the xr half of each xe_plan block)
    -> x_ext -> K11 route_expand (the exp half, ⊗w) -> s0 (= K1's s0)
    -> K2 route_passa -> s1 -> K2 route_passa (fixr) -> stack1
    -> K13 colsum_chunks (y_mid) -> K4 hub_fold -> K3 route_fold (fix2)

Its tables (the two halves of xe_plan, the absolute y_mid row of each
fixr chunk and K13's row -> chunks lists) are derived once per upload by
``staged_tables``, and K3's row -> bands lists and scratch (its fixed
fold order) by ``fold_tables``, which keeps them in ``t``.

Frontier gating (nonstationary programs, ``gate``): activity bits per
8-row x block propagate through the panel graph (xe -> pa -> fixr), and
inactive panels' plan indices and window bases are redirected to the fill
blocks, so K1-K3 run their gated launches. Exact: inactive sources hold
the ⊕-identity, which is what the fill plans route. hub_fold and the fix2
fold are not gated.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from graphtap_tpu_torch.kernels.fold_order import fold_lists
from graphtap_tpu_torch.kernels.fold_order import \
    fold_tables as _fold_tables
from graphtap_tpu_torch.kernels.panel_kernels import (
    FOLD_SEG_ROWS, LANES, STRIPE, XROWS, colsum_chunks, colsum_lists,
    fold_rows, hub_fold, hub_fold_plain, plan_rows, route_expand, route_fold,
    route_fold_plain, route_passa, route_passa_plain, route_xr_exp,
    route_xr_exp_plain, xe_plan_rows)
from graphtap_tpu_torch.kernels.panel_meta import Spmv3Meta, fill_blocks
from graphtap_tpu_torch.kernels.semiring import Semiring

# share of active x-expand panels above which the static pipeline runs —
# the reference's sparse/dense vote threshold (vertex_program.hpp:767,
# :1378), as in the JAX package
GATE_RATIO = 0.6
# K13's row -> chunks lists in staged_tables' dict (colsum_lists' order)
CHUNK_LISTS = ("chunk_ptr", "chunk_idx", "chunk_long", "chunk_lpos")


def _activity(x2d: torch.Tensor, sx: int, fill) -> torch.Tensor:
    """(sx // 8,) bool: x blocks holding any non-identity value."""
    return (x2d[:sx] != fill).reshape(sx // STRIPE, STRIPE * LANES).any(1)


def window_activity(x2d: torch.Tensor, t, meta: Spmv3Meta,
                    fill) -> torch.Tensor:
    """(exp_panels + 1, xr_nwin) bool: whether each x window of each
    x-expand panel holds an active x block."""
    sx = meta.sx_rows
    blk_act = _activity(x2d, sx, fill)
    xb = t["xr_bases"].view(meta.exp_panels + 1, meta.xr_nwin).long()
    return blk_act[xb.clamp(0, sx // STRIPE - 1)]


def gate_vote(w_act: torch.Tensor, meta: Spmv3Meta) -> bool:
    """The "auto" vote: True (gated) when the share of x-expand panels
    with an active x window is at most GATE_RATIO. One host read. The
    share is a float32 mean compared in float32, as ``lax.cond(ratio <=
    GATE_RATIO)`` compares it in the JAX package."""
    if meta.exp_panels == 0:
        return False
    active = int(w_act[:meta.exp_panels].any(1).sum())
    ratio = np.float32(active) / np.float32(meta.exp_panels)
    return bool(ratio <= np.float32(GATE_RATIO))


def gating_maps(w_act: torch.Tensor, t, meta: Spmv3Meta
                ) -> Tuple[torch.Tensor, ...]:
    """(xe_bases, xe_pidx, pa_bases, pa_pidx, fx_bases, fx_pidx): the
    gated window bases and plan indices of K1, K2 and K3 (fixr), index for
    index the JAX package's ``_gating_maps``. Fill targets: x block
    sx//8 (the appended fill block), s0 block exp_panels*8, s1 block
    pa_panels*8, plan blocks exp_panels, pa_panels and fix_panels; the
    fill panels of K1 and K2 are forced active."""
    sx = meta.sx_rows
    nxe, npa = meta.exp_panels + 1, meta.pa_panels + 1
    dev = w_act.device
    i32 = torch.int32
    a_xe = w_act.any(1)
    a_xe[meta.exp_panels] = True
    xe_pidx = torch.where(a_xe, torch.arange(nxe, dtype=i32, device=dev),
                          meta.exp_panels).to(i32)
    xb = t["xr_bases"].view(nxe, meta.xr_nwin)
    xe_bases = torch.where(w_act, xb, sx // STRIPE).reshape(-1).to(i32)
    pb = t["pa_bases"].view(npa, meta.pa_nwin)
    ps_act = a_xe[(pb.long() // STRIPE).clamp(0, nxe - 1)]
    a_pa = ps_act.any(1)
    a_pa[meta.pa_panels] = True
    pa_pidx = torch.where(a_pa, torch.arange(npa, dtype=i32, device=dev),
                          meta.pa_panels).to(i32)
    pa_bases = torch.where(ps_act, pb, meta.exp_panels * STRIPE
                           ).reshape(-1).to(i32)
    fb = t["fixr_bases"].view(meta.fix_panels, meta.fixr_nwin)
    fs_act = a_pa[(fb.long() // STRIPE).clamp(0, npa - 1)]
    a_fx = fs_act.any(1)
    fx_pidx = torch.where(
        a_fx, torch.arange(meta.fix_panels, dtype=i32, device=dev),
        meta.fix_panels).to(i32)
    fx_bases = torch.where(fs_act, fb, meta.pa_panels * STRIPE
                           ).reshape(-1).to(i32)
    return xe_bases, xe_pidx, pa_bases, pa_pidx, fx_bases, fx_pidx


def pad_x(x: torch.Tensor, meta: Spmv3Meta, fill) -> torch.Tensor:
    """x (NC,) -> the (sx + 8, 128) x table: padded to sx rows with the
    ⊕-identity, then one appended all-fill block (the gated path's
    redirect target for inactive windows)."""
    sx = meta.sx_rows
    x2d = torch.full(((sx + STRIPE) * LANES,), fill, dtype=x.dtype,
                     device=x.device)
    x2d[:x.shape[0]] = x
    return x2d.view(sx + STRIPE, LANES)


def spmv3_stages(x: torch.Tensor, t: Dict[str, torch.Tensor],
                 meta: Spmv3Meta, semiring: Semiring, dense_len: int,
                 gate=False) -> Dict[str, torch.Tensor]:
    """Every stage of one SpMV: the padded x table ``x2d``, the
    contribution stream ``s0``, the corner-turned ``s1``, the fixr fold
    ``y_mid``, its hub fold ``y_hub``, the result ``y`` (dense_len,), and
    ``gated``, the branch taken.

    ``gate``: False runs the static pipeline, True the gated one, "auto"
    picks per call by the panel-activity vote (one host read), as the JAX
    package's ``lax.cond`` does. The gated maps are in ``maps``."""
    if not (isinstance(gate, bool) or gate == "auto"):
        raise ValueError(f"gate {gate!r}: expected False, True or 'auto'")
    mul_kind = _mul_kind(meta, semiring)
    fill = semiring.identity
    kind = semiring.reduce_kind
    x2d = pad_x(x, meta, fill)
    gated, maps = False, None
    if gate is not False:
        w_act = window_activity(x2d, t, meta, fill)
        gated = gate is True or gate_vote(w_act, meta)
    fb = fill_blocks(meta)
    if gated:
        maps = gating_maps(w_act, t, meta)
        xe_b, xe_q, pa_b, pa_q, fx_b, fx_q = maps
    else:
        xe_b, pa_b, fx_b = t["xr_bases"], t["pa_bases"], t["fixr_bases"]
        xe_q = pa_q = fx_q = None
    # K1 and K2 each emit a trailing fill panel (meta panels + 1): the
    # pa / fixr fill windows at blocks exp_panels*8 / pa_panels*8 read it
    s0 = route_xr_exp(x2d, xe_b, t["xe_plan"], t.get("w_stream"), fill,
                      meta.exp_panels + 1, meta.xr_nwin, mul_kind,
                      plan_idx=xe_q, fill_block=fb["xe_plan"])
    s1 = route_passa(s0, pa_b, t["pa_plan"], fill, meta.pa_panels + 1,
                     meta.pa_nwin, plan_idx=pa_q, fill_block=fb["pa_plan"])
    folds = fold_tables(t, meta, x.dtype)
    y_mid = route_fold(s1, fx_b, t["fixr_plan"], t["fix_dst"],
                       t["fixr_seg"], meta.nrb, kind, fill, meta.fix_panels,
                       meta.fixr_nwin, plan_idx=fx_q,
                       fill_block=fb["fixr_plan"], **folds["fixr"])
    y_hub, y = _fold_tail(y_mid, t, meta, kind, fill, dense_len,
                          folds["fix2"])
    return {"x2d": x2d, "s0": s0, "s1": s1, "y_mid": y_mid, "y_hub": y_hub,
            "y": y, "gated": gated, "maps": maps}


def _mul_kind(meta: Spmv3Meta, semiring: Semiring) -> str:
    if not meta.has_w:
        return "none"
    return "mul" if semiring.reduce_kind == "sum" else "add_sat"


def fold_tables(t: Dict[str, torch.Tensor], meta: Spmv3Meta, dtype):
    """K3's row -> bands lists and scratch for the fixr and the fix2
    fold, kept in ``t`` once per upload (``fold_order.fold_tables``);
    returns each fold's route_fold (lists, scratch) arguments."""
    return {
        "fixr": _fold_tables(t, "fixr", lambda: fold_lists(fold_rows(
            t["fix_dst"], t["fixr_seg"], meta.nrb, meta.fix_panels),
            meta.nrb), dtype),
        "fix2": _fold_tables(t, "fix2", lambda: fold_lists(fold_rows(
            t["fix2_dst"], t["f2_seg"], meta.f2_rows, meta.f2_panels),
            meta.f2_rows), dtype)}


def _fold_tail(y_mid, t, meta: Spmv3Meta, kind: str, fill, dense_len: int,
               fix2):
    """y_mid -> (y_hub, y (dense_len,)): K4, then the fix2 fold (K3, its
    fold tables ``fix2``) straight into the dense y layout."""
    # hub rows: lane-⊕-fold at the row's packed slot width
    y_hub = hub_fold(y_mid, t["hub_mask"], kind)
    y_dense = route_fold(y_hub, t["f2_bases"], t["f2_plan"], t["fix2_dst"],
                         t["f2_seg"], meta.f2_rows, kind, fill,
                         meta.f2_panels, meta.f2_nwin, **fix2)
    return y_hub, _segok(y_dense, t, meta, fill, dense_len)


def _segok(y_dense, t, meta: Spmv3Meta, fill, dense_len: int):
    """The fix2 fold's table -> y (dense_len,): dense segments no fix2
    panel visits hold the ⊕-identity (the fold table starts filled; the
    mask keeps the JAX package's contract)."""
    if not bool(np.all(meta.arrays["f2_segok"])):
        seg_rows2 = min(meta.f2_rows, FOLD_SEG_ROWS)
        ok = torch.repeat_interleave(t["f2_segok"] != 0, seg_rows2)[:, None]
        y_dense = torch.where(
            ok, y_dense, torch.tensor(fill, dtype=y_dense.dtype,
                                      device=y_dense.device))
    return y_dense.reshape(-1)[:dense_len]


def spmv3_plain(x: torch.Tensor, t: Dict[str, torch.Tensor],
                meta: Spmv3Meta, semiring: Semiring,
                dense_len: int) -> torch.Tensor:
    """``spmv3_local``'s static branch through the plain versions of K1-K4
    on x's device, whatever it is: on the card, the yardstick the kernels'
    SpMV is held against (on the CPU, ``spmv3_local`` is this)."""
    fill, kind = semiring.identity, semiring.reduce_kind
    x2d = pad_x(x, meta, fill)
    s0 = route_xr_exp_plain(x2d, t["xr_bases"], t["xe_plan"],
                            t.get("w_stream"), fill, meta.exp_panels + 1,
                            meta.xr_nwin, _mul_kind(meta, semiring))
    s1 = route_passa_plain(s0, t["pa_bases"], t["pa_plan"], fill,
                           meta.pa_panels + 1, meta.pa_nwin)
    y_mid = route_fold_plain(s1, t["fixr_bases"], t["fixr_plan"],
                             t["fix_dst"], t["fixr_seg"], meta.nrb, kind,
                             fill, meta.fix_panels, meta.fixr_nwin)
    y_hub = hub_fold_plain(y_mid, t["hub_mask"], kind)
    y_dense = route_fold_plain(y_hub, t["f2_bases"], t["f2_plan"],
                               t["fix2_dst"], t["f2_seg"], meta.f2_rows,
                               kind, fill, meta.f2_panels, meta.f2_nwin)
    return _segok(y_dense, t, meta, fill, dense_len)


def spmv3_local(x: torch.Tensor, t: Dict[str, torch.Tensor],
                meta: Spmv3Meta, semiring: Semiring, dense_len: int,
                gate=False) -> torch.Tensor:
    """One-device v3 SpMV: x (NC,) -> y_dense (dense_len,)."""
    return spmv3_stages(x, t, meta, semiring, dense_len, gate)["y"]


def staged_tables(t: Dict[str, torch.Tensor],
                  meta: Spmv3Meta) -> Dict[str, torch.Tensor]:
    """``t`` plus the staged pipeline's tables, on t's device: ``xr_plan``
    and ``exp_plan``, the single-layer x -> x_ext half and the expand half
    of each panel's packed ``xe_plan`` block (contiguous copies),
    ``chunk_dst``, the absolute y_mid row ``fixr_seg*seg_rows + fix_dst``
    of each fixr chunk (inside the nrb-row table: ``validate_meta``), and
    K13's row -> chunks lists (``CHUNK_LISTS``,
    ``panel_kernels.colsum_lists``)."""
    npan = meta.exp_panels + 1
    xr_rows = plan_rows(meta.xr_nwin * STRIPE, XROWS, False)
    blocks = t["xe_plan"][:npan * xe_plan_rows(meta.xr_nwin)].view(
        npan, -1, LANES)
    seg_rows = min(meta.nrb, FOLD_SEG_ROWS)
    chunk_dst = (t["fixr_seg"][:meta.fix_panels].long().repeat_interleave(
        STRIPE) * seg_rows + t["fix_dst"][:meta.fix_panels * STRIPE].long())
    lists = colsum_lists(chunk_dst, meta.nrb)
    return {**t,
            "xr_plan": blocks[:, :xr_rows].reshape(-1, LANES).contiguous(),
            "exp_plan": blocks[:, xr_rows:].reshape(-1, LANES).contiguous(),
            "chunk_dst": chunk_dst.to(torch.int32),
            **dict(zip(CHUNK_LISTS, lists))}


def spmv3_staged_stages(x: torch.Tensor, t: Dict[str, torch.Tensor],
                        meta: Spmv3Meta, semiring: Semiring,
                        dense_len: int) -> Dict[str, torch.Tensor]:
    """Every stage of one staged SpMV on ``t = staged_tables(...)``: the
    x table ``x2d``, ``x_ext``, ``s0`` (equal to K1's), ``s1``,
    ``stack1`` (the fixr route's routed panels), ``y_mid`` (their chunk
    fold), ``y_hub`` and the result ``y`` (dense_len,)."""
    if "chunk_dst" not in t:
        raise KeyError("spmv3_staged: pass staged_tables(t, meta)")
    fill, kind = semiring.identity, semiring.reduce_kind
    nxe = meta.exp_panels + 1
    x2d = pad_x(x, meta, fill)
    x_ext = route_passa(x2d, t["xr_bases"], t["xr_plan"], fill, nxe,
                        meta.xr_nwin, out_rows=XROWS, two_layer=False)
    s0 = route_expand(x_ext, t["exp_plan"], t.get("w_stream"), fill, nxe,
                      _mul_kind(meta, semiring))
    s1 = route_passa(s0, t["pa_bases"], t["pa_plan"], fill,
                     meta.pa_panels + 1, meta.pa_nwin)
    stack1 = route_passa(s1, t["fixr_bases"], t["fixr_plan"], fill,
                         meta.fix_panels, meta.fixr_nwin)
    y_mid = colsum_chunks(stack1, t["chunk_dst"], meta.nrb, kind, fill,
                          lists=tuple(t[k] for k in CHUNK_LISTS))
    y_hub, y = _fold_tail(y_mid, t, meta, kind, fill, dense_len,
                          fold_tables(t, meta, x.dtype)["fix2"])
    return {"x2d": x2d, "x_ext": x_ext, "s0": s0, "s1": s1,
            "stack1": stack1, "y_mid": y_mid, "y_hub": y_hub, "y": y}


def spmv3_staged(x: torch.Tensor, t: Dict[str, torch.Tensor],
                 meta: Spmv3Meta, semiring: Semiring,
                 dense_len: int) -> torch.Tensor:
    """The staged v3 SpMV: x (NC,) -> y_dense (dense_len,), equal to
    ``spmv3_local``'s (bit for bit in int32; float sums within rounding:
    K13 folds a row's chunks as one chain, K3 in runs of
    ``fold_order.GROUP``)."""
    return spmv3_staged_stages(x, t, meta, semiring, dense_len)["y"]
