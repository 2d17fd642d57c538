"""Host-built v3 panel-pipeline meta (numpy), byte-identical to the JAX
package's.

Counterpart of ``graphtap_tpu/kernels/panel_engine.py::build_spmv3_meta``
and its helpers, without jax. Each rank plans its own shard's tiles; every
shape that must agree across the mesh is its maximum over the ranks
(``multihost.global_max``), so rank b's arrays equal row b of the JAX
package's single-process (D, ...) meta. The plans come from
``kernels/panel_plan.py``, the port's unchanged copy of the JAX package's
planner, so the CUDA kernels read the very bytes the Pallas kernels
read. ``validate_meta`` checks every index a kernel follows, once,
before any plan reaches the card.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import numpy as np

from graphtap_tpu_torch.format.tiles import TileSet
from graphtap_tpu_torch.kernels import panel_plan as _pp
from graphtap_tpu_torch.kernels.panel_kernels import (
    FOLD_SEG_ROWS, LANES, PROWS, STRIPE, XROWS, pack_route_plan, plan_rows,
    xe_plan_rows)
from graphtap_tpu_torch.parallel import multihost as mh

RoutePlan = _pp.RoutePlan


@dataclass
class Spmv3Meta:
    """Static meta + this shard's plan arrays (dict of (1, ...) numpy)."""
    NC: int
    nblocks: int            # compact y rows + 8 scratch (diagnostic only)
    dense_rows: int
    f2_rows: int            # fix2 fold table rows (dense + scratch,
                            # rounded to whole FOLD_SEG_ROWS segments)
    exp_panels: int
    pa_panels: int
    pa_nwin: int
    fix_panels: int         # fix-route panels (8 chunks each)
    fixr_nwin: int
    fix2_chunks: int        # f2_panels * 8 (fix2_dst length)
    f2_panels: int
    f2_nwin: int
    nrb: int                # y_mid rows (padded to 8, + 8 scratch)
    xext_rows: int
    xr_nwin: int            # x->x_ext route window operands per panel
    sx_rows: int            # padded x table rows
    has_w: bool
    arrays: Dict[str, np.ndarray]


def _pad_route_nwin(rt, npanels: int, old_nwin: int, new_nwin: int):
    """Extend a fix-route's per-panel window count: append zero idx1 rows
    for the extra (unreferenced) window bands."""
    if old_nwin == new_nwin:
        return rt
    sr_old = old_nwin * STRIPE
    sr_new = new_nwin * STRIPE
    idx1 = rt.idx1.reshape(npanels, sr_old, LANES)
    idx1 = np.concatenate(
        [idx1, np.zeros((npanels, sr_new - sr_old, LANES), np.int8)],
        axis=1)
    return RoutePlan(idx1=idx1.reshape(-1, LANES), sel_a=rt.sel_a,
                     sel_b=rt.sel_b, idx3=rt.idx3, src_rows=sr_new)


def _append_fill_panel(rt, out_rows: int = PROWS):
    """Append ONE panel whose output is pure ⊕-identity: its sel bands are
    31 (0xF8, never matched), so both landing layers keep the fill."""
    return RoutePlan(
        idx1=np.concatenate(
            [rt.idx1, np.zeros((rt.src_rows, LANES), np.int8)]),
        sel_a=np.concatenate(
            [rt.sel_a, np.full((out_rows, LANES), 0xF8, np.uint8)]),
        sel_b=np.concatenate(
            [rt.sel_b, np.full((out_rows, LANES), 0xF8, np.uint8)]),
        idx3=np.concatenate(
            [rt.idx3, np.zeros((out_rows, LANES), np.uint8)]),
        src_rows=rt.src_rows)


def _match_window_slots(bases: np.ndarray, rt, nwin: int,
                        out_rows: int = PROWS):
    """Permute each panel's window->operand-slot assignment so windows
    shared with the previous panel keep their slot (the TPU kernel's
    revolving input buffers then skip the re-fetch). Rewrites bases slot
    order, idx1 band rows and the sel band bits."""
    npan = bases.size // nwin
    b2 = bases.reshape(npan, nwin).copy()
    sr = nwin * 8
    idx1 = rt.idx1.reshape(npan, nwin, 8, LANES).copy()
    sel_a = rt.sel_a.reshape(npan, out_rows, LANES).copy()
    sel_b = rt.sel_b.reshape(npan, out_rows, LANES).copy()
    prev_slot: Dict[int, List[int]] = {}
    for t in range(nwin):
        prev_slot.setdefault(int(b2[0, t]), []).append(t)
    for p in range(1, npan):
        row = b2[p].copy()
        taken = np.zeros(nwin, dtype=bool)
        perm = np.full(nwin, -1, dtype=np.int64)      # old slot -> new slot
        # pass 1: keep shared windows on their previous slot
        avail = {w: list(ts) for w, ts in prev_slot.items()}
        for t in range(nwin):
            ts = avail.get(int(row[t]))
            if ts:
                s = ts.pop()
                if not taken[s]:
                    perm[t] = s
                    taken[s] = True
        # pass 2: the rest take free slots
        free = np.flatnonzero(~taken)
        fi = 0
        for t in range(nwin):
            if perm[t] < 0:
                perm[t] = free[fi]
                fi += 1
        b2[p, perm] = row
        idx1[p, perm] = idx1[p].copy()
        pi = np.arange(32, dtype=np.uint8)
        pi[:nwin] = perm.astype(np.uint8)
        sel_a[p] = (sel_a[p] & 7) | (pi[sel_a[p] >> 3] << 3)
        sel_b[p] = (sel_b[p] & 7) | (pi[sel_b[p] >> 3] << 3)
        prev_slot = {}
        for t in range(nwin):
            prev_slot.setdefault(int(b2[p, t]), []).append(t)
    rt2 = RoutePlan(idx1=idx1.reshape(npan * sr, LANES),
                    sel_a=sel_a.reshape(npan * out_rows, LANES),
                    sel_b=sel_b.reshape(npan * out_rows, LANES),
                    idx3=rt.idx3, src_rows=rt.src_rows)
    return b2.reshape(-1), rt2


def _pad_route(rt, npanels: int, tgt: int, out_rows: int = PROWS):
    """Pad a route plan with idle panels (every slot reads source (0, 0)
    via layer a — a defined value; their folds land in the scratch row)."""
    if npanels == tgt:
        return rt
    ap = tgt - npanels
    return RoutePlan(
        idx1=np.concatenate(
            [rt.idx1, np.zeros((ap * rt.src_rows, LANES), np.int8)]),
        sel_a=np.concatenate(
            [rt.sel_a, np.zeros((ap * out_rows, LANES), np.uint8)]),
        sel_b=np.concatenate(
            [rt.sel_b, np.zeros((ap * out_rows, LANES), np.uint8)]),
        idx3=np.concatenate(
            [rt.idx3, np.zeros((ap * out_rows, LANES), np.uint8)]),
        src_rows=rt.src_rows)


def build_spmv3_meta(tiles: TileSet, value_dtype=np.float32) -> Spmv3Meta:
    """Plan the v3 panel SpMV of this rank's shard of a TileSet (see the
    JAX package's ``build_spmv3_meta`` for the layout of every array). On
    a mesh every rank must call it: the maxima are collectives."""
    part, mesh = tiles.part, tiles.mesh
    b = mh.shard_of(part, mesh)
    NC = part.tile_cols
    dense_len = part.tile_rows

    n = int(tiles.nnz[b, 0])
    p = _pp.build_spmv3_plan(
        tiles.rows[b, :n].astype(np.int64),
        tiles.cols[b, :n].astype(np.int64),
        tiles.weights[b, :n] if tiles.weights is not None else None,
        tiles.NR, NC, dense_len,
        tiles.iv_dense[b] if tiles.ir is not None else None,
        value_dtype=value_dtype)

    def gmax(v):
        return int(mh.global_max(v, mesh))

    nwin = p.pa_nwin
    exp_panels = gmax(p.exp_panels)
    pa_panels = gmax(p.pa_panels)
    fix_panels = gmax(p.fix_panels)
    fixr_nwin = gmax(p.fixr_nwin)
    f2_panels = gmax(p.f2_panels)
    f2_nwin = gmax(p.f2_nwin)
    fix2_chunks = f2_panels * STRIPE
    nrb = gmax(int(p.fix_dst.max()) + 1 if p.fix_dst.size else 1)
    nrb = -(-nrb // STRIPE) * STRIPE + STRIPE     # + scratch row block
    if nrb > FOLD_SEG_ROWS:
        # multi-segment fold: nrb rounds to whole segments
        nrb = -(-nrb // FOLD_SEG_ROWS) * FOLD_SEG_ROWS
    nblocks = gmax(p.nblocks) + STRIPE
    dense_rows = gmax(p.dense_rows)
    # fix2 folds straight into the DENSE y layout (one scratch block for
    # pad chunks past dense_len), in whole segments when it spans several
    f2_rows = dense_rows + STRIPE
    if f2_rows > FOLD_SEG_ROWS:
        f2_rows = -(-f2_rows // FOLD_SEG_ROWS) * FOLD_SEG_ROWS
    xext_rows = exp_panels * XROWS
    has_w = tiles.weights is not None
    xr_nwin = _pp.NWIN_X

    sx = -(-(-(-NC // LANES)) // STRIPE) * STRIPE
    arrays: Dict[str, np.ndarray] = {}
    er = _append_fill_panel(_pad_route(p.exp_route, p.exp_panels,
                                       exp_panels))
    pr = _append_fill_panel(_pad_route(p.pa_route, p.pa_panels,
                                       pa_panels))
    # x -> x_ext route: pad + its own fill panel (content don't-care,
    # read only by the exp fill panel whose sel is all-0xF8)
    xr = _append_fill_panel(
        _pad_route(p.xr_route, p.exp_panels, exp_panels,
                   out_rows=XROWS), out_rows=XROWS)
    xb = np.zeros((exp_panels + 1) * xr_nwin, np.int32)
    xb[:p.xr_bases.size] = p.xr_bases
    # fix2: pad panels/windows (pad windows read y_mid block 0; pad
    # chunks' slots are unrouted = fill = fold identity)
    f2 = _pad_route(
        _pad_route_nwin(p.f2_route, p.f2_panels, p.f2_nwin, f2_nwin),
        p.f2_panels, f2_panels)
    f2b = np.zeros((f2_panels, f2_nwin), np.int32)
    lb2 = p.f2_bases.reshape(p.f2_panels, p.f2_nwin)
    f2b[:p.f2_panels, :p.f2_nwin] = lb2
    fr = _pad_route(
        _pad_route_nwin(p.fixr_route, p.fix_panels, p.fixr_nwin,
                        fixr_nwin),
        p.fix_panels, fix_panels)
    # pa bases cover the fill panel too: its windows read s0's fill
    # panel (block exp_panels*8)
    bases = np.full((pa_panels + 1) * nwin, exp_panels * 8, np.int32)
    bases[:p.pa_bases.size] = p.pa_bases
    # fixr bases: pad windows and panels read s1's fill panel
    gfill = pa_panels * STRIPE
    fb = np.full((fix_panels, fixr_nwin), gfill, np.int32)
    lb = p.fixr_bases.reshape(p.fix_panels, p.fixr_nwin)
    fb[:p.fix_panels, :p.fixr_nwin] = np.where(
        lb >= p.pa_panels * STRIPE, gfill, lb)
    bases, pr = _match_window_slots(bases, pr, nwin)
    fb, fr = _match_window_slots(fb.reshape(-1), fr, fixr_nwin)
    xb, xr = _match_window_slots(xb, xr, xr_nwin, out_rows=XROWS)
    f2b, f2 = _match_window_slots(f2b.reshape(-1), f2, f2_nwin)
    arrays["pa_bases"] = bases[None]
    arrays["fixr_bases"] = fb[None]
    arrays["xr_bases"] = xb[None]
    arrays["f2_bases"] = f2b[None]
    # one packed uint8 plan stream per route; fixr carries one extra
    # all-fill plan block past its fix_panels panels (the gated path's
    # target, kept so the arrays match the JAX package's)
    for nm, rt, npan in (
            ("pa", pr, pa_panels + 1),
            ("fixr", _append_fill_panel(fr), fix_panels + 1),
            ("f2", f2, f2_panels)):
        arrays[f"{nm}_plan"] = pack_route_plan(
            rt.idx1, rt.sel_a, rt.sel_b, rt.idx3, npan, rt.src_rows)[None]
    # fused x->x_ext + expand: both routes' plan blocks per panel
    npan_xe = exp_panels + 1
    xr_pk = pack_route_plan(
        xr.idx1, xr.sel_a, xr.sel_b, xr.idx3, npan_xe, xr.src_rows,
        out_rows=XROWS, two_layer=False).reshape(npan_xe, -1, LANES)
    ex_pk = pack_route_plan(
        er.idx1, er.sel_a, er.sel_b, er.idx3, npan_xe, er.src_rows
    ).reshape(npan_xe, -1, LANES)
    arrays["xe_plan"] = np.concatenate(
        [xr_pk, ex_pk], axis=1).reshape(1, -1, LANES)
    # fixr: segment-relative dst per chunk, per-panel segment ids
    # (non-decreasing), pad panels fold into the scratch rows
    fd = np.full(fix_panels * STRIPE, nrb - STRIPE, np.int64)
    fd[:p.fix_dst.size] = p.fix_dst
    sg = np.full(fix_panels, (nrb - STRIPE) // FOLD_SEG_ROWS, np.int64)
    sg[:p.fixr_seg.size] = p.fixr_seg
    # point pad panels at segments no real panel visits, so every
    # segment of y_mid is initialized by a fold pass
    nseg1 = nrb // FOLD_SEG_ROWS if nrb > FOLD_SEG_ROWS else 1
    have1 = set(sg[:p.fix_panels].tolist())
    miss1 = [s_ for s_ in range(nseg1) if s_ not in have1]
    npad1 = fix_panels - p.fix_panels
    if miss1 and len(miss1) > npad1:
        raise ValueError(f"fixr: {len(miss1)} uncovered fold segments "
                         f"but only {npad1} pad panels")
    for k_, s_ in enumerate(miss1):
        sg[p.fix_panels + k_] = s_
        fd[(p.fix_panels + k_) * STRIPE:(p.fix_panels + k_ + 1)
           * STRIPE] = s_ * FOLD_SEG_ROWS
    if not (np.diff(sg) >= 0).all():
        raise ValueError("fixr panels not segment-sorted")
    fd_rel = fd - np.repeat(sg, STRIPE) * FOLD_SEG_ROWS
    ini = np.zeros(fix_panels, np.int32)
    ini[0] = 1
    ini[1:] = (sg[1:] != sg[:-1]).astype(np.int32)
    arrays["fix_dst"] = fd_rel.astype(np.int32)[None]
    arrays["fixr_seg"] = sg.astype(np.int32)[None]
    arrays["fixr_ini"] = ini[None]
    hm = np.zeros(nrb, dtype=np.uint8)
    hm[:min(p.hub_mask.size, nrb)] = \
        p.hub_mask[:nrb].astype(np.uint8)
    arrays["hub_mask"] = np.broadcast_to(hm[:, None],
                                         (1, nrb, LANES)).copy()
    # fix2: pad panels fold into the scratch block in the LAST
    # segment; real dst entries become segment-relative (dense rows)
    seg_rows2 = min(f2_rows, FOLD_SEG_ROWS)
    fd2 = np.full(fix2_chunks, f2_rows - STRIPE, np.int64)
    fd2[:p.fix2_dst.size] = p.fix2_dst
    sg2 = np.full(f2_panels, (f2_rows - STRIPE) // FOLD_SEG_ROWS,
                  np.int64)
    sg2[:p.f2_seg.size] = p.f2_seg
    if not (np.diff(sg2) >= 0).all():
        raise ValueError("f2 panels not segment-sorted")
    fd2_rel = fd2 - np.repeat(sg2, STRIPE) * FOLD_SEG_ROWS
    ini2 = np.zeros(f2_panels, np.int32)
    ini2[0] = 1
    ini2[1:] = (sg2[1:] != sg2[:-1]).astype(np.int32)
    arrays["fix2_dst"] = fd2_rel.astype(np.int32)[None]
    arrays["f2_seg"] = sg2.astype(np.int32)[None]
    arrays["f2_ini"] = ini2[None]
    # dense segments no panel visits are never written by the fold;
    # spmv3_local masks them to the ⊕-identity
    nseg2 = max(1, f2_rows // seg_rows2)
    segok = np.zeros(nseg2, np.int32)
    segok[np.unique(sg2)] = 1
    arrays["f2_segok"] = segok[None]
    if has_w:
        ws = np.zeros(((exp_panels + 1) * PROWS, LANES),
                      dtype=value_dtype)
        if p.w_stream is not None:
            ws[:p.w_stream.shape[0]] = p.w_stream
        arrays["w_stream"] = ws[None]

    meta = Spmv3Meta(NC=NC, nblocks=nblocks, dense_rows=dense_rows,
                     f2_rows=f2_rows, exp_panels=exp_panels,
                     pa_panels=pa_panels, pa_nwin=nwin,
                     fix_panels=fix_panels, fixr_nwin=fixr_nwin,
                     fix2_chunks=fix2_chunks, f2_panels=f2_panels,
                     f2_nwin=f2_nwin, nrb=nrb, xext_rows=xext_rows,
                     xr_nwin=xr_nwin, sx_rows=sx, has_w=has_w,
                     arrays=arrays)
    validate_meta(meta)
    return meta


def _idx1_max(plan: np.ndarray, npanels: int, prows: int,
              blocks) -> int:
    """Largest idx1 byte over the given (start, rows) idx1 blocks of each
    panel of a packed plan stream."""
    pk = plan[:npanels * prows].reshape(npanels, prows, LANES)
    return max((int(pk[:, a:a + n].max()) if npanels and n else 0)
               for a, n in blocks)


def fill_blocks(meta) -> Dict[str, int]:
    """Each gated route's all-fill plan block: the trailing block that the
    gated path points inactive panels at (``panel_engine._gating_maps``)."""
    return {"xe_plan": meta.exp_panels, "pa_plan": meta.pa_panels,
            "fixr_plan": meta.fix_panels}


def validate_meta(meta) -> None:
    """Check every index the panel kernels follow, so no kernel can read
    or write out of bounds: window bases inside their source tables, idx1
    lanes < 128, fold rows inside their tables; and that each gated
    route's fill block routes no source into any slot (so the CUDA
    kernels may skip a gated-off panel's gathers). Raises ValueError."""
    a = {k: v[0] for k, v in meta.arrays.items()}
    if any(v.shape[0] != 1 for v in meta.arrays.values()):
        raise ValueError("meta: one shard's row (a leading axis of 1) "
                         "only")
    nxe, npa = meta.exp_panels + 1, meta.pa_panels + 1
    x_blocks = meta.sx_rows // STRIPE + 1        # x table + fill block
    checks = [
        ("xr_bases", a["xr_bases"], nxe * meta.xr_nwin, x_blocks),
        ("pa_bases", a["pa_bases"], npa * meta.pa_nwin, nxe * 8),
        ("fixr_bases", a["fixr_bases"], meta.fix_panels * meta.fixr_nwin,
         npa * 8),
        ("f2_bases", a["f2_bases"], meta.f2_panels * meta.f2_nwin,
         meta.nrb // STRIPE),
    ]
    for nm, v, n, hi in checks:
        if v.size != n or (n and (v.min() < 0 or v.max() >= hi)):
            raise ValueError(f"meta: {nm} outside [0, {hi}) or not {n} long")
    plans = [
        ("xe_plan", nxe, xe_plan_rows(meta.xr_nwin),
         [(0, meta.xr_nwin * STRIPE),
          (plan_rows(meta.xr_nwin * STRIPE, XROWS, False), XROWS)]),
        ("pa_plan", npa, plan_rows(meta.pa_nwin * STRIPE),
         [(0, meta.pa_nwin * STRIPE)]),
        ("fixr_plan", meta.fix_panels + 1,
         plan_rows(meta.fixr_nwin * STRIPE),
         [(0, meta.fixr_nwin * STRIPE)]),
        ("f2_plan", meta.f2_panels, plan_rows(meta.f2_nwin * STRIPE),
         [(0, meta.f2_nwin * STRIPE)]),
    ]
    for nm, npan, prows, blocks in plans:
        if a[nm].shape[0] < npan * prows:
            raise ValueError(f"meta: {nm} shorter than {npan} panels")
        if _idx1_max(a[nm], npan, prows, blocks) >= LANES:
            raise ValueError(f"meta: {nm} has an idx1 lane >= {LANES}")
    # fill block: both landing layers (sel_a, sel_b: 2*PROWS rows) pick a
    # band past the route's nsrc source bands in every slot
    for nm, sel0, nsrc, prows in (
            ("xe_plan", plan_rows(meta.xr_nwin * STRIPE, XROWS, False)
             + XROWS, XROWS // STRIPE, xe_plan_rows(meta.xr_nwin)),
            ("pa_plan", meta.pa_nwin * STRIPE, meta.pa_nwin,
             plan_rows(meta.pa_nwin * STRIPE)),
            ("fixr_plan", meta.fixr_nwin * STRIPE, meta.fixr_nwin,
             plan_rows(meta.fixr_nwin * STRIPE))):
        b0 = fill_blocks(meta)[nm] * prows + sel0
        if np.any(a[nm][b0:b0 + 2 * PROWS] >> 3 < nsrc):
            raise ValueError(f"meta: {nm} fill block routes a source")
    for nm_dst, nm_seg, npan, nrows in (
            ("fix_dst", "fixr_seg", meta.fix_panels, meta.nrb),
            ("fix2_dst", "f2_seg", meta.f2_panels, meta.f2_rows)):
        seg_rows = min(nrows, FOLD_SEG_ROWS)
        dst, seg = a[nm_dst][:npan * STRIPE], a[nm_seg][:npan]
        if npan and (dst.min() < 0 or dst.max() >= seg_rows
                     or seg.min() < 0
                     or (seg.max() + 1) * seg_rows > nrows):
            raise ValueError(f"meta: {nm_dst}/{nm_seg} outside the "
                             f"{nrows}-row table")
    if a["hub_mask"].shape != (meta.nrb, LANES):
        raise ValueError("meta: hub_mask shape")
    if meta.has_w and a["w_stream"].shape[0] < nxe * PROWS:
        raise ValueError("meta: w_stream shorter than the expand panels")
