"""Host-side static planner for the TPU shuffle/SpMV kernel pipeline.

The TPU has no efficient random gather/scatter: XLA lowers both to
serialized loops (measured ~0.12 Gelem/s for `jnp.take`, ~0.03 Gelem/s
for scatter-add on this chip). But the graph is STATIC: every index the
SpMV uses (edge columns for the x-gather, edge rows for the y-fold) is
known at ingest. This module converts those static index patterns into
*plans* — per-chunk routing tables driving three Pallas kernels
(kernels/shuffle_kernels.py) built only from operations the TPU does
well: lane crossbars (take_along_axis → tpu.dynamic_gather), masked
merges, dynamic single-row VMEM reads/writes, and streaming block I/O.

Edge order (chosen here, fully static): **(row-super, column, row)**.
Row-supers are contiguous 128-aligned row ranges balanced by edge count
to fit one VMEM buffer. Within a super, edges are column-sorted so the
x-side is local, while the y-side disorder is confined to the super's own
row blocks (~100-200 of them) — which is what keeps the radix pass count
at 3 and the alignment padding small.

Pipeline (per device, per superstep):
  expand  — x (VMEM-resident) → per-edge contributions in the static
            stream order; each 128-edge row reads one NWIN-row-aligned
            window of x and lane-shuffles values into place (hub
            duplication free: the crossbar is a gather).
  group   — stable radix-8 passes per super regroup contributions by
            destination 128-row block; alignment holes injected so every
            reduce chunk targets a single block.
  reduce  — blocked one-hot ⊕-fold of the grouped stream.

The planner simulates the radix passes in NumPy; the simulated final
layout IS the reduce plan.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

LANES = 128
SUB = 8
WROWS = 64                   # x-window height: 64 x-rows = 8192 columns
RED_ROWS = 8                 # stream rows per reduce chunk (8*128 = 1024 el)
RADIX_BITS = 3
RADIX = 1 << RADIX_BITS


@dataclass
class SpmvPlan:
    """Complete static plan for one device's SpMV."""
    NC: int
    NR: int
    nblocks: int
    n_edges: int
    # --- expand ---
    NWIN: int
    total_rows: int          # nsupers * rows_per_super
    grp: np.ndarray          # (total_rows//8,) int32 x-window id per step
    slot: np.ndarray         # (total_rows, 128) int8 sub-row within window
    lane: np.ndarray         # (total_rows, 128) int8
    ev_x: np.ndarray         # (total_rows, 128) int8
    w_stream: Optional[np.ndarray]
    # --- group ---
    rows_per_super: int
    nsupers: int
    npasses: int
    SMAX: int
    frag_dst: np.ndarray
    frag_idx: np.ndarray     # int8; -1 = lane not written (mask)
    # --- reduce ---
    chunk_block: np.ndarray
    lr: np.ndarray
    ev_r: np.ndarray
    final_src: np.ndarray    # simulated grouped layout (for tests)

    @property
    def pad_factor(self) -> float:
        return self.total_rows * LANES / max(1, self.n_edges)


@dataclass
class MonotoneExpandPlan:
    """Expand a compact vector to dense through a monotone index map (the
    TCSC renumbering inverse). Each 8-dense-row step reads at most two
    1024-entry windows of the compact table — two expand passes (A, B)
    whose results are combined by the B-validity mask."""
    out_rows: int
    grp_a: np.ndarray       # (out_rows//8,) int32
    grp_b: np.ndarray       # (out_rows//8,) int32
    slot_a: np.ndarray      # (out_rows, 128) int8
    slot_b: np.ndarray
    lane: np.ndarray        # (out_rows, 128) int8
    ev_a: np.ndarray        # (out_rows, 128) int8
    ev_b: np.ndarray


def plan_monotone_expand(iv_dense: np.ndarray) -> MonotoneExpandPlan:
    n = iv_dense.size
    out_rows = -(-n // (LANES * SUB)) * SUB
    ivp = np.full(out_rows * LANES, -1, dtype=np.int64)
    ivp[:n] = iv_dense
    iv3 = ivp.reshape(out_rows // SUB, SUB * LANES)
    valid = iv3 >= 0
    ivc = np.where(valid, iv3, np.int64(1 << 60))
    win = WROWS * LANES
    base = np.where(valid.any(axis=1), ivc.min(axis=1) // win, 0)
    rel = np.where(valid, iv3 - base[:, None] * win, 0)
    assert (rel[valid] < 2 * win).all(), "monotone span exceeds 2 windows"
    in_b = valid & (rel >= win)
    in_a = valid & (rel < win)
    rel_b = np.where(in_b, rel - win, 0)
    slot_a = np.where(in_a, rel // LANES, 0).astype(np.int8)
    slot_b = np.where(in_b, rel_b // LANES, 0).astype(np.int8)
    lane = np.where(valid, rel % LANES, 0).astype(np.int8)

    def r2(a):
        return a.reshape(out_rows, LANES)
    return MonotoneExpandPlan(
        out_rows=out_rows,
        grp_a=base.astype(np.int32), grp_b=(base + 1).astype(np.int32),
        slot_a=r2(slot_a), slot_b=r2(slot_b), lane=r2(lane),
        ev_a=r2(in_a.astype(np.int8)), ev_b=r2(in_b.astype(np.int8)))


def _super_boundaries(rows_sorted: np.ndarray, NR: int, e_cap: int):
    """Split the (row-sorted) edge stream into supers of ≤ e_cap edges.

    Cuts prefer 128-aligned row boundaries (so most blocks live in one
    super and pay chunk-alignment padding once), but a hub block larger
    than e_cap is cut mid-block: the reduce kernel accumulates per-block
    across chunks, so a block's partial folds from two supers combine
    correctly — no super may exceed the VMEM row budget."""
    E = rows_sorted.size
    bounds = [0]
    pos = 0
    while pos < E:
        hi = min(E, pos + e_cap)
        if hi == E:
            pos = E
        else:
            row_hi = int(rows_sorted[hi] // LANES) * LANES
            cut = int(np.searchsorted(rows_sorted, row_hi, side="left"))
            pos = cut if cut > bounds[-1] else hi
        bounds.append(pos)
    return bounds


def _attempt_feasible(r0: np.ndarray, c0: np.ndarray, bounds, rps: int,
                      NC: int) -> bool:
    """O(E) pre-check of the two capacity constraints (run-padding row
    budget and per-block chunk-alignment hole budget) so infeasible
    (rps, factor) attempts cost bincounts, not the full plan build.

    ``r0``/``c0``: rows/cols in row-sorted order; ``bounds``: the super
    cuts over that order."""
    E = r0.size
    if E == 0:
        return True
    nsup = len(bounds) - 1
    cap_el = rps * LANES
    sizes = np.diff(bounds)
    sup = np.repeat(np.arange(nsup), sizes)
    # --- expand rows: one run per (super, x-window group), padded to 8 rows
    sx3 = max(1, -(-NC // (WROWS * LANES)))
    grp = np.minimum(c0 // (WROWS * LANES), sx3 - 1)
    counts = np.bincount(sup * sx3 + grp, minlength=nsup * sx3)
    run_rows = (-(-counts // LANES) + SUB - 1) // SUB * SUB
    rows_used = run_rows.reshape(nsup, sx3).sum(axis=1)
    if (rows_used > rps).any():
        return False
    # --- group holes: per-(super, block) chunk padding must fit the free
    # positions (cap_el - occupied); (sup, block) is non-decreasing in
    # row-sorted order -> run-length encode without sorting
    chunk_el = RED_ROWS * LANES
    blk = r0 // LANES
    key = sup * (blk.max() + 1) + blk
    newrun = np.concatenate([[True], key[1:] != key[:-1]])
    starts = np.flatnonzero(newrun)
    cnt = np.diff(np.concatenate([starts, [E]]))
    pads = (-(-cnt // chunk_el)) * chunk_el - cnt
    pads_per_sup = np.bincount(sup[starts], weights=pads, minlength=nsup)
    free = cap_el - np.bincount(sup, minlength=nsup).astype(np.int64)
    return bool((pads_per_sup <= free).all())


def build_spmv_plan(rows: np.ndarray, cols: np.ndarray,
                    weights: Optional[np.ndarray],
                    NR: int, NC: int,
                    nwin: int = 8,
                    rows_per_super: int = 4096,
                    smax_cap: int = 32,
                    value_dtype=np.float32,
                    force_npasses: Optional[int] = None) -> SpmvPlan:
    """Build the full static plan from (compact-row, local-col) edges."""
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    order0 = np.argsort(rows, kind="stable")
    r0 = rows[order0]
    c0 = cols[order0]
    last = ValueError("no feasible plan")
    for rps in (rows_per_super, 2 * rows_per_super, 4 * rows_per_super,
                8 * rows_per_super):
        for factor in (0.75, 0.55, 0.35, 0.2, 0.1):
            e_cap = max(LANES, int(rps * factor) * LANES)
            bounds = _super_boundaries(r0, NR, e_cap)
            if len(bounds) < 2:
                bounds = [0, rows.size]
            if not _attempt_feasible(r0, c0, bounds, rps, NC):
                continue
            try:
                return _build_spmv_plan(rows, cols, weights, NR, NC, nwin,
                                        rps, smax_cap, value_dtype,
                                        factor, force_npasses,
                                        order0=order0, bounds=bounds)
            except ValueError as e:
                last = e
    raise last


def _build_spmv_plan(rows, cols, weights, NR, NC, nwin, rows_per_super,
                     smax_cap, value_dtype, cap_factor, force_npasses=None,
                     order0=None, bounds=None):
    E = int(rows.size)
    nblocks = max(1, -(-NR // LANES))
    rps = rows_per_super
    cap_el = rps * LANES
    chunk_el = RED_ROWS * LANES

    # ---- choose the static edge order: (row_super, col, row) ----
    if order0 is None:
        order0 = np.argsort(rows, kind="stable")
    r0 = rows[order0]
    if bounds is None:
        # edge cap per super: leave room for window-group/block padding
        e_cap = max(LANES, int(rps * cap_factor) * LANES)
        bounds = _super_boundaries(r0, NR, e_cap)
        if len(bounds) < 2:
            bounds = [0, E]
    nsupers = len(bounds) - 1
    sup0 = np.repeat(np.arange(nsupers, dtype=np.int64), np.diff(bounds))
    # the row-sorted stream is already row-ordered within each super, so
    # one stable sort by (super, col) yields (super, col, row) order —
    # cheaper than a 3-key lexsort at this scale
    perm = np.argsort(sup0 * np.int64(NC) + cols[order0], kind="stable")
    order = order0[perm]
    sup_s = sup0[perm]
    r_s = rows[order]
    c_s = cols[order]
    w_s = np.asarray(weights)[order] if weights is not None else None

    # ---- expand layout: per (super, window group) runs padded to rows --
    xrow = c_s // LANES
    grp = xrow // WROWS
    # run id changes when (super, grp) changes
    if E:
        chg = np.concatenate([[True], (sup_s[1:] != sup_s[:-1]) |
                              (grp[1:] != grp[:-1])])
    else:
        chg = np.zeros(0, dtype=bool)
    run_id = np.cumsum(chg) - 1 if E else np.zeros(0, np.int64)
    nruns = int(run_id[-1]) + 1 if E else 0
    run_start = np.flatnonzero(chg) if E else np.zeros(0, np.int64)
    run_len = np.diff(np.concatenate([run_start, [E]])) if E else run_start
    run_sup = sup_s[run_start] if E else run_start
    run_grp = grp[run_start] if E else run_start
    run_rows = (-(-run_len // LANES) + SUB - 1) // SUB * SUB

    # rows used per super
    rows_used = np.zeros(nsupers, dtype=np.int64)
    np.add.at(rows_used, run_sup, run_rows)
    if (rows_used > rps).any():
        raise ValueError("super row overflow; increase rows_per_super")

    # row offset of each run within its super (prefix over runs per super)
    run_row_off = np.zeros(nruns, dtype=np.int64)
    acc = np.cumsum(run_rows)
    sup_first_run = np.flatnonzero(np.concatenate(
        [[True], run_sup[1:] != run_sup[:-1]])) if nruns else np.zeros(0, np.int64)
    base_acc = np.zeros(nruns, dtype=np.int64)
    if nruns:
        start_acc = np.concatenate([[0], acc[:-1]])
        sup_base = start_acc[sup_first_run]
        base_acc = np.repeat(sup_base, np.diff(
            np.concatenate([sup_first_run, [nruns]])))
        run_row_off = start_acc - base_acc

    total_rows = nsupers * rps
    n_tot = total_rows * LANES

    # global stream position of each edge
    pos_in_run = np.arange(E) - run_start[run_id] if E else np.zeros(0, np.int64)
    row_global = (run_sup[run_id] * rps + run_row_off[run_id] +
                  pos_in_run // LANES) if E else np.zeros(0, np.int64)
    pos = row_global * LANES + pos_in_run % LANES

    # expand arrays
    grp_steps = np.zeros(total_rows // SUB, dtype=np.int32)
    slot = np.zeros((total_rows, LANES), dtype=np.int8)
    lane = np.zeros((total_rows, LANES), dtype=np.int8)
    ev_x = np.zeros((total_rows, LANES), dtype=np.int8)
    w_stream = (np.zeros((total_rows, LANES), dtype=value_dtype)
                if w_s is not None else None)

    rowp = pos // LANES
    lanep = pos % LANES
    slot[rowp, lanep] = (xrow % WROWS).astype(np.int8)
    lane[rowp, lanep] = (c_s % LANES).astype(np.int8)
    ev_x[rowp, lanep] = 1
    if w_stream is not None:
        w_stream[rowp, lanep] = w_s
    # window id per 8-row step: all rows of a run share the run's window
    if nruns:
        row_of_run_rows = np.repeat(run_sup * rps + run_row_off, run_rows) + \
            _concat_aranges(run_rows)
        Sx3 = max(1, -(-(-(-NC // LANES)) // WROWS))
        grp_of_rows = np.repeat(np.minimum(run_grp, Sx3 - 1), run_rows)
        step_start = row_of_run_rows % SUB == 0
        grp_steps[row_of_run_rows[step_start] // SUB] = \
            grp_of_rows[step_start]

    # per-position destination info
    blk_p = np.full(n_tot, -1, dtype=np.int64)
    lr_p = np.zeros(n_tot, dtype=np.int64)
    blk_p[pos] = r_s // LANES
    lr_p[pos] = r_s % LANES

    # ---- radix grouping per super (vectorized per super) ----
    npasses_needed = 1
    sup_blocks: List[np.ndarray] = []
    for s in range(nsupers):
        seg = blk_p[s * cap_el:(s + 1) * cap_el]
        b = np.unique(seg[seg >= 0])
        sup_blocks.append(b)
        bits = int(np.ceil(np.log2(max(2, b.size + 1))))
        npasses_needed = max(npasses_needed, -(-bits // RADIX_BITS))
    npasses = max(npasses_needed, force_npasses or 1)

    frag_dst = np.full((nsupers, npasses, rps, smax_cap), -1, dtype=np.int32)
    frag_idx = np.full((nsupers, npasses, rps, smax_cap * LANES), -1,
                       dtype=np.int8)
    smax_used = 1
    chunk_block = np.zeros(total_rows // RED_ROWS, dtype=np.int32)
    lr_out = np.zeros((total_rows, LANES), dtype=np.int8)
    ev_r = np.zeros((total_rows, LANES), dtype=np.int8)
    final_src = np.full(n_tot, -1, dtype=np.int64)

    for s in range(nsupers):
        base = s * cap_el
        seg_blk = blk_p[base:base + cap_el]
        valid0 = seg_blk >= 0
        blocks_sorted = sup_blocks[s]
        hole_key = blocks_sorted.size

        key = np.full(cap_el, hole_key, dtype=np.int64)
        if valid0.any():
            key[valid0] = np.searchsorted(blocks_sorted, seg_blk[valid0])
        src = np.where(valid0, np.arange(base, base + cap_el), -1)

        counts = np.bincount(key[valid0], minlength=hole_key) \
            if valid0.any() else np.zeros(hole_key, np.int64)
        pads = (-(-counts // chunk_el)) * chunk_el - counts
        pad_keys = np.repeat(np.arange(hole_key), pads)
        free = np.flatnonzero(~valid0)
        if pad_keys.size > free.size:
            raise ValueError("super capacity overflow (alignment pads)")
        key[free[:pad_keys.size]] = pad_keys

        cur_src, cur_key = src, key
        cur_hole = src < 0
        for p in range(npasses):
            digit = (cur_key >> (p * RADIX_BITS)) & (RADIX - 1)
            order2 = np.argsort(digit, kind="stable")
            dest = np.empty(cap_el, dtype=np.int64)
            dest[order2] = np.arange(cap_el)

            occ_idx = np.flatnonzero(~cur_hole)
            if occ_idx.size:
                srow = occ_idx // LANES
                slane = occ_idx % LANES
                dpos = dest[occ_idx]
                drow = dpos // LANES
                dlane = dpos % LANES
                fkey = srow * np.int64(2 * rps + 2) + drow
                o3 = np.argsort(fkey, kind="stable")
                fk = fkey[o3]
                newf = np.concatenate([[True], fk[1:] != fk[:-1]])
                fid = np.cumsum(newf) - 1
                nfrag = int(fid[-1]) + 1
                frow = srow[o3][newf]
                jseq = np.arange(nfrag)
                row_change = np.concatenate([[True], frow[1:] != frow[:-1]])
                starts_f = np.flatnonzero(row_change)
                jj = jseq - np.repeat(jseq[starts_f], np.diff(
                    np.concatenate([starts_f, [nfrag]])))
                if int(jj.max()) + 1 > smax_cap:
                    raise ValueError(
                        f"SMAX overflow: {int(jj.max()) + 1} > {smax_cap}")
                smax_used = max(smax_used, int(jj.max()) + 1)
                frag_dst[s, p, frow, jj] = drow[o3][newf].astype(np.int32)
                j_of = jj[fid]
                frag_idx[s, p, srow[o3], j_of * LANES + dlane[o3]] = \
                    slane[o3].astype(np.int8)

            nsrc = np.full(cap_el, -1, dtype=np.int64)
            nkey = np.zeros(cap_el, dtype=np.int64)
            nhole = np.ones(cap_el, dtype=bool)
            nsrc[dest] = cur_src
            nkey[dest] = cur_key
            nhole[dest] = cur_hole
            cur_src, cur_key, cur_hole = nsrc, nkey, nhole

        fv = ~cur_hole
        final_src[base:base + cap_el] = np.where(fv, cur_src, -1)
        lrv = np.where(fv, lr_p[np.where(fv, cur_src, 0)], 0)
        r0_ = s * rps
        lr_out[r0_:r0_ + rps] = lrv.reshape(rps, LANES).astype(np.int8)
        ev_r[r0_:r0_ + rps] = fv.reshape(rps, LANES).astype(np.int8)
        blk_final = np.full(cap_el, -1, dtype=np.int64)
        blk_final[fv] = blk_p[cur_src[fv]]
        bc = blk_final.reshape(-1, chunk_el)
        ch0 = r0_ // RED_ROWS
        vm = (bc >= 0)
        for ci in range(bc.shape[0]):
            if vm[ci].any():
                u = np.unique(bc[ci][vm[ci]])
                assert u.size == 1, f"reduce chunk spans blocks {u}"
                chunk_block[ch0 + ci] = u[0]

    return SpmvPlan(
        NC=NC, NR=NR, nblocks=nblocks, n_edges=E,
        NWIN=SUB, total_rows=total_rows,
        grp=grp_steps, slot=slot, lane=lane, ev_x=ev_x,
        w_stream=w_stream,
        rows_per_super=rps, nsupers=nsupers, npasses=npasses,
        SMAX=smax_used,
        frag_dst=frag_dst[:, :, :, :smax_used].copy(),
        frag_idx=frag_idx[:, :, :, :smax_used * LANES].copy(),
        chunk_block=chunk_block, lr=lr_out, ev_r=ev_r,
        final_src=final_src)


def _concat_aranges(lengths: np.ndarray) -> np.ndarray:
    """[arange(l) for l in lengths] concatenated, vectorized."""
    total = int(lengths.sum())
    out = np.arange(total, dtype=np.int64)
    starts = np.concatenate([[0], np.cumsum(lengths)[:-1]])
    out -= np.repeat(starts, lengths)
    return out
