"""Host-side planner for the v2 windowed-gather SpMV pipeline.

The v1 pipeline (kernels/shuffle_plan.py) routed contributions with
per-fragment dynamic row read-modify-writes inside the group kernel —
measured to dominate the superstep. v2 replaces every stage with one
primitive (kernels/gather_kernels.py::windowed_gather): an output-major
static gather whose writes are clean streaming (8,128) blocks and whose
reads are lane+sublane crossbars against a prefetch-selected window of the
source. The planner below turns the SpMV's static index structure into a
chain of such gathers:

  stream0 = expand(x)          per-edge contributions, (super, col) order
  stream1..P = radix passes    stable partition by 2 code bits per pass
  y_compact = compare-fold     (kernels/shuffle_kernels.py::grouped_reduce)
  y_dense  = mexp(y_compact)   TCSC renumbering inverse (IR expansion,
                               reference: compressed_column.hpp:274-297)

Supers are contiguous 256-block (32768-row) ranges of the compact row
space; the destination code of an edge is an 8-bit per-super block code
assigned bit-reversed by block size so every radix digit class carries
balanced mass. Four stable LSD passes of 2 bits each sort a super's
contributions by code; the final pass simultaneously lands each block's
region chunk-aligned (1024 slots) so every reduce chunk targets a single
128-row block — the alignment the compare-fold requires
(reference analog: the per-tile y accumulation of combine_2d_stationary,
vertex_program.hpp:1058-1113, re-planned as data movement).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

LANES = 128
SUB = 8
STEP_EL = SUB * LANES           # 1024 slots per step
SID_INVALID = 31
CODE_BITS = 8                   # blocks per super = 2^CODE_BITS
PASS_BITS = 2                   # radix-4 passes
NPASSES = CODE_BITS // PASS_BITS


@dataclass
class GatherPlan:
    """One windowed-gather application (see gather_kernels.windowed_gather).

    ``cidx`` is stored COMPACT: one (8,128) block per ACTIVE (step, subop)
    only — measured 84% of (step, subop) pairs are idle at RMAT-20 (avg
    nact 3.9 vs nsub 24), so streaming a dense (nsteps*nsub) cidx wasted
    ~5/6 of the pipeline's dominant byte stream.  The kernel reaches block
    ``base[i] + min(s, nact[i]-1)`` via the prefetch-driven index_map;
    idle subops repeat the step's last active block, so the revolving
    input buffer skips the DMA entirely."""
    out_rows: int
    nsub: int
    src_rows: int
    wsel: np.ndarray        # (nsteps*nsub,) int32
    nact: np.ndarray        # (nsteps,) int32
    base: np.ndarray        # (nsteps,) int32 exclusive cumsum of nact
    cidx: np.ndarray        # (sum(nact), 8, 128) int8 — compact, see above
    meta: np.ndarray        # (nsteps, block_rows, 128) uint8
    src_of: np.ndarray      # (out_rows*128,) int64 simulation (-1 = hole)
    block_rows: int = SUB   # output rows per step (8 or 64)


def build_gather_plan(src_rows: int, out_rows: int,
                      src_of: np.ndarray, spill: Optional[int] = None,
                      block_rows: int = SUB):
    """Compile an arbitrary static gather into the windowed-gather format.

    ``src_of[p]`` = linear source slot (row*128+lane) feeding output slot
    p, or -1 for a hole. Subops are created per (source 8-row block,
    conflict layer); a conflict is two outputs in the same lane wanting
    the same source row but different source lanes — resolved by pointing
    a second subop at the same window block.

    With ``spill=K``: instead of raising when a step needs more than
    ``SID_INVALID-1`` subops, return ``("spill", bad_pos)`` where
    ``bad_pos`` are the linear output slots whose subop id is >= K — the
    caller relocates them (chunked-fold callers append duplicate chunks
    with the same destination row) and retries.

    ``block_rows``: output rows per gather step. 8 = the classic
    windowed_gather; 64 = windowed_gather64, which amortizes each window
    fetch over 8192 output slots (8x cheaper window DMA per slot, at the
    price of a conflict key shared across the whole block).
    """
    assert out_rows % block_rows == 0 and src_rows % SUB == 0
    nsteps = out_rows // block_rows
    src_of = np.asarray(src_of, np.int64)
    pos = np.flatnonzero(src_of >= 0)
    sp = src_of[pos]
    step = pos // (block_rows * LANES)
    ri = (pos // LANES) % block_rows
    l = pos % LANES
    r = sp // LANES
    cl = sp % LANES
    b = r // SUB
    j = r % SUB

    # --- conflict layers: rank of distinct cl within (step, b, j, l)
    order = np.lexsort((cl, l, j, b, step))
    st_, b_, j_, l_, c_ = step[order], b[order], j[order], l[order], cl[order]
    grp_chg = np.ones(order.size, dtype=bool)
    if order.size > 1:
        grp_chg[1:] = ((st_[1:] != st_[:-1]) | (b_[1:] != b_[:-1]) |
                       (j_[1:] != j_[:-1]) | (l_[1:] != l_[:-1]))
    c_chg = grp_chg.copy()
    if order.size > 1:
        c_chg[1:] |= (c_[1:] != c_[:-1])
    t = np.cumsum(c_chg) - 1                     # distinct-(slot,c) counter
    gstart = np.flatnonzero(grp_chg)
    glen = np.diff(np.concatenate([gstart, [order.size]]))
    layer = t - np.repeat(t[gstart], glen)       # per-entry conflict layer

    # --- subop enumeration per step: unique (b, layer), ordered
    so = np.lexsort((layer, b_, st_))
    st2, b2, ly2 = st_[so], b_[so], layer[so]
    sub_chg = np.ones(so.size, dtype=bool)
    if so.size > 1:
        sub_chg[1:] = ((st2[1:] != st2[:-1]) | (b2[1:] != b2[:-1]) |
                       (ly2[1:] != ly2[:-1]))
    sub_seq = np.cumsum(sub_chg) - 1             # global subop counter
    step_chg = np.ones(so.size, dtype=bool)
    if so.size > 1:
        step_chg[1:] = st2[1:] != st2[:-1]
    sstart = np.flatnonzero(step_chg)
    slen = np.diff(np.concatenate([sstart, [so.size]]))
    sid2 = sub_seq - np.repeat(sub_seq[sstart], slen)  # subop id within step
    if sid2.size and int(sid2.max()) >= (
            spill if spill is not None else SID_INVALID):
        if spill is not None:
            bad = sid2 >= spill
            return "spill", pos[order[so[bad]]]
        raise ValueError(
            f"windowed-gather step needs {int(sid2.max()) + 1} subops "
            f"(max {SID_INVALID - 1}); re-pack with a lower bchg cap")
    sid_sorted = np.empty(order.size, dtype=np.int64)
    sid_sorted[so] = sid2
    # back to original entry order
    sid_e = np.empty(order.size, dtype=np.int64)
    sid_e[order] = sid_sorted
    b_e, j_e, c_e = b, j, cl                     # original order aliases

    nsub = int(sid_e.max()) + 1 if sid_e.size else 1
    nact = np.zeros(nsteps, dtype=np.int32)
    if so.size:
        nact_per = np.zeros(nsteps, dtype=np.int64)
        np.maximum.at(nact_per, st2, sid2 + 1)
        nact = nact_per.astype(np.int32)

    wsel = np.zeros(nsteps * nsub, dtype=np.int32)
    meta = np.full((nsteps, block_rows, LANES), SID_INVALID << 3,
                   dtype=np.uint8)

    flat_sub = step * nsub + sid_e
    wsel_set = np.zeros(nsteps * nsub, dtype=bool)
    wsel[flat_sub] = b_e.astype(np.int32)
    wsel_set[flat_sub] = True
    # forward-fill idle slots so the revolving window buffer skips the DMA
    idx = np.where(wsel_set, np.arange(wsel.size), 0)
    np.maximum.accumulate(idx, out=idx)
    wsel = wsel[idx]

    # compact cidx: block (base[step] + sid) per active (step, subop)
    base = np.zeros(nsteps, dtype=np.int32)
    base[1:] = np.cumsum(nact.astype(np.int64))[:-1].astype(np.int32)
    total = max(1, int(nact.sum()))
    cidx = np.zeros((total, SUB, LANES), dtype=np.int8)
    cidx[base[step] + sid_e, j_e, l] = c_e.astype(np.int8)
    meta[step, ri, l] = (j_e | (sid_e << 3)).astype(np.uint8)
    return GatherPlan(out_rows=out_rows, nsub=nsub, src_rows=src_rows,
                      wsel=wsel, nact=nact, base=base, cidx=cidx, meta=meta,
                      src_of=src_of, block_rows=block_rows)


def _pack_steps(bchg: np.ndarray, boundaries: np.ndarray,
                elem_cap: int = STEP_EL, bchg_cap: int = 10) -> np.ndarray:
    """Greedy step packing: walk elements in target order, close a step at
    ``elem_cap`` elements or ``bchg_cap`` source-window changes, and force
    breaks at ``boundaries`` (super starts). Returns step id per element.
    The loop is per *step* (~E/1024 iterations), not per element."""
    n = bchg.size
    csum = np.concatenate([[0], np.cumsum(bchg.astype(np.int64))])
    step_of = np.zeros(n, dtype=np.int64)
    bset = set(boundaries.tolist())
    bnd = np.asarray(sorted(bset), dtype=np.int64)
    pos = 0
    sid = 0
    while pos < n:
        hi = min(n, pos + elem_cap)
        # cap window changes within the step
        limit = csum[pos] + bchg_cap
        hi2 = int(np.searchsorted(csum, limit, side="left"))
        hi = max(pos + 1, min(hi, hi2))
        # stop at the next forced boundary
        k = int(np.searchsorted(bnd, pos, side="right"))
        if k < bnd.size and bnd[k] < hi:
            hi = int(bnd[k])
        step_of[pos:hi] = sid
        sid += 1
        pos = hi
    return step_of


def _pack_expand_steps(sup_s: np.ndarray, xblk: np.ndarray,
                       lane0: np.ndarray, bchg_cap: int
                       ) -> Tuple[np.ndarray, int]:
    """Greedy expand-step packing. Edges arrive (super, col)-sorted with a
    hashed primary lane; a step takes up to 1024 edges subject to
    ≤ bchg_cap distinct source windows and no super crossing. Placement is
    two-round: primary lane while it has free sublanes, then any free slot
    (the resulting same-row/same-lane collisions become subop layers in
    build_gather_plan). Returns (linear output slot per edge, nsteps)."""
    E = sup_s.size
    if E == 0:
        return np.zeros(0, np.int64), 1
    bchg = np.ones(E, dtype=bool)
    bchg[1:] = (xblk[1:] != xblk[:-1]) | (sup_s[1:] != sup_s[:-1])
    w_id = np.cumsum(bchg)                        # window ordinal per edge
    pos_out = np.zeros(E, dtype=np.int64)
    i = 0
    step = 0
    while i < E:
        hi = min(E, i + STEP_EL)
        hi = min(hi, int(np.searchsorted(w_id, w_id[i] + bchg_cap, "left")))
        hi = min(hi, int(np.searchsorted(sup_s, sup_s[i], "right")))
        m = hi - i
        seg = lane0[i:hi]
        # round 1: rank within primary lane, keep sublanes 0..7
        o = np.argsort(seg, kind="stable")
        sl = seg[o]
        newl = np.concatenate([[True], sl[1:] != sl[:-1]])
        st = np.flatnonzero(newl)
        ln = np.diff(np.concatenate([st, [sl.size]]))
        rank = np.empty(sl.size, np.int64)
        rank[o] = np.arange(sl.size) - np.repeat(st, ln)
        slot = rank * LANES + seg                 # (ri, lane) linearized
        ok = rank < SUB
        # round 2: overflow edges take the free slots in order
        if not ok.all():
            used = np.zeros(STEP_EL, dtype=bool)
            used[slot[ok]] = True
            free = np.flatnonzero(~used)
            ov = np.flatnonzero(~ok)
            slot[ov] = free[:ov.size]
        pos_out[i:hi] = step * STEP_EL + slot
        step += 1
        i = hi
    return pos_out, step


def _pack_gather_steps(srcb8: np.ndarray, force_break: np.ndarray,
                       span_cap: int) -> Tuple[np.ndarray, int]:
    """Pack a gather's outputs (elements given in target order) into steps
    of ≤ 1024 slots touching ≤ span_cap distinct source 8-row blocks, with
    forced breaks (super / final-block boundaries). Returns (linear output
    slot per element, nsteps)."""
    E = srcb8.size
    if E == 0:
        return np.zeros(0, np.int64), 1
    brk = np.flatnonzero(force_break)
    pos_out = np.zeros(E, dtype=np.int64)
    i = 0
    step = 0
    while i < E:
        hi = min(E, i + STEP_EL)
        k = int(np.searchsorted(brk, i, side="right"))
        if k < brk.size and brk[k] < hi:
            hi = int(brk[k])
        seg = srcb8[i:hi]
        _, first = np.unique(seg, return_index=True)
        if first.size > span_cap:
            hi = i + int(np.sort(first)[span_cap])
        pos_out[i:hi] = step * STEP_EL + np.arange(hi - i)
        step += 1
        i = hi
    return pos_out, step


@dataclass
class Spmv2Plan:
    """Complete static plan for one device's v2 SpMV."""
    NC: int
    NR: int                 # padded compact row space
    nblocks: int            # NR // 128 (y_compact rows, padded to mult 8)
    n_edges: int
    npasses: int
    expand: GatherPlan
    passes: List[GatherPlan]
    mexp: GatherPlan
    dense_rows: int         # mexp out_rows
    w_stream: Optional[np.ndarray]   # (expand nsteps, 8, 128) value dtype
    # fold arrays (consumed by shuffle_kernels.grouped_reduce)
    lr: np.ndarray          # (final_rows, 128) int8
    ev_r: np.ndarray        # (final_rows, 128) int8
    chunk_block: np.ndarray  # (final_rows//8,) int32
    final_src: np.ndarray   # (final_rows*128,) int64 edge index per slot

    @property
    def pad_factor(self) -> float:
        return self.lr.size / max(1, self.n_edges)


def _bitrev(x: np.ndarray, bits: int) -> np.ndarray:
    out = np.zeros_like(x)
    for i in range(bits):
        out |= ((x >> i) & 1) << (bits - 1 - i)
    return out


def build_spmv2_plan(rows: np.ndarray, cols: np.ndarray,
                     weights: Optional[np.ndarray],
                     NR: int, NC: int, dense_len: int,
                     iv_dense: Optional[np.ndarray],
                     value_dtype=np.float32,
                     bchg_cap: int = 10,
                     span_cap: int = 12) -> Spmv2Plan:
    """Build the full v2 plan from (compact-row, local-col) edges.

    ``rows``: renumbered segment ids in [0, NR); ``cols``: local columns in
    [0, NC); ``iv_dense``: dense row -> compact id (or None → identity,
    CSC-style dense y). ``dense_len``: dense row-block length (C*L).
    """
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    E = int(rows.size)
    nblocks_raw = max(1, -(-NR // LANES))
    nblocks = -(-nblocks_raw // SUB) * SUB       # src table rows, mult of 8

    blk = rows // LANES
    sup = blk >> CODE_BITS                        # 256-block supers
    nsup = int(sup.max()) + 1 if E else 1
    bis = blk & ((1 << CODE_BITS) - 1)            # block id within super

    # --- per-super block codes: bit-reversed by size rank (balances the
    # digit-class mass every pass sees, incl. hub blocks)
    code = np.zeros(E, dtype=np.int64)
    if E:
        sizes = np.bincount(sup * (1 << CODE_BITS) + bis,
                            minlength=nsup << CODE_BITS)
        sizes2 = sizes.reshape(nsup, 1 << CODE_BITS)
        rank = np.argsort(np.argsort(-sizes2, axis=1, kind="stable"),
                          axis=1, kind="stable")
        codes_tab = _bitrev(rank.astype(np.int64), CODE_BITS)
        code = codes_tab[sup, bis]

    # --- expand layout: (super, col) order, conflict-free lane placement.
    # Lane of an edge = (cl + 8*(dup//8)) % 128 where cl = col % 128 and
    # dup = the edge's duplicate rank within its column (per super). Two
    # distinct columns of the same x-row always have distinct cl, so a
    # (window, source-row, lane) slot never sees two different source
    # lanes at the base claim — hub-column duplicates overflow to +8-lane
    # strides (8 slots each), colliding only on mod-8 alignment (rare,
    # absorbed as subop layers by build_gather_plan).
    order_sc = np.lexsort((cols, sup)) if E else np.zeros(0, np.int64)
    c_s = cols[order_sc]
    sup_s = sup[order_sc]
    xblk = c_s // (SUB * LANES)                   # source 8-row window
    if E:
        cchg = np.concatenate(
            [[True], (c_s[1:] != c_s[:-1]) | (sup_s[1:] != sup_s[:-1])])
        cstart = np.flatnonzero(cchg)
        clen = np.diff(np.concatenate([cstart, [E]]))
        dup = np.arange(E) - np.repeat(cstart, clen)
        # rotate by x-row so hub columns of different rows spread apart
        lane0 = ((c_s % LANES) + 45 * (c_s // LANES) +
                 SUB * (dup // SUB)) % LANES
    else:
        lane0 = np.zeros(0, np.int64)
    pos0, nsteps0 = _pack_expand_steps(sup_s, xblk, lane0, bchg_cap)
    rows0 = nsteps0 * SUB
    src_of0 = np.full(rows0 * LANES, -1, dtype=np.int64)
    src_of0[pos0] = c_s                           # x table is (NC/128, 128)
    sxrows = -(-NC // LANES)
    sxrows = -(-sxrows // SUB) * SUB
    expand_plan = build_gather_plan(sxrows, rows0, src_of0)

    w_stream = None
    if weights is not None:
        w_stream = np.zeros((nsteps0, SUB, LANES), dtype=value_dtype)
        w_flat = w_stream.reshape(-1)
        w_flat[pos0] = np.asarray(weights)[order_sc]
        w_stream = w_flat.reshape(nsteps0, SUB, LANES)

    # --- radix passes: stable LSD, 2 bits/pass, within supers.
    # cur_pos[e] = linear slot of edge (expand order) in the current stream
    cur_pos = np.empty(E, dtype=np.int64)
    cur_pos[np.arange(E)] = pos0                  # edges indexed in sc order
    edge_code = code[order_sc]
    edge_sup = sup_s
    edge_blk = blk[order_sc]
    edge_row = rows[order_sc]

    passes: List[GatherPlan] = []
    prev_rows = rows0
    for p in range(NPASSES):
        digit = (edge_code >> (p * PASS_BITS)) & ((1 << PASS_BITS) - 1)
        # stable rank within (super, digit): order by (super, digit, cur order)
        o = np.lexsort((cur_pos, digit, edge_sup)) if E else np.zeros(0, np.int64)
        if E:
            srcb8 = cur_pos[o] // STEP_EL
            es = edge_sup[o]
            force = np.zeros(E, dtype=bool)
            force[0] = True
            force[1:] = es[1:] != es[:-1]
            if p == NPASSES - 1:
                # final pass: break at block changes so every 1024-slot
                # reduce chunk targets a single 128-row block
                bk = es * (1 << CODE_BITS) + edge_code[o]
                force[1:] |= bk[1:] != bk[:-1]
            tgt, nst = _pack_gather_steps(srcb8, force, span_cap)
            new_pos = np.empty(E, dtype=np.int64)
            new_pos[o] = tgt
        else:
            new_pos = np.zeros(0, np.int64)
            nst = 1
        out_rows = nst * SUB
        src_of = np.full(out_rows * LANES, -1, dtype=np.int64)
        src_of[new_pos] = cur_pos
        passes.append(build_gather_plan(prev_rows, out_rows, src_of))
        cur_pos = new_pos
        prev_rows = out_rows

    final_rows = prev_rows
    # --- fold arrays over the final layout
    lr = np.zeros((final_rows, LANES), dtype=np.int8)
    ev_r = np.zeros((final_rows, LANES), dtype=np.int8)
    chunk_block = np.zeros(final_rows // SUB, dtype=np.int32)
    final_src = np.full(final_rows * LANES, -1, dtype=np.int64)
    if E:
        lr_f = lr.reshape(-1)
        lr_f[cur_pos] = (edge_row % LANES).astype(np.int8)
        ev_f = ev_r.reshape(-1)
        ev_f[cur_pos] = 1
        final_src[cur_pos] = order_sc            # original edge index
        cb = np.zeros(final_rows // SUB, dtype=np.int64)
        np.maximum.at(cb, cur_pos // STEP_EL, edge_blk)
        # assert chunk purity
        cbmin = np.full(final_rows // SUB, np.iinfo(np.int64).max)
        np.minimum.at(cbmin, cur_pos // STEP_EL, edge_blk)
        occ = np.zeros(final_rows // SUB, dtype=bool)
        occ[cur_pos // STEP_EL] = True
        assert (cb[occ] == cbmin[occ]).all(), "reduce chunk spans blocks"
        chunk_block = cb.astype(np.int32)

    # --- mexp: compact y (nblocks,128) -> dense rows
    dense_rows = -(-dense_len // LANES)
    dense_rows = -(-dense_rows // SUB) * SUB
    if iv_dense is not None:
        iv = np.asarray(iv_dense, np.int64)
        src_mx = np.full(dense_rows * LANES, -1, dtype=np.int64)
        src_mx[:iv.size] = np.where(iv >= 0, iv, -1)
    else:
        src_mx = np.arange(dense_rows * LANES, dtype=np.int64)
        src_mx[min(NR, dense_len):] = -1
    mexp_plan = build_gather_plan(nblocks, dense_rows, src_mx)

    return Spmv2Plan(
        NC=NC, NR=NR, nblocks=nblocks, n_edges=E, npasses=NPASSES,
        expand=expand_plan, passes=passes, mexp=mexp_plan,
        dense_rows=dense_rows, w_stream=w_stream,
        lr=lr, ev_r=ev_r, chunk_block=chunk_block, final_src=final_src)


def simulate_gather(plan: GatherPlan, src2d: np.ndarray,
                    fill) -> np.ndarray:
    """Numpy oracle for windowed_gather (tests)."""
    out = np.full((plan.out_rows, LANES), fill, dtype=src2d.dtype)
    flat = src2d.reshape(-1)
    valid = plan.src_of >= 0
    out.reshape(-1)[valid] = flat[plan.src_of[valid]]
    return out
