"""Host planner for the v3 "panel" SpMV pipeline — all-static kernels.

On-chip probes (docs/KERNEL_NOTES.md) show this stack executes static
streamed vector ops fast (select 1.7ns, take0 9ns, take1 29ns per
(8,128)) but charges 60-300ns for anything scalar-driven (dynamic VMEM
slices, SMEM reads in inner loops, per-subop DMA). The v3 pipeline
therefore contains NO data-dependent control or addressing at all: every
kernel is a fixed sequence of streamed crossbars/selects over (64,128)
panels, and all irregularity is absorbed at plan time by *exact quotas*:

  x_ext   per edge-panel, the ≤3968 distinct columns it references,
          gathered into a 32-row panel (hub duplication becomes in-panel
          routing, so consumption is rate-constant).
  expand  route x_ext panel → (64,128) contribution panel, ⊗-weighted,
          arranged digit0-striped: rows [8d,8d+8) hold EXACTLY 1024
          elements of block-code digit0 = d (planner holes make quotas
          exact; holes carry the ⊕-identity).
  pass A  corner turn: output panel j of (super, d0) region reads stripe
          d0 of 8 consecutive expand panels (static block reads), and
          routes so rows [8e,8e+8) hold digit1 = e AND every element
          sits in its final fold lane.
  pass B  output panel of region (d0, d1) is a single 128-row block:
          masked column-⊕ over its stripes accumulates straight into the
          lane-space y table — no stream write.
  fixup   lane-space → (block, lr) compact y (tiny static gather+fold).

The in-panel route is the 3-stage decomposition (lane crossbar →
vertical move → lane crossbar) of an arbitrary (64,128) assignment; the
planner assigns intermediate lanes greedily (vectorized over panels,
sequential only over the 64 source rows), with capacity per
(source row, lane) of 1 and per (target stripe, lane) of 8.

Reference parity: this plans the same computation as spmv_stationary's
edge loop + partial-y fold (vertex_program.hpp:1116-1327, 1510-1573);
the quotas/holes are the TPU-shaped version of the reference's per-tile
nedges==0 skips and padding-free serial scatter.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

# GRAPHTAP_PLAN_DEBUG=1: self-check every pipeline stage during plan
# construction against the per-edge position maps (host-side simulate;
# ~2x plan time) — pinpoints the first stage whose plan loses an edge
_PLAN_DEBUG = bool(os.environ.get("GRAPHTAP_PLAN_DEBUG"))
# GRAPHTAP_PLAN_PROFILE=1: print per-phase plan-build wall times
_PLAN_PROFILE = bool(os.environ.get("GRAPHTAP_PLAN_PROFILE"))

LANES = 128
PROWS = 64                 # panel rows
PSLOTS = PROWS * LANES     # 8192
STRIPE = 8                 # rows per digit stripe
NDIG = 8                   # radix: 3 bits per pass
CODE_BITS = 6              # code bits per super: 2 radix-8 passes
SUPER_EDGES = 384 * 1024   # adaptive super target edge mass
NSUP_BLOCKS = 1 << CODE_BITS   # 64 blocks (8192 compact rows) per super
XROWS = 32                 # x_ext panel rows (4096 column slots)
SLOT_W = 112               # x_ext slots per row (16 spare lanes per row
                           # keep stage-1 entry assignment off full load)
XCAP = (XROWS - 1) * SLOT_W  # last x_ext row reserved as fill
QUOTA = 900                # elements per digit stripe (1024 slots - slack:
                           # the route's greedy two-choice lane assignment
                           # needs ~6% free entries to stay off the full-
                           # load Konig regime)
FOLD_SEG_ROWS = 8192       # y-table rows VMEM-resident per route_fold
                           # segment (4 MiB f32): fixr panels are packed
                           # segment-sorted so the kernel streams y-table
                           # segments instead of holding nrb rows (12+
                           # MiB at RMAT-20 — over the ~16 MiB VMEM)
DUP_CAP = 128              # max edges per x_ext slot: hub columns get
                           # multiple slots so one source entry never
                           # starves its row's stage-1 lane entries
DCAP = 96                  # stage-1 entry demand per x_ext row (of 128)
NWIN_X = 24                # max distinct source x windows per panel: the
                           # x->x_ext ROUTE reads them as corner-turn
                           # window operands (sel band encoding allows
                           # <= 31; 24 leaves the no-match fill band and
                           # bounds VMEM).  Replaced the windowed-gather
                           # BBLK_STEP per-step bound — the gather spent
                           # 37.5 ms/iter (44% of the superstep) on
                           # (16384 x 24)-step grid overhead at RMAT-20
                           # while the equivalent route costs ~1 grid
                           # step per panel.


def _concat_ranges(lengths: np.ndarray) -> np.ndarray:
    """[arange(l) for l in lengths], concatenated (vectorized)."""
    lengths = np.asarray(lengths, np.int64)
    total = int(lengths.sum())
    out = np.arange(total, dtype=np.int64)
    starts = np.concatenate([[0], np.cumsum(lengths)[:-1]])
    return out - np.repeat(starts, lengths)


@dataclass
class RoutePlan:
    """One in-panel 3-stage route with two landing layers:
      u   = take1(v, idx1) per source row band
      w_a[i,m] = u[row_a(i,m), m];  w_b likewise (band+row packed in sel)
      out[i,l] = take1(w_b if pick else w_a, m)   (m | pick<<7 in idx3)
    Streams are (rows,128) int8/uint8 per panel, concatenated over
    panels. The second layer makes the greedy intermediate-lane
    assignment succeed at full load (two-choice placement)."""
    idx1: np.ndarray       # (npanels*src_rows, 128) int8: src lane at (r, m)
    sel_a: np.ndarray      # (npanels*64, 128) uint8: srcrow%8 | band<<3
    sel_b: np.ndarray      # (npanels*64, 128) uint8
    idx3: np.ndarray       # (npanels*64, 128) uint8: m | pick<<7 at (i, l)
    src_rows: int


RELAXED_SLOTS = 0     # diagnostic: slots placed via lane relaxation
# (tests assert the relax tier actually fires on hub-heavy loads)


class RouteInfeasible(ValueError):
    """The greedy route solver could not place every slot.  Callers whose
    lanes are semantically fixed (pass A: the fold lane) re-plan with
    relaxed quotas; callers whose lanes are planner-internal (x->x_ext)
    pass ``relax_lane=True`` instead and never see this."""


def _route_workers() -> int:
    """Worker processes for parallel route solving (panels are mutually
    independent in the solver, so panel ranges shard perfectly).  Env
    knob GRAPHTAP_PLAN_WORKERS; default = CPU count."""
    import os
    v = os.environ.get("GRAPHTAP_PLAN_WORKERS")
    if v is not None:
        return max(1, int(v))
    return os.cpu_count() or 1


def _route_worker_main(inp: str, outp: str) -> None:
    """Subprocess worker: solve one contiguous panel range.  Launched
    with this FILE loaded standalone (no package import, no jax): a
    fork of the JAX-threaded parent can inherit a held lock and
    futex-deadlock, and spawn/forkserver re-execute unguarded __main__
    modules — a fresh subprocess over npz files has neither failure
    mode.  Inputs are downcast (~5 B/slot)."""
    z = np.load(inp)
    npan, src_rows, fill_from, max_row, relax, onelay =         [int(v) for v in z["meta"]]
    global RELAXED_SLOTS
    r0 = RELAXED_SLOTS
    plan, rows, lanes = _route_panels_seq(
        z["sr"].astype(np.int64), z["sc"].astype(np.int64),
        z["st"].astype(np.int64),
        z["dl"].astype(np.int64) if "dl" in z.files else None,
        z["pof"].astype(np.int64), npan, src_rows,
        fill_from=None if fill_from < 0 else fill_from,
        relax_lane=bool(relax),
        max_row=None if max_row < 0 else max_row,
        one_layer=bool(onelay))
    np.savez(outp, idx1=plan.idx1, sela=plan.sel_a, selb=plan.sel_b,
             idx3=plan.idx3, rows=rows.astype(np.int8),
             lanes=lanes.astype(np.int8),
             relaxed=np.asarray([RELAXED_SLOTS - r0]))


def _route_panels(src_r, src_c, dst_stripe, dst_lane, panel_of, npanels,
                  src_rows, fill_from=None, relax_lane=False,
                  max_row=None, one_layer=False):
    """Greedy 3-stage route assignment — parallel front end.

    Panels are independent in the solver (all state is per-panel), so
    large jobs shard into contiguous panel ranges solved by forked
    worker processes; the per-range plans concatenate panel-wise.  The
    route solver is ~75%% of total plan-build time (profiled at scale
    18), so this sets the wall-clock for RMAT-22+ planning."""
    global RELAXED_SLOTS
    nw = min(_route_workers(), max(1, npanels // 32))
    # in-process sequential unless (a) the job is big enough that the
    # solver's per-round temporaries must stay out of this process
    # (RMAT-22+: the parent otherwise exceeds host memory limits), or
    # (b) there are real cores to win on (2 "CPUs" here are HT siblings
    # — measured 30% SLOWER with 2 workers than sequential)
    if nw <= 1 or (nw <= 2 and panel_of.size < 48_000_000):
        return _route_panels_seq(src_r, src_c, dst_stripe, dst_lane,
                                 panel_of, npanels, src_rows,
                                 fill_from=fill_from,
                                 relax_lane=relax_lane, max_row=max_row,
                                 one_layer=one_layer)
    import shutil
    import subprocess
    import sys
    import tempfile
    order = np.argsort(panel_of, kind="stable")
    nsh = max(nw, min(npanels, -(-panel_of.size // 6_000_000)))
    pb = [(npanels * k) // nsh for k in range(nsh + 1)]
    cuts = np.searchsorted(panel_of[order], pb)
    tmpdir = tempfile.mkdtemp(prefix="gt_route_")
    jobs, sels = [], []
    meta_tail = [-1 if fill_from is None else fill_from,
                 -1 if max_row is None else max_row,
                 int(relax_lane), int(one_layer)]
    try:
        for k in range(nsh):
            if pb[k + 1] <= pb[k]:
                continue
            sel = order[cuts[k]:cuts[k + 1]]
            arrs = dict(
                sr=src_r[sel].astype(np.int16),
                sc=src_c[sel].astype(np.int8),
                st=dst_stripe[sel].astype(np.int8),
                pof=(panel_of[sel] - pb[k]).astype(np.int32),
                meta=np.asarray([pb[k + 1] - pb[k], src_rows]
                                + meta_tail, np.int64))
            if dst_lane is not None:
                arrs["dl"] = dst_lane[sel].astype(np.int8)
            inp = os.path.join(tmpdir, f"job{len(jobs)}.npz")
            np.savez(inp, **arrs)
            jobs.append(inp)
            sels.append(sel)
        # dedicated subprocesses loading THIS FILE standalone — see
        # _route_worker_main for why not fork/spawn/forkserver pools
        boot = ("import sys; from importlib import util; "
                "spec = util.spec_from_file_location('gt_pp', sys.argv[1]); "
                "m = util.module_from_spec(spec); "
                "sys.modules['gt_pp'] = m; "      # dataclasses looks it up
                "spec.loader.exec_module(m); "
                "m._route_worker_main(sys.argv[2], sys.argv[3])")
        pending = list(enumerate(jobs))
        running = []
        outs = [j + ".out.npz" for j in jobs]
        # stderr goes to a per-job FILE: a PIPE drained only for the head
        # of the queue would deadlock any non-head worker that emits more
        # than the pipe buffer (e.g. a long traceback + numpy warnings)
        while pending or running:
            while pending and len(running) < nw:
                i, inp = pending.pop(0)
                ef = open(inp + ".err", "wb")
                pr = subprocess.Popen(
                    [sys.executable, "-c", boot, os.path.abspath(__file__),
                     inp, outs[i]],
                    stdout=subprocess.DEVNULL, stderr=ef)
                ef.close()
                running.append((i, pr, inp + ".err"))
            i, pr, epath = running[0]
            pr.wait()
            running.pop(0)
            if pr.returncode != 0:
                with open(epath, "rb") as f:
                    tail = f.read().decode(errors="replace")[-2000:]
                if "RouteInfeasible" in tail:
                    raise RouteInfeasible(f"route worker {i}: {tail}")
                raise RuntimeError(f"route worker {i} failed: {tail}")
        parts = [np.load(o) for o in outs]
        idx1 = np.concatenate([p["idx1"] for p in parts])
        sel_a = np.concatenate([p["sela"] for p in parts])
        sel_b = np.concatenate([p["selb"] for p in parts])
        idx3 = np.concatenate([p["idx3"] for p in parts])
        rows = np.full(panel_of.size, -1, dtype=np.int64)
        lanes = np.full(panel_of.size, -1, dtype=np.int64)
        for sel, p in zip(sels, parts):
            rows[sel] = p["rows"].astype(np.int64)
            lanes[sel] = p["lanes"].astype(np.int64)
            RELAXED_SLOTS += int(p["relaxed"][0])
        for p in parts:
            p.close()
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)
    plan = RoutePlan(idx1=idx1, sel_a=sel_a, sel_b=sel_b, idx3=idx3,
                     src_rows=src_rows)
    return plan, rows, lanes


_NATIVE_LIB = None
_NATIVE_TRIED = False


def _native_route_lib():
    """ctypes handle to the native route solver, or None.  Self-contained
    (no package import): route workers load THIS FILE standalone."""
    global _NATIVE_LIB, _NATIVE_TRIED
    if _NATIVE_TRIED:
        return _NATIVE_LIB
    _NATIVE_TRIED = True
    if os.environ.get("GRAPHTAP_NATIVE_ROUTE", "1") == "0":
        return None
    import ctypes
    import importlib.util
    # the package's native/__init__.py, loaded by path (it imports nothing
    # of the package), builds the library into graphtap_tpu_torch/build/
    spec = importlib.util.spec_from_file_location(
        "gt_native_build", os.path.join(os.path.dirname(
            os.path.abspath(__file__)), "..", "native", "__init__.py"))
    native = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(native)
    try:
        p = native.build()
    except Exception:
        return None
    try:
        lib = ctypes.CDLL(p)
        i32p = ctypes.POINTER(ctypes.c_int32)
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.gt_route_solve.restype = ctypes.c_longlong
        lib.gt_route_solve.argtypes = [
            i64p, i64p, i64p, i64p, i64p,
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
            ctypes.c_longlong, ctypes.c_longlong,
            ctypes.c_int, ctypes.c_int,
            i32p, i32p, i32p, i32p,
            ctypes.POINTER(ctypes.c_longlong)]
    except (OSError, AttributeError):
        return None
    _NATIVE_LIB = lib
    return lib


def _route_native(src_r, src_c, dst_stripe, dst_lane, panel_of, npanels,
                  src_rows, fill_from, relax_lane, max_row, one_layer):
    """Native greedy solve; returns (m_of, row_of, lane_of, pick) or None
    (library unavailable / native-only placement failure — the caller
    falls back to the numpy solver, which raises RouteInfeasible if the
    job is genuinely infeasible)."""
    lib = _native_route_lib()
    if lib is None:
        return None
    import ctypes
    N = src_r.size

    def i64(a):
        return np.ascontiguousarray(a, dtype=np.int64)

    def p64(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))

    def p32(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))

    sr = i64(src_r)
    sc = i64(src_c)
    st = i64(dst_stripe)
    dl = i64(dst_lane) if dst_lane is not None else None
    po = i64(panel_of)
    m_of = np.empty(N, np.int32)
    row_of = np.empty(N, np.int32)
    lane_of = np.empty(N, np.int32)
    pick = np.empty(N, np.int32)
    relaxed = ctypes.c_longlong(0)
    rc = lib.gt_route_solve(
        p64(sr), p64(sc), p64(st), p64(dl) if dl is not None else None,
        p64(po), N, npanels, src_rows,
        -1 if fill_from is None else fill_from,
        -1 if max_row is None else max_row,
        int(relax_lane), int(one_layer),
        p32(m_of), p32(row_of), p32(lane_of), p32(pick),
        ctypes.byref(relaxed))
    if rc != 0:
        return None
    global RELAXED_SLOTS
    RELAXED_SLOTS += int(relaxed.value)
    return (m_of.astype(np.int64), row_of.astype(np.int64),
            lane_of.astype(np.int64), pick.astype(np.int64))


def _emit_plan_arrays(npanels, src_rows, panel_of, src_r, src_c, is_fill,
                      m_of, row_of, lane_of, pick):
    """Build the idx1/sel_a/sel_b/idx3 streams from solved positions
    (shared by the numpy and native solvers)."""
    N = src_r.size
    idx1 = np.zeros((npanels, src_rows, LANES), dtype=np.int8)
    # sel default 0xF8 = band 31: never matched by the kernel's stage-2
    # loop, so the landing stays at the ⊕-identity.
    sel_a = np.full((npanels, PROWS, LANES), 0xF8, dtype=np.uint8)
    sel_b = np.full((npanels, PROWS, LANES), 0xF8, dtype=np.uint8)
    idx3 = np.zeros((npanels, PROWS, LANES), dtype=np.uint8)
    nf_all = ~is_fill
    idx1[panel_of[nf_all], src_r[nf_all], m_of[nf_all]] = \
        src_c[nf_all].astype(np.int8)
    selv = ((src_r % STRIPE) | ((src_r // STRIPE) << 3)).astype(np.uint8)
    ia = (pick == 0) & nf_all
    sel_a[panel_of[ia], row_of[ia], m_of[ia]] = selv[ia]
    ib = (pick != 0) & nf_all
    sel_b[panel_of[ib], row_of[ib], m_of[ib]] = selv[ib]
    idx3[panel_of, row_of, lane_of] = (m_of | (pick << 7)).astype(np.uint8)
    # UNROUTED slots (callers may route fewer than npanels*PSLOTS cells)
    # must read ⊕-identity: point them at a landing-free layer-a cell
    if N < npanels * PROWS * LANES:
        routed = np.zeros((npanels, PROWS, LANES), dtype=bool)
        routed[panel_of, row_of, lane_of] = True
        a_free = sel_a == 0xF8
        m0 = np.argmax(a_free, axis=2)                    # first free m
        has_free = np.take_along_axis(
            a_free, m0[:, :, None], axis=2)[:, :, 0]
        need = (~routed).any(axis=2)
        assert np.all(has_free | ~need), "route: no fill cell in row"
        idx3 = np.where(routed, idx3,
                        m0[:, :, None].astype(np.uint8))
    return RoutePlan(idx1=idx1.reshape(-1, LANES),
                     sel_a=sel_a.reshape(-1, LANES),
                     sel_b=sel_b.reshape(-1, LANES),
                     idx3=idx3.reshape(-1, LANES), src_rows=src_rows)


def _route_panels_seq(src_r, src_c, dst_stripe, dst_lane, panel_of,
                      npanels, src_rows, fill_from=None, relax_lane=False,
                      max_row=None, one_layer=False):
    """Greedy 3-stage route assignment with row freedom (per slot).

    A slot of panel p reads source (src_r, src_c) and must land anywhere
    in stripe ``dst_stripe`` (rows [8s, 8s+8)). If ``dst_lane`` is None
    the final lane is free (expand: the landing IS the final slot and
    stage 3 is the identity); otherwise the lane is fixed (pass A: the
    fold lane) and two landing layers precede the final crossbar.
    ``relax_lane`` (fixed-lane mode only) lets the tail repair abandon a
    straggler's requested lane and place it free-lane — legal whenever
    the caller consumes the RETURNED lane array rather than assuming
    dst_lane (the x->x_ext route, whose lane choice is planner-internal).
    Returns (RoutePlan, rows, lanes) with the chosen final positions."""
    src_r = np.asarray(src_r, np.int64)
    src_c = np.asarray(src_c, np.int64)
    dst_stripe = np.asarray(dst_stripe, np.int64)
    if dst_lane is not None:
        dst_lane = np.asarray(dst_lane, np.int64)
    panel_of = np.asarray(panel_of, np.int64)
    N = src_r.size
    assert N <= npanels * PSLOTS, (N, npanels)
    free_lane = dst_lane is None
    assert max_row is None or not free_lane, "max_row is fixed-lane only"
    import time as _time
    _t0 = _time.perf_counter()
    nat = _route_native(src_r, src_c, dst_stripe, dst_lane, panel_of,
                        npanels, src_rows, fill_from, relax_lane,
                        max_row, one_layer)
    if _PLAN_PROFILE:
        import sys as _sys
        print(f"[plan] route N={src_r.size} panels={npanels} "
              f"native={'ok' if nat is not None else 'FALLBACK'} "
              f"{_time.perf_counter()-_t0:.1f}s", file=_sys.stderr,
              flush=True)
    if nat is None and os.environ.get("GRAPHTAP_ROUTE_DUMP"):
        np.savez(os.environ["GRAPHTAP_ROUTE_DUMP"] + f"_{src_r.size}.npz",
                 src_r=src_r, src_c=src_c, dst_stripe=dst_stripe,
                 dst_lane=dst_lane if dst_lane is not None else
                 np.zeros(0, np.int64),
                 has_lane=np.asarray([dst_lane is not None]),
                 panel_of=panel_of,
                 meta=np.asarray([npanels, src_rows,
                                  -1 if fill_from is None else fill_from,
                                  -1 if max_row is None else max_row,
                                  int(relax_lane), int(one_layer)]))
    if nat is not None:
        m_ofn, row_ofn, lane_ofn, pickn = nat
        is_fill_n = np.zeros(N, dtype=bool) if fill_from is None else \
            (src_r >= fill_from)
        plan = _emit_plan_arrays(npanels, src_rows, panel_of, src_r,
                                 src_c, is_fill_n, m_ofn, row_ofn,
                                 lane_ofn, pickn)
        return plan, row_ofn, lane_ofn
    nlayer = 2
    src_at = np.zeros((npanels, src_rows, LANES), dtype=np.int16)   # c+1
    land = np.zeros((nlayer, npanels, PROWS, LANES), dtype=np.int32)
    final_used = np.zeros((npanels, PROWS, LANES), dtype=bool)
    final_who = np.full((npanels, PROWS, LANES), -1, dtype=np.int64)
    m_of = np.full(N, -1, dtype=np.int64)
    row_of = np.full(N, -1, dtype=np.int64)
    lane_fin_arr = np.full(N, -1, dtype=np.int64)
    pick = np.zeros(N, dtype=np.int64)
    rc = (src_r * LANES + src_c + 1).astype(np.int32)
    c1 = (src_c + 1).astype(np.int16)
    # fill slots (phantoms): read rows known to hold only the ⊕-identity;
    # they claim no stage-1 entry (idx1 default 0 points into fill) and
    # share landings with each other (rc sentinel -1)
    is_fill = np.zeros(N, dtype=bool) if fill_from is None else \
        (src_r >= fill_from)
    rc = np.where(is_fill, -1, rc).astype(np.int32)

    # phase 1: real slots only (fills are fully flexible and go last).
    # Free-lane mode is group-centric: duplicate slots of one source
    # (panel, r, c) move TOGETHER to a shared intermediate lane m, taking
    # up to 8 cells per touched stripe per round — this is what keeps a
    # source row's 128 stage-1 entries sufficient for its ~120 distinct
    # source lanes.
    real = np.flatnonzero(~is_fill)
    if free_lane:
        gkey = (panel_of[real] * src_rows + src_r[real]) * LANES + \
            src_c[real]
        o = np.argsort(gkey, kind="stable")
        kk = gkey[o]
        newg = np.concatenate([[True], kk[1:] != kk[:-1]])
        gid_r = np.cumsum(newg) - 1
        gid = np.empty(real.size, dtype=np.int64)
        gid[o] = gid_r
        G = int(gid_r[-1]) + 1 if real.size else 0
        gsize = np.bincount(gid, minlength=G)
        gm = np.full(G, -1, dtype=np.int64)     # a group's claimed lane
        pend = real
        for k in range(4 * LANES):
            if pend.size == 0:
                break
            g = gid[np.searchsorted(real, pend)]
            fresh = (src_c[pend] * 37 + 53 * (k // 2) + g * 17) % LANES
            # even rounds reuse the group's claimed stage-1 entry
            m = np.where((k % 2 == 0) & (gm[g] >= 0), gm[g], fresh)
            pp = panel_of[pend]
            sa = src_at[pp, src_r[pend], m]
            ok_src = (sa == 0) | (sa == c1[pend])
            # landing row: any stripe row whose (row, m) landing is free
            # or already carries this (r, c)
            roff = (pend + k) % STRIPE
            rows8 = dst_stripe[pend] * STRIPE + \
                (np.arange(STRIPE)[:, None] + roff[None, :]) % STRIPE
            la = land[0, pp[None], rows8, m[None]]
            lb = land[1, pp[None], rows8, m[None]]
            ok_a = (la == 0) | (la == rc[pend][None])
            ok_b = (lb == 0) | (lb == rc[pend][None])
            okrow = ok_a | ok_b
            tsel = np.argmax(okrow, axis=0)
            ok = ok_src & okrow.any(axis=0)
            ar = np.arange(pend.size)
            lay = np.where(ok_a[tsel, ar], 0, 1)
            row_fin = rows8[tsel, ar]
            # final lane: probe a hashed lane for a free final cell
            lane_try = (m + 29 * (pend % 31) + k) % LANES
            ok &= ~final_used[pp, row_fin, lane_try]
            take = ok.copy()
            keysets = [((pp * src_rows + src_r[pend]) * LANES + m,
                        rc[pend]),
                       (((lay * npanels + pp) * PROWS + row_fin) * LANES
                        + m, rc[pend]),
                       ((pp * PROWS + row_fin) * LANES + lane_try, None)]
            for keys, share in keysets:
                o = np.lexsort((ar, np.where(take, keys, -1)))
                kk = np.where(take, keys, -1)[o]
                first = np.concatenate([[True], kk[1:] != kk[:-1]])
                if share is None:
                    agree = np.zeros(pend.size, dtype=bool)
                    agree[o] = first
                    agree |= ~take
                else:
                    runs = np.cumsum(first) - 1
                    lead = share[o][np.flatnonzero(first)][runs]
                    agree = np.zeros(pend.size, dtype=bool)
                    agree[o] = share[o] == lead
                take &= agree
            t = pend[take]
            tm = m[take]
            tl = lane_try[take]
            m_of[t] = tm
            row_of[t] = row_fin[take]
            lane_fin_arr[t] = tl
            pick[t] = lay[take]
            src_at[panel_of[t], src_r[t], tm] = c1[t]
            land[lay[take], panel_of[t], row_of[t], tm] = rc[t]
            final_used[panel_of[t], row_of[t], tl] = True
            final_who[panel_of[t], row_of[t], tl] = t
            gm[gid[np.searchsorted(real, t)]] = tm
            pend = pend[~take]

        # tail repair: place stragglers by relocating one blocker
        def _viable_m(e):
            sa_row = src_at[panel_of[e], src_r[e]]
            return np.flatnonzero((sa_row == 0) | (sa_row == c1[e]))

        def _spot(e, m):
            """(row, lane, layer) for e at intermediate lane m, or None."""
            p = panel_of[e]
            rows = dst_stripe[e] * STRIPE + np.arange(STRIPE)
            for ly in range(2):
                la = land[ly, p, rows, m]
                for t in range(STRIPE):
                    if la[t] == 0 or la[t] == rc[e]:
                        fl = np.flatnonzero(~final_used[p, rows[t]])
                        if fl.size:
                            return int(rows[t]), int(fl[0]), ly
            return None

        def _place(e, m, row, lane, ly):
            p = panel_of[e]
            m_of[e] = m
            row_of[e] = row
            lane_fin_arr[e] = lane
            pick[e] = ly
            src_at[p, src_r[e], m] = c1[e]
            land[ly, p, row, m] = rc[e]
            final_used[p, row, lane] = True
            final_who[p, row, lane] = e

        for e in pend.tolist():
            p = int(panel_of[e])
            done = False
            for m in _viable_m(e):
                sp = _spot(e, int(m))
                if sp is not None:
                    _place(e, int(m), sp[0], sp[1], sp[2])
                    done = True
                    break
            if done:
                continue
            # relocate one blocker: free a final cell in a row whose
            # landing at some viable m is free/matching
            for m in _viable_m(e):
                rows = dst_stripe[e] * STRIPE + np.arange(STRIPE)
                for row in rows:
                    l0 = land[0, p, row, m]
                    l1 = land[1, p, row, m]
                    ly_e = 0 if (l0 == 0 or l0 == rc[e]) else \
                        (1 if (l1 == 0 or l1 == rc[e]) else -1)
                    if ly_e < 0:
                        continue
                    for lane in range(LANES):
                        bslot = int(final_who[p, row, lane])
                        if bslot < 0 or is_fill[bslot]:
                            continue
                        for m2 in _viable_m(bslot):
                            sp = _spot(bslot, int(m2))
                            if sp is not None:
                                final_used[p, row, lane] = False
                                final_who[p, row, lane] = -1
                                _place(bslot, int(m2), sp[0], sp[1], sp[2])
                                _place(e, int(m), int(row), int(lane),
                                       ly_e)
                                done = True
                                break
                        if done:
                            break
                    if done:
                        break
                if done:
                    break
            if not done:
                raise RouteInfeasible("route: unplaceable slot after repair")
        pend = np.zeros(0, dtype=np.int64)
    else:
        pend = real
        for k in range(2 * LANES):
            if pend.size == 0:
                break
            m = (src_c[pend] + STRIPE * k + k) % LANES
            pp = panel_of[pend]
            sa = src_at[pp, src_r[pend], m]
            ok_src = (sa == 0) | (sa == c1[pend])
            roff = (pend + k) % STRIPE
            rows8 = dst_stripe[pend] * STRIPE + \
                (np.arange(STRIPE)[:, None] + roff[None, :]) % STRIPE
            la = land[0, pp[None], rows8, m[None]]
            lb = land[1, pp[None], rows8, m[None]]
            fin_free = ~final_used[pp[None], rows8, dst_lane[pend][None]]
            if max_row is not None:
                fin_free &= rows8 < max_row
            ok_a = ((la == 0) | (la == rc[pend][None])) & fin_free
            ok_b = ((lb == 0) | (lb == rc[pend][None])) & fin_free
            if one_layer:
                # single landing layer: the kernel then skips the whole
                # w_b band sweep (half the stage-2 crossbar work) — used
                # by routes whose load leaves the greedy placement slack
                ok_b[:] = False
            okrow = ok_a | ok_b
            tsel = np.argmax(okrow, axis=0)
            ok = ok_src & okrow.any(axis=0)
            ar = np.arange(pend.size)
            lay = np.where(ok_a[tsel, ar], 0, 1)
            lane_fin = dst_lane[pend]
            row_fin = rows8[tsel, ar]
            take = ok.copy()
            keysets = [((pp * src_rows + src_r[pend]) * LANES + m,
                        rc[pend]),
                       (((lay * npanels + pp) * PROWS + row_fin) * LANES
                        + m, rc[pend]),
                       ((pp * PROWS + row_fin) * LANES + lane_fin, None)]
            for keys, share in keysets:
                o = np.lexsort((ar, np.where(take, keys, -1)))
                kk = np.where(take, keys, -1)[o]
                first = np.concatenate([[True], kk[1:] != kk[:-1]])
                if share is None:
                    agree = np.zeros(pend.size, dtype=bool)
                    agree[o] = first
                    agree |= ~take
                else:
                    runs = np.cumsum(first) - 1
                    lead = share[o][np.flatnonzero(first)][runs]
                    agree = np.zeros(pend.size, dtype=bool)
                    agree[o] = share[o] == lead
                take &= agree
            t = pend[take]
            tm = m[take]
            m_of[t] = tm
            row_of[t] = row_fin[take]
            lane_fin_arr[t] = dst_lane[t]
            pick[t] = lay[take]
            src_at[panel_of[t], src_r[t], tm] = c1[t]
            land[lay[take], panel_of[t], row_of[t], tm] = rc[t]
            final_used[panel_of[t], row_of[t], dst_lane[t]] = True
            final_who[panel_of[t], row_of[t], dst_lane[t]] = t
            pend = pend[~take]

        # tail repair (fixed-lane): place stragglers, relocating one
        # same-lane blocker to another row of the stripe if needed
        def _viable_mf(e):
            sa_row = src_at[panel_of[e], src_r[e]]
            return np.flatnonzero((sa_row == 0) | (sa_row == c1[e]))

        def _spot_f(e, m):
            p = panel_of[e]
            rows = dst_stripe[e] * STRIPE + np.arange(STRIPE)
            for ly in range(1 if one_layer else 2):
                la = land[ly, p, rows, m]
                for tr in range(STRIPE):
                    if max_row is not None and rows[tr] >= max_row:
                        continue
                    if (la[tr] == 0 or la[tr] == rc[e]) and \
                            not final_used[p, rows[tr], dst_lane[e]]:
                        return int(rows[tr]), ly
            return None

        def _place_f(e, m, row, ly, lane=None):
            p = panel_of[e]
            lane = int(dst_lane[e]) if lane is None else lane
            m_of[e] = m
            row_of[e] = row
            lane_fin_arr[e] = lane
            pick[e] = ly
            src_at[p, src_r[e], m] = c1[e]
            land[ly, p, row, m] = rc[e]
            final_used[p, row, lane] = True
            final_who[p, row, lane] = e

        for e in pend.tolist():
            p = int(panel_of[e])
            done = False
            for m in _viable_mf(e):
                sp = _spot_f(e, int(m))
                if sp is not None:
                    _place_f(e, int(m), sp[0], sp[1])
                    done = True
                    break
            if done:
                continue
            for m in _viable_mf(e):
                rows = dst_stripe[e] * STRIPE + np.arange(STRIPE)
                for row in rows:
                    if max_row is not None and row >= max_row:
                        continue
                    l0 = land[0, p, row, m]
                    l1 = land[1, p, row, m]
                    ly_e = 0 if (l0 == 0 or l0 == rc[e]) else \
                        (1 if (not one_layer and (l1 == 0 or l1 == rc[e]))
                         else -1)
                    if ly_e < 0:
                        continue
                    bslot = int(final_who[p, row, dst_lane[e]])
                    if bslot < 0 or is_fill[bslot]:
                        continue
                    for m2 in _viable_mf(bslot):
                        sp = _spot_f(bslot, int(m2))
                        if sp is not None:
                            final_used[p, row, dst_lane[e]] = False
                            final_who[p, row, dst_lane[e]] = -1
                            _place_f(bslot, int(m2), sp[0], sp[1])
                            _place_f(e, int(m), int(row), ly_e)
                            done = True
                            break
                    if done:
                        break
                if done:
                    break
            if not done and relax_lane:
                # last tier: abandon the requested lane — land at ANY free
                # final cell of a stripe row with a compatible landing.
                # The caller uses the returned lane array, so this is
                # lossless; it turns the solver total for x->x_ext.
                # RELAXED_SLOTS counts only slots a relax tier actually
                # PLACED (not tier entries that fell through to the
                # ultimate tier or raised RouteInfeasible).
                global RELAXED_SLOTS
                for m in _viable_mf(e):
                    rows = dst_stripe[e] * STRIPE + np.arange(STRIPE)
                    for ly in range(1 if one_layer else 2):
                        for row in rows:
                            if max_row is not None and row >= max_row:
                                continue
                            la = land[ly, p, row, m]
                            if la != 0 and la != rc[e]:
                                continue
                            fl = np.flatnonzero(~final_used[p, row])
                            if fl.size:
                                _place_f(e, int(m), int(row), ly,
                                         lane=int(fl[0]))
                                RELAXED_SLOTS += 1
                                done = True
                                break
                        if done:
                            break
                    if done:
                        break
            if not done and relax_lane:
                # ultimate tier: for relax_lane callers the requested
                # STRIPE is planner-internal too (x->x_ext: only xe_pos
                # consumes the final position), so place at ANY row of
                # the panel with a compatible landing and a free lane —
                # this keeps the quota ladder on its first rung (a rung
                # drop costs ~17% more panels across every stage)
                nrows_all = max_row if max_row is not None else PROWS
                for m in _viable_mf(e):
                    for ly in range(1 if one_layer else 2):
                        for row in range(nrows_all):
                            la = land[ly, p, row, m]
                            if la != 0 and la != rc[e]:
                                continue
                            fl = np.flatnonzero(~final_used[p, row])
                            if fl.size:
                                _place_f(e, int(m), int(row), ly,
                                         lane=int(fl[0]))
                                RELAXED_SLOTS += 1
                                done = True
                                break
                        if done:
                            break
                    if done:
                        break
            if not done:
                raise RouteInfeasible("route: unplaceable slot after repair")
        pend = np.zeros(0, dtype=np.int64)
    if pend.size:
        raise RouteInfeasible(f"route: {pend.size} unplaceable real slots")

    # phase 2: fills take the leftover cells (any source; landings share
    # the rc=-1 sentinel)
    fills = np.flatnonzero(is_fill)
    if fills.size:
        if free_lane:
            # leftover final cells per (panel, stripe), in order; the
            # intermediate lane must have a free or fill-shared landing
            fp = panel_of[fills]
            fkey = fp * NDIG + dst_stripe[fills]
            fo = np.argsort(fkey, kind="stable")
            cells = ~final_used.reshape(npanels, NDIG, STRIPE * LANES)
            cp, cs, cc = np.nonzero(cells)
            ckey = cp * NDIG + cs
            co = np.argsort(ckey, kind="stable")
            assert fo.size <= co.size
            fsl = fills[fo]
            crow = (cc[co] // LANES)[:fsl.size]
            clane = (cc[co] % LANES)[:fsl.size]
            rowg = dst_stripe[fsl] * STRIPE + crow
            lane_fin_arr[fsl] = clane
            row_of[fsl] = rowg
            pick[fsl] = 0
            # probe an m whose landing at (row) is free or fill-shared
            pendf = np.arange(fsl.size)
            for k in range(LANES):
                if pendf.size == 0:
                    break
                mm = (clane[pendf] + k * 11) % LANES
                la = land[0, panel_of[fsl[pendf]], rowg[pendf], mm]
                ok = (la == 0) | (la == -1)
                t = pendf[ok]
                m_of[fsl[t]] = mm[ok]
                land[0, panel_of[fsl[t]], rowg[t], mm[ok]] = -1
                pendf = pendf[~ok]
            if pendf.size:
                raise RouteInfeasible("route: fill landing conflict")
            final_used[panel_of[fsl], rowg, clane] = True
        else:
            pend = fills
            for k in range(4 * LANES):
                if pend.size == 0:
                    break
                m = (dst_lane[pend] + k * 9) % LANES
                pp = panel_of[pend]
                roff = (pend + k) % STRIPE
                rows8 = dst_stripe[pend] * STRIPE + \
                    (np.arange(STRIPE)[:, None] + roff[None, :]) % STRIPE
                la = land[0, pp[None], rows8, m[None]]
                lb = land[1, pp[None], rows8, m[None]]
                fin = ~final_used[pp[None], rows8, dst_lane[pend][None]]
                ok_a = ((la == 0) | (la == -1)) & fin
                ok_b = ((lb == 0) | (lb == -1)) & fin
                okrow = ok_a | ok_b
                tsel = np.argmax(okrow, axis=0)
                ok = okrow.any(axis=0)
                ar = np.arange(pend.size)
                lay = np.where(ok_a[tsel, ar], 0, 1)
                row_fin = rows8[tsel, ar]
                take = ok.copy()
                keys = (pp * PROWS + row_fin) * LANES + dst_lane[pend]
                o = np.lexsort((ar, np.where(take, keys, -1)))
                kk = np.where(take, keys, -1)[o]
                first = np.concatenate([[True], kk[1:] != kk[:-1]])
                agree = np.zeros(pend.size, dtype=bool)
                agree[o] = first
                take &= agree
                t = pend[take]
                m_of[t] = m[take]
                row_of[t] = row_fin[take]
                lane_fin_arr[t] = dst_lane[t]
                pick[t] = lay[take]
                land[lay[take], panel_of[t], row_of[t], m[take]] = -1
                final_used[panel_of[t], row_of[t], dst_lane[t]] = True
                pend = pend[~take]
            if pend.size:
                raise RouteInfeasible(
                    f"route: {pend.size} unplaceable fill slots")

    lane_of = lane_fin_arr      # actual lanes in BOTH modes (repair may
    # have relaxed a fixed-lane slot; callers that need the lane read it
    # from here, never from their dst_lane input)
    plan = _emit_plan_arrays(npanels, src_rows, panel_of, src_r, src_c,
                             is_fill, m_of, row_of, lane_of, pick)
    return plan, row_of, lane_of


def simulate_route(plan: RoutePlan, v: np.ndarray, npanels: int,
                   fill=0.0, out_rows: int = PROWS) -> np.ndarray:
    """Numpy oracle of the 3-stage route kernel (sel band >= the source
    band count = unmatched landing = ⊕-identity, like the kernel)."""
    sr = plan.src_rows
    v = v.reshape(npanels, sr, LANES)
    idx1 = plan.idx1.reshape(npanels, sr, LANES).astype(np.int64)
    u = np.take_along_axis(v, idx1, axis=2)

    def wlayer(sel):
        sel = sel.reshape(npanels, out_rows, LANES).astype(np.int64)
        band = (sel >> 3) & 31
        srcrow = (sel & 7) + band * STRIPE
        w = np.take_along_axis(u, np.minimum(srcrow, sr - 1), axis=1)
        return np.where(band >= sr // STRIPE,
                        np.asarray(fill, v.dtype), w)

    w_a = wlayer(plan.sel_a)
    w_b = wlayer(plan.sel_b)
    i3 = plan.idx3.reshape(npanels, out_rows, LANES).astype(np.int64)
    m = i3 & 127
    out = np.where(i3 >= 128,
                   np.take_along_axis(w_b, m, axis=2),
                   np.take_along_axis(w_a, m, axis=2))
    return out.reshape(npanels * out_rows, LANES)


SPILL_CAP = 22     # subop budget per windowed-gather step before spilling


def _gather_with_spill(src_rows: int, src_of: np.ndarray,
                       dst_chunk: np.ndarray, cap: int = SPILL_CAP,
                       block_rows: int = STRIPE):
    """build_gather_plan for a chunked-fold stage, relocating slots of
    over-budget steps into fresh chunks with the SAME fold destination
    (the ⊕-fold accumulates duplicate chunks, so spilling is free).
    Returns (GatherPlan, extended dst_chunk). ``block_rows=64`` targets
    windowed_gather64 (all-fill pad chunks align the output to blocks;
    they fold the ⊕-identity into row 0, a no-op)."""
    from graphtap_tpu_torch.kernels.gather_plan import build_gather_plan
    src_of = np.asarray(src_of, np.int64).copy()
    dst_chunk = np.asarray(dst_chunk, np.int32)
    cpb = block_rows // STRIPE
    for _ in range(16):
        if dst_chunk.size % cpb:
            pad = cpb - dst_chunk.size % cpb
            src_of = np.concatenate(
                [src_of, np.full(pad * STRIPE * LANES, -1, np.int64)])
            dst_chunk = np.concatenate(
                [dst_chunk, np.zeros(pad, np.int32)])
        res = build_gather_plan(src_rows, dst_chunk.size * STRIPE, src_of,
                                spill=cap, block_rows=block_rows)
        if not (isinstance(res, tuple) and res[0] == "spill"):
            return res, dst_chunk
        bad_pos = res[1]
        vals = src_of[bad_pos]
        chunks_of = (bad_pos // (STRIPE * LANES)).astype(np.int64)
        lane = bad_pos % LANES        # lanes are destination-pure: KEEP
        src_of[bad_pos] = -1
        # spill chunks per over-budget source chunk (keeps the spilled
        # windows together and the destination row identical); a slot
        # stays in its lane, stacking 8 per (spill chunk, lane)
        o = np.lexsort((lane, chunks_of))
        cs, ln = chunks_of[o], lane[o]
        gl_chg = np.ones(cs.size, dtype=bool)
        gl_chg[1:] = (cs[1:] != cs[:-1]) | (ln[1:] != ln[:-1])
        r_g = np.arange(cs.size) - np.repeat(
            np.flatnonzero(gl_chg),
            np.diff(np.concatenate([np.flatnonzero(gl_chg), [cs.size]])))
        sub = r_g // STRIPE
        row = r_g % STRIPE
        key = cs * np.int64(STRIPE * LANES) + sub   # (orig chunk, layer)
        kchg = np.ones(cs.size, dtype=bool)
        kchg[1:] = key[1:] != key[:-1]
        # new-chunk id per (orig chunk, layer), in sorted key order
        ko = np.argsort(key, kind="stable")
        ksorted = key[ko]
        kfirst = np.ones(cs.size, dtype=bool)
        kfirst[1:] = ksorted[1:] != ksorted[:-1]
        kid_sorted = np.cumsum(kfirst) - 1
        new_id = np.empty(cs.size, dtype=np.int64)
        new_id[ko] = kid_sorted
        nnew = int(kid_sorted[-1]) + 1 if cs.size else 0
        ext = np.zeros(nnew * STRIPE * LANES, dtype=np.int64) - 1
        ext[new_id * STRIPE * LANES + row * LANES + ln] = vals[o]
        src_of = np.concatenate([src_of, ext])
        new_dst = np.zeros(nnew, dtype=np.int32)
        new_dst[new_id] = dst_chunk[cs]
        dst_chunk = np.concatenate([dst_chunk, new_dst])
    raise ValueError("gather spill did not converge")


@dataclass
class Spmv3Plan:
    """Complete static plan for one device's v3 panel SpMV."""
    NC: int
    NR: int
    nblocks: int           # compact y rows (mult of 8)
    n_edges: int
    xext_rows: int         # x_ext stream rows (panels * XROWS)
    exp_panels: int
    pa_panels: int
    pa_nwin: int           # stripe windows per pass-A panel (8 + slack)
    exp_route: RoutePlan
    pa_route: RoutePlan
    pa_bases: np.ndarray   # (pa_panels * pa_nwin,) int32 stripe-block index
    w_stream: Optional[np.ndarray]  # (exp_panels*PROWS, 128) or None
    fix_dst: np.ndarray    # (fix_chunks,) int32 y_mid row per chunk
    fix2_dst: np.ndarray   # (fix2_chunks,) int32 DENSE y row per chunk
                           # (absolute; the engine re-bases per segment)
    hub_mask: np.ndarray   # (y_mid rows,) uint8 — 0: plain row; W in
                           # {32,64,128}: lane-⊕-fold the row at width W
                           # before the level-2 gather (packed hub runs)
    # fix route (s1 -> chunk-stack panels, pass-A kernel)
    fixr_route: RoutePlan
    fixr_bases: np.ndarray  # (fix_panels * fixr_nwin,) int32 s1 blocks
    fixr_nwin: int
    fix_panels: int
    fixr_seg: np.ndarray    # (fix_panels,) int32 fold segment per panel
                            # (non-decreasing; FOLD_SEG_ROWS rows each)
    # x -> x_ext route (pass-A kernel, out_rows=XROWS)
    xr_route: RoutePlan
    xr_bases: np.ndarray   # (exp_panels * NWIN_X,) int32 x-table blocks
    sx_rows: int           # padded x table rows (x2d source)
    # fix2 route_fold (y_mid cells -> DENSE y rows, segment-resident)
    f2_route: RoutePlan
    f2_bases: np.ndarray   # (f2_panels * f2_nwin,) int32 y_mid blocks
    f2_nwin: int
    f2_panels: int
    f2_seg: np.ndarray     # (f2_panels,) int32 fold segment per panel
    dense_rows: int

    @property
    def pad_factor(self) -> float:
        return self.exp_panels * PSLOTS / max(1, self.n_edges)


def build_spmv3_plan(rows: np.ndarray, cols: np.ndarray,
                     weights: Optional[np.ndarray],
                     NR: int, NC: int, dense_len: int,
                     iv_dense: Optional[np.ndarray],
                     value_dtype=np.float32,
                     pa_slack: int = 2) -> Spmv3Plan:
    """Build the v3 plan from (compact-row, local-col) edges.

    Total by construction: the x->x_ext route relaxes lanes for
    stragglers, and if a semantically-fixed-lane route (pass A / fixup /
    fix2) still reports RouteInfeasible, the whole plan is rebuilt with
    progressively lower stripe quotas (more slack for the greedy
    two-choice placement).  The last rung re-raises — no silent wrong
    plans."""
    last = None
    for quota, dcap in ((QUOTA, DCAP), (832, 80), (704, 56)):
        try:
            return _build_spmv3_plan_once(
                rows, cols, weights, NR, NC, dense_len, iv_dense,
                value_dtype=value_dtype, pa_slack=pa_slack,
                quota=quota, dcap=dcap)
        except RouteInfeasible as e:     # pragma: no cover - rare ladder
            import sys as _sys
            print(f"[plan] quota rung {quota} infeasible ({e}); "
                  f"dropping a rung", file=_sys.stderr, flush=True)
            last = e
    raise last


def _build_spmv3_plan_once(rows: np.ndarray, cols: np.ndarray,
                           weights: Optional[np.ndarray],
                           NR: int, NC: int, dense_len: int,
                           iv_dense: Optional[np.ndarray],
                           value_dtype=np.float32,
                           pa_slack: int = 2,
                           quota: int = QUOTA,
                           dcap: int = DCAP) -> Spmv3Plan:
    from graphtap_tpu_torch.kernels.gather_plan import build_gather_plan
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    E = int(rows.size)
    nblocks = -(-max(1, -(-NR // LANES)) // STRIPE) * STRIPE

    import time as _time
    import sys as _sys
    _tp = [_time.perf_counter()]

    def _mark(nm):
        if _PLAN_PROFILE:
            t = _time.perf_counter()
            print(f"[plan] {nm}: {t - _tp[0]:.1f}s", file=_sys.stderr,
                  flush=True)
            _tp[0] = t

    blk = rows // LANES
    # adaptive supers: contiguous block ranges holding >= SUPER_EDGES
    # edges each (a fixed 64-block super makes tail supers column-sparse
    # and shreds the x_ext packing); codes = 64 size-balanced block
    # GROUPS per super — the fold's lane purity is per (block, lr), so a
    # code may span many blocks
    nblk_tot = int(blk.max()) + 1 if E else 1
    blk_sizes = np.bincount(blk, minlength=nblk_tot)
    csum = np.cumsum(blk_sizes)
    cuts = [0]
    tgt = SUPER_EDGES
    while tgt < (csum[-1] if E else 0):
        cuts.append(int(np.searchsorted(csum, tgt)) + 1)
        tgt += SUPER_EDGES
    cut_arr = np.unique(np.asarray(cuts + [nblk_tot], dtype=np.int64))
    sup_of_blk = np.searchsorted(cut_arr, np.arange(nblk_tot),
                                 side="right") - 1
    sup = sup_of_blk[blk]
    nsup = int(sup.max()) + 1 if E else 1

    # split-LPT: blocks of a super dealt into 64 code bins by size; a
    # block bigger than ~1/64 of the super splits across several bins
    # (the fold's lane purity is per (block, lr), so bins mix freely)
    binstab = np.zeros((nblk_tot, NSUP_BLOCKS), dtype=np.int64)
    for s_ in range(nsup):
        bb = np.flatnonzero(sup_of_blk == s_)
        if bb.size == 0:
            continue
        tot = int(blk_sizes[bb].sum())
        target = max(1, tot // NSUP_BLOCKS)
        o_ = bb[np.argsort(-blk_sizes[bb], kind="stable")]
        loads = np.zeros(NSUP_BLOCKS, dtype=np.int64)
        for b_ in o_.tolist():
            sz = int(blk_sizes[b_])
            nsplit = int(min(NSUP_BLOCKS, max(1, -(-sz // target))))
            bins_b = np.argsort(loads, kind="stable")[:nsplit]
            loads[bins_b] += sz // nsplit
            binstab[b_] = bins_b[np.arange(NSUP_BLOCKS) % nsplit]

    order = np.lexsort((cols, sup)) if E else np.zeros(0, np.int64)
    order = np.lexsort((cols, sup)) if E else np.zeros(0, np.int64)
    e_sup = sup[order]
    e_col = cols[order]
    e_row = rows[order]
    idx = binstab[blk[order], cols[order] % NSUP_BLOCKS]
    e_d0 = idx % NDIG
    e_d1 = (idx // NDIG + idx) % NDIG
    e_code = e_d0 | (e_d1 << 3)
    e_w = np.asarray(weights)[order] if weights is not None else None

    # ---- edge-panel packing: per super, col order; close a panel when a
    # d0 quota (1024) or the distinct-column cap would overflow
    panel_of = np.zeros(E, dtype=np.int64)
    x_lists: List[np.ndarray] = []       # distinct cols per panel
    slot_gid = np.zeros(E, dtype=np.int64)  # global x_ext slot per edge
    slot_base = 0
    i = 0
    p = 0
    while i < E:
        hi = min(E, i + PSLOTS)
        hi = min(hi, int(np.searchsorted(e_sup, e_sup[i], "right")))
        seg_c = e_col[i:hi]
        seg_d = e_d0[i:hi]
        cchg = np.concatenate([[True], seg_c[1:] != seg_c[:-1]])
        cstart = np.flatnonzero(cchg)
        clen2 = np.diff(np.concatenate([cstart, [seg_c.size]]))
        r_in_col = np.arange(seg_c.size) - np.repeat(cstart, clen2)
        slot_start = cchg | (r_in_col % DUP_CAP == 0)
        ndist = np.cumsum(slot_start)
        # stage-1 entry demand per slot: one entry plus hunting slack for
        # heavy duplicate groups; rows are paced by demand so hot rows
        # keep free entries (DCAP << 128)
        dcount = np.minimum(clen2, DUP_CAP)
        demand_slot = 1 + (np.repeat(dcount, clen2) // 16)
        cdem = np.cumsum(np.where(slot_start, demand_slot, 0))
        m = hi - i
        if cdem[-1] > (XROWS - 1) * dcap:
            m = min(m, int(np.searchsorted(cdem, (XROWS - 1) * dcap + 1)))
        if ndist[min(m, ndist.size) - 1] > XCAP:
            m = min(m, int(np.searchsorted(ndist, XCAP + 1)))
        # bound the x->x_ext route's window operand count PER PANEL
        # (sparse tails close panels early)
        xb = seg_c // (STRIPE * LANES)
        bchg = np.concatenate([[True], xb[1:] != xb[:-1]])
        nblk = np.cumsum(bchg)
        viol = np.flatnonzero(nblk[:m] > NWIN_X)
        if viol.size:
            m = min(m, max(1, int(viol[0])))
        # d0 quota: first index where any digit count exceeds 1024
        for d in range(NDIG):
            cnt = np.cumsum(seg_d[:m] == d)
            if cnt[-1] > quota:
                m = min(m, int(np.searchsorted(cnt, quota + 1)))
        panel_of[i:i + m] = p
        u = seg_c[:m][slot_start[:m]]
        # dst stripes: column-sorted slots paced into stripes by stage-1
        # entry demand (no starved rows); the route solver picks the
        # exact (row-in-stripe, lane is fixed) landing
        sid = np.cumsum(slot_start[:m]) - 1
        sdem = np.where(slot_start[:m], demand_slot[:m], 0)
        slot_dem = sdem[slot_start[:m]]
        dem_excl = np.cumsum(slot_dem) - slot_dem
        rows_ = dem_excl // dcap
        # lanes round-robin over the STRIPE's slot sequence: same-lane
        # load per stripe is then <= ceil(8*DCAP/SLOT_W) = 7 < 8 rows, so
        # the fixed-lane route solver always has a spare row (the old
        # per-row 53-stagger allowed 8-deep same-lane runs that made
        # slots unplaceable at RMAT-20)
        s_in = _concat_ranges(np.bincount(rows_ // STRIPE))
        lanes_ = s_in % SLOT_W
        assert rows_.max(initial=0) < XROWS - 1
        x_lists.append((u, rows_, lanes_))
        slot_gid[i:i + m] = slot_base + sid
        slot_base += u.size
        p += 1
        i += m
    exp_panels = max(1, p)
    _mark("packing")

    # ---- x -> x_ext ROUTE: each panel's <= NWIN_X source x windows are
    # corner-turn operands (prefetched bases into the x table); the
    # 3-stage route lands every distinct (col, dup-chunk) slot at its
    # fixed lane in its demand-paced stripe.  Replaces the windowed
    # gather, whose (nsteps x nsub) grid overhead dominated the superstep
    # (36 ms/iter at RMAT-20 vs ~1 grid step per panel here).
    sxrows = -(-(-(-NC // LANES)) // STRIPE) * STRIPE
    xext_rows = exp_panels * XROWS
    xr_bases = np.zeros((exp_panels, NWIN_X), dtype=np.int32)
    _srs, _scs, _dst, _dln, _pof = [], [], [], [], []
    for q, (u, rows_, lanes_) in enumerate(x_lists):
        xb_ = u // (STRIPE * LANES)
        wins = np.unique(xb_)
        assert wins.size <= NWIN_X, (q, wins.size)
        if wins.size:
            xr_bases[q, :wins.size] = wins
            xr_bases[q, wins.size:] = wins[-1]
        band = np.searchsorted(wins, xb_)
        _srs.append((band * STRIPE + (u // LANES) % STRIPE).astype(
            np.int16))
        _scs.append((u % LANES).astype(np.int8))
        _dst.append((rows_ // STRIPE).astype(np.int8))
        _dln.append(lanes_.astype(np.int8))
        _pof.append(np.full(u.size, q, np.int32))
    if slot_base:
        # relax_lane: the requested lanes are only a load-spreading
        # heuristic here (SLOT_W round-robin); the solver may overrule
        # them for stragglers and we consume ITS lane choices below —
        # this is what makes the planner total at hub-heavy scales
        # (RMAT-20 ROW ordering broke the strictly-fixed-lane solver)
        # max_row: the solver's row freedom must NOT land real slots in
        # x_ext row XROWS-1 — the expand route classifies that row as
        # the fill row (phantoms read it and real slots there would be
        # dropped); the demand pacing only bounds the REQUESTED rows,
        # not the stripe-freedom placements (the round-3 mass-loss bug
        # at scales >= 17)
        xr_route64, xr_rows_all, xr_lanes_all = _route_panels(
            np.concatenate(_srs), np.concatenate(_scs),
            np.concatenate(_dst), np.concatenate(_dln),
            np.concatenate(_pof), exp_panels, NWIN_X * STRIPE,
            relax_lane=True, max_row=XROWS - 1, one_layer=True)
    else:
        xr_route64, _r, _l = _route_panels(
            np.zeros(0, np.int64), np.zeros(0, np.int64),
            np.zeros(0, np.int64), np.zeros(0, np.int64),
            np.zeros(0, np.int64), exp_panels, NWIN_X * STRIPE)
        xr_rows_all = np.zeros(0, np.int64)
        xr_lanes_all = np.zeros(0, np.int64)
    xr_route = RoutePlan(
        idx1=xr_route64.idx1,
        sel_a=xr_route64.sel_a.reshape(
            exp_panels, PROWS, LANES)[:, :XROWS].reshape(-1, LANES),
        sel_b=xr_route64.sel_b.reshape(
            exp_panels, PROWS, LANES)[:, :XROWS].reshape(-1, LANES),
        idx3=xr_route64.idx3.reshape(
            exp_panels, PROWS, LANES)[:, :XROWS].reshape(-1, LANES),
        src_rows=NWIN_X * STRIPE)
    _mark("xr route")
    # actual x_ext position of each edge (solver-chosen row AND lane)
    xe_pos = (panel_of * XROWS * LANES + xr_rows_all[slot_gid] * LANES
              + xr_lanes_all[slot_gid])
    _dbgx = _xext = _s0 = _s1 = None
    if _PLAN_DEBUG and E:
        _dbgx = np.random.default_rng(99).random(max(NC, 1)).astype(
            np.float32)
        _x2d = np.zeros((sxrows, LANES), np.float32)
        _x2d.reshape(-1)[:NC] = _dbgx
        _vx = _x2d.reshape(-1, STRIPE, LANES)[
            xr_bases.reshape(exp_panels, NWIN_X)]
        _vx = _vx.reshape(exp_panels * NWIN_X * STRIPE, LANES)
        _xext = simulate_route(xr_route, _vx, exp_panels, 0.0,
                               out_rows=XROWS)
        _bad = int((_xext.reshape(-1)[xe_pos] != _dbgx[e_col]).sum())
        assert _bad == 0, f"PLAN_DEBUG xr: {_bad}/{E} edges read wrong x"

    # ---- expand route: x_ext panel -> d0-striped (64,128) panel.
    # Element dst: stripe d0, row/lane chosen by the router. Phantom
    # slots (quota deficits) read spread pad sources.
    cnt_pd = np.bincount(panel_of * NDIG + e_d0,
                         minlength=exp_panels * NDIG)
    ph_n = (STRIPE * LANES - cnt_pd)
    ph_p = np.repeat(np.arange(exp_panels * NDIG) // NDIG, ph_n)
    ph_stripe = np.repeat(np.arange(exp_panels * NDIG) % NDIG, ph_n)
    k_in_p = _concat_ranges(ph_n)
    ph_row = np.full(k_in_p.size, XROWS - 1, dtype=np.int64)  # fill row
    ph_lane = k_in_p % LANES
    all_sr = np.concatenate([(xe_pos // LANES) % XROWS,
                             ph_row]).astype(np.int8)
    all_sc = np.concatenate([xe_pos % LANES, ph_lane]).astype(np.int8)
    all_st = np.concatenate([e_d0, ph_stripe]).astype(np.int8)
    all_p = np.concatenate([panel_of, ph_p]).astype(np.int32)
    exp_route, exp_rows_all, exp_lanes_all = _route_panels(
        all_sr, all_sc, all_st, None, all_p, exp_panels, XROWS,
        fill_from=XROWS - 1)
    e_erow = exp_rows_all[:E].copy()
    e_elane = exp_lanes_all[:E].copy()
    # free the per-slot maps and phantom scaffolding (peak-RSS control:
    # the planner must stay within ~0.4 KB/edge for RMAT-22+ host RAM)
    del all_sr, all_sc, all_st, all_p, ph_row, ph_lane, ph_stripe, ph_p
    del exp_rows_all, exp_lanes_all, xe_pos, xr_rows_all, xr_lanes_all
    del k_in_p, slot_gid
    _mark("expand route")
    pos_in_stripe = (e_erow % STRIPE) * LANES + e_elane
    if _PLAN_DEBUG and E:
        _s0 = simulate_route(exp_route, _xext, exp_panels, 0.0)
        _got = _s0.reshape(exp_panels, PROWS, LANES)[panel_of, e_erow,
                                                     e_elane]
        _bad = int((_got != _dbgx[e_col]).sum())
        assert _bad == 0, f"PLAN_DEBUG expand: {_bad}/{E} edges wrong"

    w_stream = None
    if e_w is not None:
        w_stream = np.zeros((exp_panels * PROWS, LANES), dtype=value_dtype)
        w_stream.reshape(exp_panels, PROWS, LANES)[
            panel_of, e_erow, e_elane] = e_w


    # ---- pass A: regions (super, d0). Out panel j of a region reads
    # NWIN stripe windows [8j-BACK, 8j+FWD) (+1 reserved fill window) and
    # takes up to 1024 elements per d1 in stripe order; the backlog of a
    # region behaves as a reflected random walk bounded by BACK stripes
    # (planner asserts).
    BACK, FWD = 3, 8
    NWIN = BACK + FWD + 1                  # last window = the fill block
    # stripe ordinal of each edge within its region = panel ordinal
    # within the super (each expand panel contributes one d0-stripe)
    sup_pan0 = np.zeros(nsup + 1, dtype=np.int64)
    if E:
        last_pan = np.zeros(nsup, dtype=np.int64)
        np.maximum.at(last_pan, e_sup, panel_of + 1)
        np.maximum.accumulate(last_pan, out=last_pan)
        sup_pan0[1:] = last_pan
    strip_ord = panel_of - sup_pan0[e_sup]

    e_pan = np.full(E, -1, dtype=np.int64)
    pan_meta: List[Tuple[int, int, int]] = []   # (super, d0, j0) per panel
    pan_bases: List[np.ndarray] = []
    pan_lo_all: List[int] = []
    reg_key = e_sup * NDIG + e_d0
    ro = np.lexsort((pos_in_stripe, strip_ord, e_d1, reg_key))
    # per-(region,d1) contiguous runs in ro
    rk = reg_key[ro]
    d1o = e_d1[ro]
    so = strip_ord[ro]
    run_key = rk * NDIG + d1o
    if E:
        rchg = np.concatenate([[True], run_key[1:] != run_key[:-1]])
        rst = np.flatnonzero(rchg)
        rln = np.diff(np.concatenate([rst, [E]]))
    else:
        rst = np.zeros(0, np.int64)
        rln = rst
    run_of = {}
    for a, b_ in zip(rst, rst + rln):
        run_of[int(run_key[a])] = (int(a), int(b_))
    regions = np.unique(rk) if E else np.zeros(0, np.int64)
    fill_block = exp_panels * NDIG        # one appended all-fill stripe blk
    pa_panels = 0
    for reg in regions:
        s_id, d0 = int(reg) // NDIG, int(reg) % NDIG
        nstripes = int(sup_pan0[s_id + 1] - sup_pan0[s_id])
        ptr = {}
        for d1 in range(NDIG):
            ptr[d1] = run_of.get(int(reg) * NDIG + d1, (0, 0))[0]
        done = False
        j = 0
        while not done:
            done = True
            # anchor the stripe window at the laggard pointer so the
            # backlog can never escape it
            lo = nstripes
            for d1 in range(NDIG):
                a_, b_ = run_of.get(int(reg) * NDIG + d1, (0, 0))
                p0 = max(ptr[d1], a_)
                if p0 < b_:
                    lo = min(lo, int(so[p0]))
            if lo >= nstripes:
                break
            for d1 in range(NDIG):
                a_, b_ = run_of.get(int(reg) * NDIG + d1, (0, 0))
                p0 = max(ptr[d1], a_)
                if p0 < b_:
                    hi = p0 + int(np.searchsorted(
                        so[p0:b_], lo + NWIN - 1, "left"))
                    hi = min(hi, p0 + quota)
                    if hi > p0:
                        idx = ro[p0:hi]
                        e_pan[idx] = pa_panels
                        ptr[d1] = hi
                    if hi < b_:
                        done = False
            base0 = sup_pan0[s_id] * NDIG + d0  # first stripe blk of region
            w = np.arange(lo, lo + NWIN - 1)
            wb = np.where(w < nstripes, base0 + w * NDIG, fill_block)
            pan_bases.append(np.concatenate([wb, [fill_block]]))
            pan_meta.append((s_id, d0, j))
            pan_lo_all.append(lo)
            pa_panels += 1
            j += 1
    assert (e_pan >= 0).all() if E else True
    if pa_panels == 0:
        pan_bases.append(np.full(NWIN, fill_block, np.int64))
        pan_meta.append((0, 0, 0))
        pan_lo_all.append(0)
        pa_panels = 1
    pa_bases = (np.stack(pan_bases).astype(np.int32).reshape(-1)
                if pan_bases else np.zeros(NWIN, np.int32))

    # window index of each element within its pass-A panel
    pan_lo_a = np.array(pan_lo_all, dtype=np.int64) if pan_lo_all \
        else np.zeros(1, np.int64)
    e_win = strip_ord - pan_lo_a[e_pan]
    assert E == 0 or ((e_win >= 0).all() and (e_win < NWIN - 1).all())
    pa_src_row = e_win * STRIPE + e_erow % STRIPE
    pa_src_lane = e_elane

    # lane packing per (out panel, d1): (block,lr)-sorted vertical
    # stacking — the fixup regroups by destination, so stripes fill
    # completely regardless of in-degree
    lr_e = e_row % LANES
    blr_e = e_row           # (block, lr) identity = the compact row
    k5 = e_pan * NDIG + e_d1
    o5 = np.lexsort((pos_in_stripe, strip_ord, blr_e, k5))
    k5s = k5[o5]
    pd_chg = np.concatenate([[True], k5s[1:] != k5s[:-1]])
    st5 = np.flatnonzero(pd_chg)
    rnk = np.arange(E) - np.repeat(
        st5, np.diff(np.concatenate([st5, [E]])))
    pa_lane = np.empty(E, dtype=np.int64)
    pa_lane[o5] = rnk // STRIPE
    if E and int(pa_lane.max()) >= LANES:
        raise ValueError("pass-A lane overflow")

    # phantoms: fill each (panel, d1) stripe's remaining lane capacity
    cnt_lane = np.bincount((e_pan * NDIG + e_d1) * LANES + pa_lane,
                           minlength=pa_panels * NDIG * LANES) \
        if E else np.zeros(pa_panels * NDIG * LANES, np.int64)
    rem = (STRIPE - cnt_lane.reshape(-1, LANES))
    assert rem.min() >= 0
    phl = np.tile(np.arange(LANES), pa_panels * NDIG)
    ph_lane2 = np.repeat(phl, rem.reshape(-1))
    ps_of = np.repeat(np.arange(pa_panels * NDIG), rem.sum(axis=1))
    ph_p2 = ps_of // NDIG
    ph_d1 = ps_of % NDIG
    kk2 = _concat_ranges(rem.sum(axis=1))
    ph_src2 = (NWIN - 1) * STRIPE * LANES + (kk2 % (STRIPE * LANES))
    a_sr = np.concatenate([pa_src_row, ph_src2 // LANES]).astype(np.int8)
    a_sc = np.concatenate([pa_src_lane, ph_src2 % LANES]).astype(np.int8)
    a_st = np.concatenate([e_d1, ph_d1]).astype(np.int8)
    a_dl = np.concatenate([pa_lane, ph_lane2]).astype(np.int8)
    a_p = np.concatenate([e_pan, ph_p2]).astype(np.int32)
    pa_route, _parows_all, _palanes = _route_panels(
        a_sr, a_sc, a_st, a_dl, a_p, pa_panels, NWIN * STRIPE,
        fill_from=(NWIN - 1) * STRIPE)
    _mark("pass A")
    _parows = _parows_all[:E].copy()
    del a_sr, a_sc, a_st, a_dl, a_p, _parows_all, _palanes
    del pa_src_row, pa_src_lane, ph_src2, ph_lane2, ph_d1, ph_p2

    # ---- fixup: gather every edge's routed slot from s1 into per-
    # (region, block) chunk groups — lane-columns are (block, lr)-pure
    # with depth stacking, so a column-⊕ folds them — then a second tiny
    # gather+fold maps lane-columns to lr positions. (Low in-degree rows
    # make an in-pass fold worthless, so pass A's output IS the fold
    # input; high-degree rows stack deep and fold here.)
    pan_reg = np.array([m_[0] * NDIG + m_[1] for m_ in pan_meta],
                       dtype=np.int64) if pan_meta else np.zeros(1, np.int64)
    if E == 0:
        fill_b = pa_panels * NDIG
        fr0, _r0, _l0 = _route_panels(
            np.full(PSLOTS, (2 - 1) * STRIPE, np.int64),
            np.tile(np.arange(LANES), STRIPE * STRIPE)[:PSLOTS],
            np.repeat(np.arange(NDIG), STRIPE * LANES),
            np.tile(np.arange(LANES), PROWS),
            np.zeros(PSLOTS, np.int64), 1, 2 * STRIPE,
            fill_from=(2 - 1) * STRIPE)
        f2r0, _x, _y = _route_panels(
            np.zeros(0, np.int64), np.zeros(0, np.int64),
            np.zeros(0, np.int64), np.zeros(0, np.int64),
            np.zeros(0, np.int64), 1, 2 * STRIPE)
        dense_rows0 = -(-(-(-dense_len // LANES)) // STRIPE) * STRIPE
        return Spmv3Plan(
            NC=NC, NR=NR, nblocks=nblocks, n_edges=0,
            xext_rows=xext_rows, exp_panels=exp_panels,
            pa_panels=pa_panels, pa_nwin=NWIN, exp_route=exp_route,
            pa_route=pa_route, pa_bases=pa_bases, w_stream=w_stream,
            fix_dst=np.zeros(STRIPE, np.int32),
            fix2_dst=np.zeros(1, np.int32),
            hub_mask=np.zeros(1, dtype=np.uint8),
            fixr_route=fr0,
            fixr_bases=np.full(2, fill_b, np.int32), fixr_nwin=2,
            fix_panels=1, fixr_seg=np.zeros(1, np.int32),
            xr_route=xr_route, xr_bases=xr_bases.reshape(-1),
            sx_rows=sxrows,
            f2_route=f2r0, f2_bases=np.zeros(2, np.int32), f2_nwin=2,
            f2_panels=1, f2_seg=np.zeros(1, np.int32),
            dense_rows=dense_rows0)
    e_parow = _parows                      # actual routed rows (from pass A)
    s1_pos = e_pan * PSLOTS + e_parow * LANES + pa_lane
    if _PLAN_DEBUG and E:
        _blk = np.concatenate([_s0.reshape(-1, STRIPE, LANES),
                               np.zeros((1, STRIPE, LANES), np.float32)])
        _vpa = _blk[np.stack(pan_bases)].reshape(-1, LANES)
        _s1 = simulate_route(pa_route, _vpa, pa_panels, 0.0)
        _bad = int((_s1.reshape(-1)[s1_pos] != _dbgx[e_col]).sum())
        assert _bad == 0, f"PLAN_DEBUG passA: {_bad}/{E} edges wrong"
    e_blk = blk[order]
    e_reg = pan_reg[e_pan]
    # order pieces per (block, region, lr, stream) — block-major so a
    # block's y_mid rows are contiguous for the level-2 gather
    # runs = (region, d1, block, row) — a run's edges all live in ONE bin
    # (super, d0, d1), whose s1 stripes are the few (panel, d1) stripes of
    # its region; ordering runs bin-major and filling slots CHUNK-major
    # (consecutive source positions fill a whole chunk across the run's
    # lane-columns) keeps every fixg chunk's source-window count at the
    # bin's stripe count. The old (block, region)-rectangular layout mixed
    # bins per chunk (87 windows at scale 16) and its uniform group depth
    # diverges on hub+many-rows mixes.
    # Within a run, edges are ordered by source (stripe, row, lane) and
    # then DEALT round-robin across the run's cells (cell = rank % w):
    # duplicate (stripe, row) sources — adjacent in this order — land in
    # different output lanes, so an 8-slot lane-column never needs two
    # source lanes for one (window, source-row, out-lane) key — the
    # conflict that costs build_gather_plan a subop layer. Chunk c of the
    # run still reads ranks [8cw, 8cw+8w), a contiguous stripe span.
    o6 = np.lexsort((s1_pos, e_row, e_blk, e_d1, e_reg))
    er_, ed1_, eb_, erow_ = e_reg[o6], e_d1[o6], e_blk[o6], e_row[o6]
    lchg = np.ones(E, dtype=bool)
    lchg[1:] = ((er_[1:] != er_[:-1]) | (ed1_[1:] != ed1_[:-1]) |
                (eb_[1:] != eb_[:-1]) | (erow_[1:] != erow_[:-1]))
    lid = np.cumsum(lchg) - 1
    run_starts = np.flatnonzero(lchg)
    cnt_run = np.bincount(lid)
    nrun = cnt_run.size
    run_blk = eb_[run_starts]
    run_lr = (erow_ % LANES)[run_starts]
    # a run of cnt edges gets w = ceil(cnt/(8*d)) lane-column CELLS of
    # depth d = ceil(cnt/1024) chunks. Two allocation tiers per y_mid row:
    #   smalls (w <= HUB_W) — column-major in the per-(class, bin)
    #     segment's (H x 128) grid with H >= max(ceil(cells/128),
    #     ceil(wmax/CPR)): a run puts at most CPR cells on one row, so
    #     the level-2 gather pays at most CPR subop layers for the
    #     same-(source row, dest lane) conflict.
    #   hubs (w > HUB_W) — one DEDICATED row each: all w cells at lanes
    #     0..w-1, fixg chunks fully packed; the engine lane-⊕-folds hub
    #     rows (hub_mask) before fix2, which then reads ONE cell per hub
    #     at its destination lane — no conflicts, no wasted rows. (A
    #     shared-H layout sized by a hub's w spreads every cell of the
    #     segment H rows thin: 16x fixg padding at scale 16.)
    d_run = np.maximum(1, -(-cnt_run // (STRIPE * LANES)))
    w_run = -(-cnt_run // (STRIPE * d_run))          # <= 128 cells
    assert int(w_run.max(initial=0)) <= LANES
    HUB_W = 16
    CPR = 4                                          # small cells/row cap
    is_hub = w_run > HUB_W
    cls_run = np.zeros(nrun, dtype=np.int64)
    big = d_run > 1
    cls_run[big] = np.int64(1) + np.floor(
        np.log2(d_run[big] - 1)).astype(np.int64)    # ceil(log2(d))
    run_bin = (er_ * NDIG + ed1_)[run_starts]
    ro2 = np.lexsort((np.arange(nrun), run_bin, cls_run))
    w_o = w_run[ro2]
    hub_o = is_hub[ro2]
    cls_o = cls_run[ro2]
    bin_o = run_bin[ro2]
    # segments never span a (class, bin) boundary: a chunk then reads
    # only its own bin's stripes, bounding the gather's window count
    seg_chg = np.ones(nrun, dtype=bool)
    seg_chg[1:] = (cls_o[1:] != cls_o[:-1]) | (bin_o[1:] != bin_o[:-1])
    seg_id_o = np.cumsum(seg_chg) - 1
    nseg = int(seg_id_o[-1]) + 1 if nrun else 0
    ws_o = np.where(hub_o, 0, w_o)                   # small cells only
    seg_cells = np.bincount(seg_id_o, weights=ws_o,
                            minlength=max(nseg, 1)).astype(np.int64)
    seg_wmax = np.zeros(max(nseg, 1), dtype=np.int64)
    np.maximum.at(seg_wmax, seg_id_o, ws_o)
    # hubs pack SEVERAL per row at power-of-2 slot boundaries: a hub of
    # w cells takes a 2^ceil(log2(w))-lane slot (fill >= 50%), and the
    # engine's pre-fix2 lane fold runs at that fixed granularity per row
    # (hub_wcode), so one row can carry 128/W independent hubs — the
    # one-hub-per-row layout measured 31% slot fill holding 42% of the
    # edges at scale 18
    hub_wcls = np.zeros(nrun, dtype=np.int64)
    if nrun:
        hub_wcls[hub_o] = np.ceil(
            np.log2(np.maximum(w_o[hub_o], 2))).astype(np.int64)
    hub_wcls = np.clip(hub_wcls, 0, 7)               # W = 2^c <= 128
    seg_Hs = np.where(seg_cells > 0,
                      np.maximum(-(-seg_cells // LANES),
                                 -(-seg_wmax // CPR)), 0)
    # hub rows per (segment, width class): ceil(count / (128/W))
    WCLS = list(range(5, 8))                         # W in {32, 64, 128}
    seg_nh = {}
    for c_ in WCLS:
        seg_nh[c_] = np.bincount(
            seg_id_o, weights=hub_o & (hub_wcls == c_),
            minlength=max(nseg, 1)).astype(np.int64)
    seg_hrows = {c_: -(-seg_nh[c_] // (LANES >> c_)) for c_ in WCLS}
    seg_H = seg_Hs + sum(seg_hrows[c_] for c_ in WCLS)
    seg_row0 = np.cumsum(seg_H) - seg_H
    nrb = int(seg_H.sum()) if nrun else 0
    # small-cell enumeration (segment-local, column-major over shared
    # rows): cell k -> row k % Hs, lane k // Hs
    cws = np.cumsum(ws_o)
    cell0_o = cws - ws_o
    seg_rep = np.diff(np.concatenate([np.flatnonzero(seg_chg), [nrun]]))
    seg_cell0 = np.repeat(cell0_o[seg_chg], seg_rep)
    ck_o = cell0_o - seg_cell0                       # first small cell
    # hub enumeration: index within (segment, width class)
    hk_o = np.zeros(nrun, dtype=np.int64)
    run_hrow = np.zeros(nrun, dtype=np.int64)
    run_hbase = np.zeros(nrun, dtype=np.int64)       # lane base of slot
    hrow_off = seg_Hs.copy()                         # running row offset
    for c_ in WCLS:
        sel = hub_o & (hub_wcls == c_)
        if sel.any():
            idx = np.flatnonzero(sel)
            segs = seg_id_o[idx]
            # rank within segment (ro2 order is segment-sorted)
            schg = np.ones(idx.size, dtype=bool)
            schg[1:] = segs[1:] != segs[:-1]
            rank = np.arange(idx.size) - np.repeat(
                np.flatnonzero(schg),
                np.diff(np.concatenate([np.flatnonzero(schg),
                                        [idx.size]])))
            per_row = LANES >> c_
            run_hrow[idx] = (seg_row0[segs] + hrow_off[segs]
                             + rank // per_row)
            run_hbase[idx] = (rank % per_row) << c_
        hrow_off = hrow_off + seg_hrows[c_]
    run_H = np.maximum(seg_Hs[seg_id_o], 1)
    run_row0 = seg_row0[seg_id_o]
    # y_mid row depth = max d of cells on the row
    occ_run_o = np.repeat(np.arange(nrun), w_o)      # in ro2 order
    occ_k = np.where(hub_o, 0, ck_o)[occ_run_o] + _concat_ranges(w_o)
    occ_hub = hub_o[occ_run_o]
    occ_row = np.where(occ_hub, run_hrow[occ_run_o],
                       run_row0[occ_run_o] + occ_k % run_H[occ_run_o])
    occ_lane = np.where(occ_hub, run_hbase[occ_run_o] + occ_k,
                        occ_k // run_H[occ_run_o])
    assert int(occ_lane.max(initial=0)) < LANES
    dgrp = np.zeros(max(nrb, 1), dtype=np.int64)
    np.maximum.at(dgrp, occ_row, d_run[ro2][occ_run_o])
    ch0 = np.cumsum(dgrp) - dgrp
    nchunks = int(dgrp.sum()) if nrun else 1
    # per-row fold width code: 0 = no fold, else W (32/64/128)
    hub_mask = np.zeros(max(nrb, 1), dtype=np.uint8)
    if nrun and hub_o.any():
        hub_mask[run_hrow[hub_o]] = (
            np.int64(1) << hub_wcls[hub_o]).astype(np.uint8)
    # scatter run fields back to run order
    inv2 = np.empty(nrun, dtype=np.int64)
    inv2[ro2] = np.arange(nrun)
    run_ck = ck_o[inv2]
    rH = run_H[inv2]
    rrow0 = run_row0[inv2]
    rhrow = run_hrow[inv2]
    rhbase = run_hbase[inv2]
    # per-edge positions: deal ranks across cells, chunk-major depth
    t_in = np.arange(E) - np.repeat(run_starts, cnt_run)
    Wl = w_run[lid]
    cell_k = t_in % Wl                               # cell within run
    within = t_in // Wl                              # < 8*d_run
    ehub = is_hub[lid]
    grow = np.where(ehub, rhrow[lid],
                    rrow0[lid] + (run_ck[lid] + cell_k) % rH[lid])
    lanecol = np.where(ehub, rhbase[lid] + cell_k,
                       (run_ck[lid] + cell_k) // rH[lid])
    chunk_id = ch0[grow] + within // STRIPE
    fix_dst = np.repeat(np.arange(max(nrb, 1)),
                        dgrp).astype(np.int32)[:nchunks]
    if fix_dst.size < nchunks:        # nrun==0 degenerate
        fix_dst = np.zeros(nchunks, dtype=np.int32)

    # ---- fix route: route s1 into 64-row chunk-stack panels with the
    # pass-A kernel instead of a windowed GATHER (whose per-step window
    # DMAs cost nsub*4KB per 1024 slots and whose (window,row,lane)
    # conflict key forces subop layers). Each window is fetched once per
    # panel through its own revolving buffer and the 3-stage crossbar
    # absorbs duplicate-key conflicts by construction. A slot's row
    # within its chunk is free (the fold is a column-⊕), which is
    # exactly the router's fixed-lane/free-row mode.
    e_sblk = s1_pos[o6] // (STRIPE * LANES)       # source s1 block
    fix_fill_blk = pa_panels * NDIG               # appended all-fill blk
    CW = 30                                       # window budget
    ch_e = chunk_id
    # (a) split chunks whose slots span > CW windows
    ek = ch_e * (np.int64(1) << 24) + e_sblk
    o8 = np.argsort(ek, kind="stable")
    eks = ek[o8]
    wchg = np.ones(E, dtype=bool)
    wchg[1:] = eks[1:] != eks[:-1]
    cid8 = eks >> 24
    cchg8 = np.ones(E, dtype=bool)
    cchg8[1:] = cid8[1:] != cid8[:-1]
    wr = np.cumsum(wchg) - 1
    wr0 = np.repeat(wr[cchg8], np.diff(np.concatenate(
        [np.flatnonzero(cchg8), [E]])))
    wrank = wr - wr0                              # window rank in chunk
    spl = wrank // CW
    assert int(spl.max(initial=0)) < 60
    newkey = np.where(spl > 0, cid8 * 60 + spl, np.int64(-1))
    uq = np.unique(newkey[newkey >= 0])
    ch_s = np.where(newkey >= 0,
                    np.searchsorted(uq, np.maximum(newkey, 0)) + nchunks,
                    cid8)
    ch_e = np.empty(E, dtype=np.int64)
    ch_e[o8] = ch_s
    if uq.size:
        fix_dst = np.concatenate(
            [fix_dst, fix_dst[(uq // 60).astype(np.int64)]])
    nchunks = fix_dst.size
    # (b) pack chunks into panels: <= 8 chunks, window union <= CW
    o9 = np.lexsort((e_sblk, ch_e))
    pk = ch_e[o9] * (np.int64(1) << 24) + e_sblk[o9]
    pchg = np.ones(E, dtype=bool)
    pchg[1:] = pk[1:] != pk[:-1]
    pr_c = ch_e[o9][pchg]                         # chunk of each pair
    pr_w = e_sblk[o9][pchg]                       # window of each pair
    pair_of_chunk = np.searchsorted(pr_c, np.arange(nchunks))
    pair_end = np.searchsorted(pr_c, np.arange(nchunks), side="right")
    pan_of_chunk = np.zeros(nchunks, dtype=np.int64)
    stripe_of_chunk = np.zeros(nchunks, dtype=np.int64)
    pan_wins: List[np.ndarray] = []
    pan_seg_l: List[int] = []
    # pack in (fold segment, chunk) order and close panels at segment
    # boundaries: the route_fold kernel keeps one FOLD_SEG_ROWS y-table
    # segment VMEM-resident and fetches the next when the prefetched
    # per-panel segment id advances — arbitrary nrb without VMEM OOM
    chunk_seg = fix_dst.astype(np.int64) // FOLD_SEG_ROWS
    cq_order = np.lexsort((np.arange(nchunks), chunk_seg))
    cur: set = set()
    nin = 0
    fp = 0
    cur_seg = int(chunk_seg[cq_order[0]]) if nchunks else 0
    for cq in cq_order.tolist():
        wins_c = pr_w[pair_of_chunk[cq]:pair_end[cq]]
        u_ = cur | set(wins_c.tolist())
        sg = int(chunk_seg[cq])
        if nin == STRIPE or (nin and (len(u_) > CW or sg != cur_seg)):
            pan_wins.append(np.asarray(sorted(cur), np.int64))
            pan_seg_l.append(cur_seg)
            fp += 1
            cur = set(wins_c.tolist())
            nin = 0
        else:
            cur = u_
        cur_seg = sg
        pan_of_chunk[cq] = fp
        stripe_of_chunk[cq] = nin
        nin += 1
    pan_wins.append(np.asarray(sorted(cur), np.int64))
    pan_seg_l.append(cur_seg)
    fix_panels = fp + 1
    fixr_seg = np.asarray(pan_seg_l, dtype=np.int32)
    fixr_nwin = max(2, max(w.size for w in pan_wins) + 1)  # + fill window
    fixr_bases = np.full((fix_panels, fixr_nwin), fix_fill_blk, np.int32)
    for p_ in range(fix_panels):
        fixr_bases[p_, :pan_wins[p_].size] = pan_wins[p_]
    # fix_dst re-ordered to (panel, stripe) chunk sequence; unassigned
    # stripes are unrouted (pure ⊕-identity) but must still carry a dst
    # row INSIDE the panel's segment — use the segment's first row
    fd_panel = np.repeat(fixr_seg.astype(np.int64) * FOLD_SEG_ROWS,
                         STRIPE).astype(np.int32)
    fd_panel[pan_of_chunk * STRIPE + stripe_of_chunk] = fix_dst[:nchunks]
    fix_dst = fd_panel
    # (c) per-slot route coordinates
    e_fp = pan_of_chunk[ch_e]
    e_fst = stripe_of_chunk[ch_e]
    # window index within the panel's base list — one flat keyed
    # searchsorted (the per-panel masked loop was O(panels * E): 150 s
    # of the 190 s fixr phase at RMAT-20)
    pw_len = np.asarray([w.size for w in pan_wins], dtype=np.int64)
    pw0 = np.concatenate([[0], np.cumsum(pw_len)])
    pw_flat = (np.concatenate(pan_wins) if pw0[-1] else
               np.zeros(0, np.int64))
    WBIG = np.int64(1) << 24
    pw_keys = np.repeat(np.arange(fix_panels, dtype=np.int64),
                        pw_len) * WBIG + pw_flat
    e_widx = np.searchsorted(pw_keys, e_fp * WBIG + e_sblk) - pw0[e_fp]
    f_sr = e_widx * STRIPE + (s1_pos[o6] // LANES) % STRIPE
    f_sc = s1_pos[o6] % LANES
    # phantoms fill the remaining (panel, stripe, lane) capacity
    cnt_fl = np.bincount((e_fp * NDIG + e_fst) * LANES + lanecol,
                         minlength=fix_panels * NDIG * LANES)
    rem_f = (STRIPE - cnt_fl.reshape(-1, LANES))
    assert rem_f.min() >= 0
    phl_f = np.tile(np.arange(LANES), fix_panels * NDIG)
    ph_lane_f = np.repeat(phl_f, rem_f.reshape(-1))
    ps_f = np.repeat(np.arange(fix_panels * NDIG), rem_f.sum(axis=1))
    kk_f = _concat_ranges(rem_f.sum(axis=1))
    ph_src_f = (fixr_nwin - 1) * STRIPE * LANES + (kk_f % (STRIPE * LANES))
    fr_sr = np.concatenate([f_sr, ph_src_f // LANES]).astype(np.int16)
    fr_sc = np.concatenate([f_sc, ph_src_f % LANES]).astype(np.int8)
    fr_st = np.concatenate([e_fst, ps_f % NDIG]).astype(np.int8)
    fr_dl = np.concatenate([lanecol, ph_lane_f]).astype(np.int8)
    fr_p = np.concatenate([e_fp, ps_f // NDIG]).astype(np.int32)
    fixr_route, _frrows, _frlanes = _route_panels(
        fr_sr, fr_sc, fr_st, fr_dl, fr_p, fix_panels, fixr_nwin * STRIPE,
        fill_from=(fixr_nwin - 1) * STRIPE)
    del fr_sr, fr_sc, fr_st, fr_dl, fr_p, _frrows, _frlanes
    del f_sr, f_sc, ph_src_f, ph_lane_f, ps_f
    if _PLAN_DEBUG and E:
        _s1f = np.concatenate([_s1.reshape(-1, STRIPE, LANES),
                               np.zeros((1, STRIPE, LANES), np.float32)])
        _vfx = _s1f[fixr_bases.reshape(fix_panels, fixr_nwin)].reshape(
            -1, LANES)
        _rt = simulate_route(fixr_route, _vfx, fix_panels, 0.0)
        _part = _rt.reshape(-1, STRIPE, LANES).sum(axis=1)
        _nmid = int(fix_dst.max()) + 1
        _ymid = np.zeros((_nmid, LANES), np.float64)
        np.add.at(_ymid, fix_dst, _part.astype(np.float64))
        _exp_mid = np.zeros_like(_ymid)
        np.add.at(_exp_mid, (grow, lanecol),
                  _dbgx[e_col[o6]].astype(np.float64))
        _badm = ~np.isclose(_ymid, _exp_mid, rtol=1e-3, atol=1e-6)
        assert not _badm.any(), (
            f"PLAN_DEBUG fixr: {int(_badm.sum())} y_mid cells wrong "
            f"(first {np.argwhere(_badm)[:5].tolist()})")

    _mark("fixr")
    # second level: y_mid (nrb,128) lane-column cells -> (block, lr);
    # the (block, lr) identity is per cell (a y_mid row mixes blocks).
    # Hub rows enter as ONE cell at the destination lane — the engine's
    # pre-fix2 lane fold has already collapsed the whole row into every
    # lane's slot.
    nrb1 = max(nrb, 1)
    sm = ~occ_hub
    hubs_r = np.flatnonzero(hub_o)
    r2 = np.concatenate([occ_row[sm], run_hrow[hubs_r]])
    b2_all = run_blk[ro2][occ_run_o]
    lr2_all = run_lr[ro2][occ_run_o]
    # a hub's folded value fills every lane of its 2^c slot; fix2 reads
    # the slot's base lane
    l2 = np.concatenate([occ_lane[sm], run_hbase[hubs_r]])
    b2 = np.concatenate([b2_all[sm], run_blk[ro2][hubs_r]])
    lr2 = np.concatenate([lr2_all[sm], run_lr[ro2][hubs_r]])
    # dense-direct fold (round 5): map each cell's compact (block, lr)
    # destination through the TCSC renumbering's inverse so fix2 lands
    # straight in the DENSE y layout — the mexp expansion gather (2.7
    # ms/iter at RMAT-20, reference analog: the IV[] indirection of
    # apply_stationary, vertex_program.hpp:1655-1670) disappears; dense
    # rows with no nnz source simply keep the fold identity.
    dense_rows = -(-(-(-dense_len // LANES)) // STRIPE) * STRIPE
    if iv_dense is not None:
        iv_ = np.asarray(iv_dense, np.int64)
        inv_iv = np.full(nblocks * LANES, -1, dtype=np.int64)
        vpos = np.flatnonzero(iv_ >= 0)
        inv_iv[iv_[vpos]] = vpos
    else:
        inv_iv = np.arange(nblocks * LANES, dtype=np.int64)
    if b2.size:
        dpos = inv_iv[b2 * np.int64(LANES) + lr2]
        assert (dpos >= 0).all(), "fix2 cell maps to no dense position"
        assert dpos.max() < dense_rows * LANES
        b2 = dpos // LANES
        lr2 = dpos % LANES
    o7 = np.lexsort((l2, r2, lr2, b2))
    key7 = (b2[o7] * np.int64(LANES) + lr2[o7])
    k7chg = np.concatenate([[True], key7[1:] != key7[:-1]])
    t7 = np.arange(b2.size) - np.repeat(
        np.flatnonzero(k7chg), np.diff(np.concatenate(
            [np.flatnonzero(k7chg), [b2.size]])))
    b7chg = np.concatenate([[True], b2[o7][1:] != b2[o7][:-1]])
    bid7 = np.cumsum(b7chg) - 1
    nb7 = int(bid7[-1]) + 1 if b2.size else 0
    # chunks per block: round-robin cells across them — the chunk count
    # follows the block's TOTAL cells, not its deepest (block, lr) stack
    # (rectangular stacking left chunks 4-8x empty once one destination
    # stacked deep); per (chunk, lane) depth stays <= 8 by construction
    maxst_b = np.zeros(max(nb7, 1), dtype=np.int64)
    np.maximum.at(maxst_b, bid7, t7 + 1)
    # depth-contiguous chunk assignment: DEPTH7 consecutive depth ranks
    # (= consecutive y_mid rows, cells are row-sorted per destination)
    # per chunk — keeps <= DEPTH7 per (chunk, lane) AND ~2 windows per
    # chunk, which the route_fold's <= 31-window sel encoding needs
    # (round-robin spread every chunk across its whole block's window
    # span).  DEPTH7 = 7 leaves the fixed-lane solver one spare row per
    # (chunk, lane) — at exactly 8 the greedy+repair placement has no
    # slack and fails at scale.
    DEPTH7 = STRIPE - 1
    dep7 = np.maximum(1, -(-maxst_b // DEPTH7))
    ch07 = np.concatenate([[0], np.cumsum(dep7)])[:-1] if nb7 else \
        np.zeros(1, np.int64)
    cb7 = np.maximum(dep7[bid7], 1)
    chunk7 = ch07[bid7] + (t7 // DEPTH7) % cb7
    nch7 = int(dep7.sum()) if nb7 else 1
    fix2_dst = np.zeros(nch7, dtype=np.int32)
    if nb7:
        blk_of7 = b2[o7][np.flatnonzero(b7chg)]
        fix2_dst = np.repeat(blk_of7, dep7).astype(np.int32)
    # fix2 is a route_fold, not a gather (the gather's 225k-inner-step
    # grid cost 10 ms/iter at RMAT-20): windows = the panel's distinct
    # y_mid 8-row blocks (block-major cell layout keeps them few); dst
    # stripe = chunk position in panel, dst lane = lr (fixed), depth row
    # chosen by the solver (<= 8 per (chunk, lane) by construction).
    # Chunks pack into panels greedily under a window-union cap (a panel
    # may close with < 8 chunks; the empty stripes are unrouted = fill).
    F2_WCAP = 28
    cr2, cl2 = r2[o7], l2[o7]
    # split chunks whose cells span > F2_CHUNK_WCAP distinct y_mid
    # windows (same move as the fixr packing's step (a)): a chunk is
    # shared by every destination lr of its block, so a hub-rich block's
    # chunk can reference far-apart y_mid rows — 47 windows at RMAT-20
    # ROW ordering, past the route sel encoding's 31-band limit.  The
    # ⊕-fold accumulates duplicate-dst chunks, so splitting is free.
    F2_CHUNK_WCAP = 22
    wb7 = cr2 // STRIPE
    ek2 = chunk7 * (np.int64(1) << 24) + wb7
    o10 = np.argsort(ek2, kind="stable")
    eks2 = ek2[o10]
    wchg2 = np.ones(eks2.size, dtype=bool)
    wchg2[1:] = eks2[1:] != eks2[:-1]
    cid10 = eks2 >> 24
    cchg10 = np.ones(eks2.size, dtype=bool)
    cchg10[1:] = cid10[1:] != cid10[:-1]
    wr2 = np.cumsum(wchg2) - 1
    wr20 = np.repeat(wr2[cchg10], np.diff(np.concatenate(
        [np.flatnonzero(cchg10), [eks2.size]])))
    wrank2 = wr2 - wr20                        # window rank within chunk
    spl2 = wrank2 // F2_CHUNK_WCAP
    assert int(spl2.max(initial=0)) < 64
    newkey2 = np.where(spl2 > 0, cid10 * 64 + spl2, np.int64(-1))
    uq2 = np.unique(newkey2[newkey2 >= 0])
    ch_new = np.where(newkey2 >= 0,
                      np.searchsorted(uq2, np.maximum(newkey2, 0)) + nch7,
                      cid10)
    tmp7 = np.empty(eks2.size, dtype=np.int64)
    tmp7[o10] = ch_new
    chunk7 = tmp7
    if uq2.size:
        fix2_dst = np.concatenate(
            [fix2_dst, fix2_dst[(uq2 // 64).astype(np.int64)]])
    nch7 = fix2_dst.size
    # renumber chunks by destination row so the panel packing below is
    # fold-SEGMENT-sorted even after window-split chunks were appended
    # out of block order (the dense y table can span several
    # FOLD_SEG_ROWS segments)
    perm9 = np.lexsort((np.arange(nch7), fix2_dst))
    rank9 = np.empty(nch7, dtype=np.int64)
    rank9[perm9] = np.arange(nch7)
    chunk7 = rank9[chunk7]
    fix2_dst = fix2_dst[perm9]
    # per-chunk window sets, in chunk order
    och = np.argsort(chunk7, kind="stable")
    ch_s = chunk7[och]
    wb_s = cr2[och] // STRIPE
    chg = np.concatenate([[True], ch_s[1:] != ch_s[:-1]])
    st9 = np.flatnonzero(chg)
    en9 = np.concatenate([st9[1:], [ch_s.size]])
    pan_of_chunk = np.zeros(nch7, dtype=np.int64)
    stripe_of_chunk = np.zeros(nch7, dtype=np.int64)
    seg_of_chunk7 = fix2_dst.astype(np.int64) // FOLD_SEG_ROWS
    pan_wins: List[np.ndarray] = []
    pan_seg_l2: List[int] = []
    cur: set = set()
    cur_n = 0
    cur_seg = 0
    pnl = 0
    ci = 0
    for s9, e9 in zip(st9.tolist(), en9.tolist()):
        cw = set(np.unique(wb_s[s9:e9]).tolist())
        ch = int(ch_s[s9])
        cseg = int(seg_of_chunk7[ch])
        if cur_n == STRIPE or len(cur | cw) > F2_WCAP or \
                (cur_n > 0 and cseg != cur_seg):
            pan_wins.append(np.asarray(sorted(cur), np.int64))
            pan_seg_l2.append(cur_seg)
            pnl += 1
            cur, cur_n = set(), 0
        cur |= cw
        cur_seg = cseg
        pan_of_chunk[ch] = pnl
        stripe_of_chunk[ch] = cur_n
        cur_n += 1
        ci += 1
    pan_wins.append(np.asarray(sorted(cur), np.int64))
    pan_seg_l2.append(cur_seg)
    f2_panels = max(1, pnl + 1)
    f2_seg = np.asarray(pan_seg_l2[:f2_panels], dtype=np.int32)
    if f2_seg.size < f2_panels:
        f2_seg = np.zeros(f2_panels, dtype=np.int32)
    assert (np.diff(f2_seg) >= 0).all(), "f2 panels not segment-sorted"
    f2_nwin = max(2, max((w.size for w in pan_wins), default=1))
    assert f2_nwin <= 31, ("fix2 route window overflow", f2_nwin)
    f2_bases = np.zeros((f2_panels, f2_nwin), dtype=np.int32)
    for q, w_ in enumerate(pan_wins):
        if w_.size:
            f2_bases[q, :w_.size] = w_
            f2_bases[q, w_.size:] = w_[-1]
    f2_pof = pan_of_chunk[chunk7]
    band8 = np.zeros(b2.size, dtype=np.int64)
    # band of each cell within its panel's window list (segment-sliced)
    op9 = np.argsort(f2_pof, kind="stable")
    pof9 = f2_pof[op9]
    pch9 = np.concatenate([[True], pof9[1:] != pof9[:-1]])
    sp9 = np.flatnonzero(pch9)
    ep9 = np.concatenate([sp9[1:], [pof9.size]])
    for s9, e9 in zip(sp9.tolist(), ep9.tolist()):
        w_ = pan_wins[int(pof9[s9])]
        idxs = op9[s9:e9]
        band8[idxs] = np.searchsorted(w_, cr2[idxs] // STRIPE)
    f2_route64, _f2r, _f2l = _route_panels(
        band8 * STRIPE + cr2 % STRIPE, cl2,
        stripe_of_chunk[chunk7], lr2[o7], f2_pof, f2_panels,
        f2_nwin * STRIPE)
    # (panel, stripe)-indexed chunk destinations; empty stripes fold fill
    # into their panel's own segment base row (a fill fold is a ⊕-no-op)
    fix2_dst_ps = np.repeat(f2_seg.astype(np.int32) * FOLD_SEG_ROWS,
                            STRIPE)
    fix2_dst_ps[pan_of_chunk * STRIPE + stripe_of_chunk] = fix2_dst
    fix2_dst = fix2_dst_ps

    _mark("fix2")
    return Spmv3Plan(
        NC=NC, NR=NR, nblocks=nblocks, n_edges=E,
        xext_rows=xext_rows, exp_panels=exp_panels, pa_panels=pa_panels,
        pa_nwin=NWIN, exp_route=exp_route, pa_route=pa_route,
        pa_bases=pa_bases, w_stream=w_stream, fix_dst=fix_dst,
        fix2_dst=fix2_dst, hub_mask=hub_mask, fixr_route=fixr_route,
        fixr_bases=fixr_bases.reshape(-1), fixr_nwin=fixr_nwin,
        fix_panels=fix_panels, fixr_seg=fixr_seg,
        xr_route=xr_route, xr_bases=xr_bases.reshape(-1), sx_rows=sxrows,
        f2_route=f2_route64, f2_bases=f2_bases.reshape(-1),
        f2_nwin=f2_nwin, f2_panels=f2_panels, f2_seg=f2_seg,
        dense_rows=dense_rows)


def simulate_spmv3(plan: Spmv3Plan, x: np.ndarray, fill, reduce_kind="sum",
                   mul_kind="none") -> np.ndarray:
    """Numpy oracle of the whole v3 pipeline: x (NC,) -> y_dense
    (dense_rows*128,). Mirrors the kernel sequence exactly."""
    from graphtap_tpu_torch.kernels.gather_plan import simulate_gather
    red = {"sum": np.add, "min": np.minimum, "max": np.maximum}[reduce_kind]
    sx = plan.sx_rows
    x2d = np.full((sx, LANES), fill, x.dtype)
    x2d.reshape(-1)[:x.size] = x
    # x -> x_ext route: stack NWIN_X window operands per panel
    xb2 = x2d.reshape(-1, STRIPE, LANES)
    nxp = plan.xr_bases.size // NWIN_X
    vx = xb2[plan.xr_bases.reshape(nxp, NWIN_X)]
    vx = vx.reshape(nxp * NWIN_X * STRIPE, LANES)
    x_ext = simulate_route(plan.xr_route, vx, nxp, fill, out_rows=XROWS)
    s0 = simulate_route(plan.exp_route, x_ext, plan.exp_panels, fill)
    if plan.w_stream is not None:
        if mul_kind == "mul":
            s0 = s0 * plan.w_stream
        elif mul_kind == "add_sat":
            s0 = np.where(s0 >= fill, fill, s0 + plan.w_stream)
    # pass A: assemble NWIN stripe windows per panel, then route
    blocks = np.concatenate(
        [s0.reshape(-1, STRIPE, LANES),
         np.full((1, STRIPE, LANES), fill, s0.dtype)], axis=0)
    v = blocks[plan.pa_bases.reshape(plan.pa_panels, plan.pa_nwin)]
    v = v.reshape(plan.pa_panels * plan.pa_nwin * STRIPE, LANES)
    s1 = simulate_route(plan.pa_route, v, plan.pa_panels, fill)

    def chunked_fold(src2d, gplan, dstv, nrows):
        stack = simulate_gather(gplan, src2d, fill)
        stack = stack.reshape(-1, STRIPE, LANES)
        part = red.reduce(stack, axis=1)
        out = np.full((nrows, LANES), fill, part.dtype)
        if reduce_kind == "sum":
            np.add.at(out, dstv, part)
        elif reduce_kind == "min":
            np.minimum.at(out, dstv, part)
        else:
            np.maximum.at(out, dstv, part)
        return out

    # fix route: assemble window stacks from s1 (+ one fill block), route
    s1f = np.concatenate(
        [s1.reshape(-1, STRIPE, LANES),
         np.full((1, STRIPE, LANES), fill, s1.dtype)], axis=0)
    vf = s1f[plan.fixr_bases.reshape(plan.fix_panels, plan.fixr_nwin)]
    vf = vf.reshape(plan.fix_panels * plan.fixr_nwin * STRIPE, LANES)
    stack1 = simulate_route(plan.fixr_route, vf, plan.fix_panels, fill)

    def chunked_fold_arr(stack, dstv, nrows):
        stack = stack.reshape(-1, STRIPE, LANES)
        part = red.reduce(stack, axis=1)
        out = np.full((nrows, LANES), fill, part.dtype)
        if reduce_kind == "sum":
            np.add.at(out, dstv, part)
        elif reduce_kind == "min":
            np.minimum.at(out, dstv, part)
        else:
            np.maximum.at(out, dstv, part)
        return out

    nb_raw = (plan.fix_dst.max() + 1) if plan.fix_dst.size else 1
    y_mid = chunked_fold_arr(stack1, plan.fix_dst, int(nb_raw))
    # hub rows: lane-⊕-fold at the row's slot width before fix2
    hm = plan.hub_mask
    if hm.size and hm.any():
        hmp = np.zeros(y_mid.shape[0], dtype=np.uint8)
        hmp[:min(hm.size, y_mid.shape[0])] = hm[:y_mid.shape[0]]
        out = y_mid
        for W in (32, 64, 128):
            f = red.reduce(y_mid.reshape(-1, LANES // W, W), axis=2)
            f = np.repeat(f, W, axis=1)
            out = np.where((hmp == W)[:, None], f, out)
        y_mid = out
    y_mid8 = np.full((-(-y_mid.shape[0] // STRIPE) * STRIPE, LANES), fill,
                     y_mid.dtype)
    y_mid8[:y_mid.shape[0]] = y_mid
    # fix2 route_fold: stack the panel's y_mid windows, route, fold each
    # stripe into its block row
    ymb = y_mid8.reshape(-1, STRIPE, LANES)
    vf2 = ymb[np.minimum(plan.f2_bases.reshape(plan.f2_panels,
                                               plan.f2_nwin),
                         ymb.shape[0] - 1)]
    vf2 = vf2.reshape(plan.f2_panels * plan.f2_nwin * STRIPE, LANES)
    routed2 = simulate_route(plan.f2_route, vf2, plan.f2_panels, fill)
    dstv = np.zeros(plan.f2_panels * STRIPE, np.int64)
    dstv[:plan.fix2_dst.size] = plan.fix2_dst
    y = chunked_fold_arr(routed2, dstv, plan.dense_rows)
    return y.reshape(-1)
