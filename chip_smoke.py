#!/usr/bin/env python3
"""Drive the torch port's PageRank and frontier paths on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed as it runs; any failure exits non-zero:

  1. device   the card's name and power limit (nvidia-smi), torch, CUDA
              and nvcc versions; fails without CUDA.
  2. build    nvcc builds the four panel-route kernels from csrc/.
  3. parity   each kernel against its plain torch version on the card, on
              RMAT-14 plans in f32 sum, f64 sum (weighted) and int32 min
              (weighted). K1, K2, K4 bit for bit; K3 bit for bit in int32,
              elementwise rtol 1e-5 (f32) / 1e-12 (f64): its atomic adds
              reorder float sums.
  4. main     RMAT-20 (edge factor 16, seed 1): degree (scan) + 20 PageRank
              iterations through apps.run_pagerank(device="cuda") in f32;
              the checksum within 1e-4 relative of the f64 NumPy golden
              model (tests/golden.py), the launch counts of K1-K4.
  3b. gated  the gated K1-K3 against their gated plain versions, bit for
              bit, on RMAT-14 plans in int32 min (weighted add_sat through
              sssp_config, unweighted through bfs_config), on a 2%, a 30%
              (each a contiguous vertex range) and an empty frontier; and
              the gated spmv3 against the static one, bit for bit.
  5. kernels  each kernel's time beside its plain version's at the RMAT-20
              shapes of the main path, and their largest difference
              (K3: max |diff| <= 1e-5 * max |plain|, f32).
  6. bfs      RMAT-18 through bfs_config: apps.run_bfs(device="cuda") to
              convergence, frontier-gated ("auto"); hops and parents equal
              tests/golden.py::bfs bit for bit; every gated kernel
              launched; each superstep's branch and time (CUDA events);
              then re-initialized and run again warm. The gated kernels'
              times at the shapes of BFS's first superstep.
  7. cc/sssp  CC and SSSP at RMAT-18, each through its own config, to
              convergence; labels and distances equal the golden models.

The last line is {"ok": true, "device": {...}}; the line before it lists
the kernels with their launches (from the PageRank path for K1-K4, from
the BFS path for the gated rows), errors and times.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time

SCALE = 20
EDGE_FACTOR = 16
SEED = 1
ITERS = 20
PARITY_SCALE = 14
# BFS: the host planner (the JAX package's panel_plan.py) finds no
# x->x_ext route for RMAT-20 through bfs_config at any quota rung
# (RouteInfeasible), so BFS runs at RMAT-18, the scale of BENCH_SUITE.json
FRONTIER_SCALE = 18
SUITE_SCALE = 18             # CC and SSSP, their BENCH_SUITE.json scale
GATED = ("route_xr_exp_gated", "route_passa_gated", "route_fold_gated")
DEVICE = "cuda"
GOLDEN_RTOL = 1e-4
FOLD_RTOL = {"float32": 1e-5, "float64": 1e-12}
ROOT = os.path.dirname(os.path.abspath(__file__))
SOURCE = "graphtap_tpu_torch/csrc/panel_route.cu"
REPLACES = {
    "route_xr_exp": "graphtap_tpu/kernels/panel_kernels.py:217",
    "route_passa": "graphtap_tpu/kernels/panel_kernels.py:435",
    "route_fold": "graphtap_tpu/kernels/panel_kernels.py:331",
    "hub_fold": "graphtap_tpu/kernels/panel_kernels.py:507",
    "route_xr_exp_gated": "graphtap_tpu/kernels/panel_kernels.py:226",
    "route_passa_gated": "graphtap_tpu/kernels/panel_kernels.py:453",
    "route_fold_gated": "graphtap_tpu/kernels/panel_kernels.py:356",
}


def log(msg: str) -> None:
    print(f"[smoke] {msg}", flush=True)


def run(cmd) -> str:
    return subprocess.run(cmd, capture_output=True, text=True, timeout=60,
                          check=True).stdout.strip()


def phase_device(torch) -> None:
    smi = run(["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"])
    print(smi, flush=True)
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    ver = run([nvcc, "--version"]).splitlines()[-1] if os.path.exists(
        nvcc) else "nvcc not found"
    log(f"device: {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}; {ver}")


def phase_build() -> None:
    from graphtap_tpu_torch.kernels import _cuda
    t0 = time.perf_counter()
    path = _cuda.build()
    _cuda.library()
    log(f"build: {path.name} in {time.perf_counter() - t0:.1f} s")
    entry = ""
    for line in _cuda.build_log.splitlines():
        if "Compiling entry" in line:       # mangled name: keep the kernel
            entry = line.split("'")[1].split("_cu_")[-1][8:]
        elif "registers" in line:
            log(f"  ptxas {entry}: {line.split(':', 1)[1].strip()}")


def _same(a, b) -> bool:
    import torch
    return a.shape == b.shape and a.dtype == b.dtype and bool(
        torch.equal(a, b))


def _fold_ok(a, b, kind: str, rtol: float) -> bool:
    """K3 check: int bit for bit; float sums elementwise within rtol."""
    import torch
    if kind != "sum" or not b.dtype.is_floating_point:
        return _same(a, b)
    return bool(torch.all((a - b).abs() <= rtol * b.abs()))


def _kernel_calls(t, meta, sem, st):
    """(name, kernel call, plain call) for each launch of one SpMV, on the
    stage tensors ``st`` of that SpMV (the kernels' own inputs)."""
    from graphtap_tpu_torch.kernels import panel_kernels as pk
    fill, kind = sem.identity, sem.reduce_kind
    mul = ("mul" if kind == "sum" else "add_sat") if meta.has_w else "none"
    xe = (st["x2d"], t["xr_bases"], t["xe_plan"], t.get("w_stream"), fill,
          meta.exp_panels + 1, meta.xr_nwin, mul)
    pa = (st["s0"], t["pa_bases"], t["pa_plan"], fill, meta.pa_panels + 1,
          meta.pa_nwin)
    fx = (st["s1"], t["fixr_bases"], t["fixr_plan"], t["fix_dst"],
          t["fixr_seg"], meta.nrb, kind, fill, meta.fix_panels,
          meta.fixr_nwin)
    hb = (st["y_mid"], t["hub_mask"], kind)
    f2 = (st["y_hub"], t["f2_bases"], t["f2_plan"], t["fix2_dst"],
          t["f2_seg"], meta.f2_rows, kind, fill, meta.f2_panels,
          meta.f2_nwin)
    return [("route_xr_exp", lambda: pk.route_xr_exp(*xe),
             lambda: pk.route_xr_exp_plain(*xe)),
            ("route_passa", lambda: pk.route_passa(*pa),
             lambda: pk.route_passa_plain(*pa)),
            ("route_fold", lambda: pk.route_fold(*fx),
             lambda: pk.route_fold_plain(*fx)),
            ("hub_fold", lambda: pk.hub_fold(*hb),
             lambda: pk.hub_fold_plain(*hb)),
            ("route_fold", lambda: pk.route_fold(*f2),
             lambda: pk.route_fold_plain(*f2))]


def phase_parity(torch, np) -> None:
    from graphtap_tpu_torch import GraphConfig, Graph
    from graphtap_tpu_torch.ingest import rmat_edges
    from graphtap_tpu_torch.kernels.panel_engine import spmv3_stages
    from graphtap_tpu_torch.kernels.panel_meta import build_spmv3_meta
    from graphtap_tpu_torch.kernels.semiring import (INF_I32, min_plus,
                                                     plus_times)
    from graphtap_tpu_torch.tools.convert import meta_from_numpy
    rng = np.random.default_rng(SEED)
    n = 1 << PARITY_SCALE
    for dtype, sem, weighted in ((np.float32, plus_times(), False),
                                 (np.float64, plus_times(), True),
                                 (np.int32, min_plus(), True)):
        r, c, w = rmat_edges(PARITY_SCALE, EDGE_FACTOR, seed=SEED,
                             weighted=weighted)
        g = Graph.from_edges(r, c, w, GraphConfig(num_vertices=n,
                                                  transpose=True))
        tiles = g.tiled()
        meta = build_spmv3_meta(tiles, value_dtype=dtype)
        t = meta_from_numpy(meta.arrays, DEVICE)
        if dtype == np.int32:
            xv = rng.integers(0, 1000, size=g.part.tile_cols).astype(dtype)
            xv[rng.random(xv.size) < 0.3] = INF_I32
        else:
            xv = rng.random(g.part.tile_cols).astype(dtype)
        x = torch.from_numpy(xv).to(DEVICE)
        st = spmv3_stages(x, t, meta, sem, g.part.tile_rows)
        name_dt = np.dtype(dtype).name
        for name, kern, plain in _kernel_calls(t, meta, sem, st):
            a, b = kern(), plain()
            ok = (_fold_ok(a, b, sem.reduce_kind, FOLD_RTOL.get(name_dt, 0))
                  if name == "route_fold" else _same(a, b))
            err = float((a.double() - b.double()).abs().max()) \
                if a.numel() else 0.0
            log(f"parity {name_dt} {sem.reduce_kind} {name}: "
                f"{'ok' if ok else 'MISMATCH'} (max |diff| {err!r})")
            if not ok:
                raise AssertionError(f"{name} disagrees with its plain "
                                     f"version ({name_dt})")
        # the chain as a whole against a dense numpy SpMV of the tiles
        n_e = int(tiles.nnz[0, 0])
        rows = tiles.rows[0, :n_e].astype(np.int64)
        cols = tiles.cols[0, :n_e].astype(np.int64)
        iv = tiles.iv_dense[0]
        if sem.reduce_kind == "sum":
            contrib = xv[cols].astype(np.float64)
            if weighted:
                contrib = contrib * tiles.weights[0, :n_e]
            yc = np.zeros(tiles.NR)
            np.add.at(yc, rows, contrib)
            ref = np.where(iv >= 0, yc[np.maximum(iv, 0)], 0.0)
            got = st["y"].double().cpu().numpy()
            ok = np.allclose(got, ref, rtol=FOLD_RTOL[name_dt] * 10,
                             atol=0)
        else:
            xs = xv[cols].astype(np.int64)
            contrib = np.where(xs >= INF_I32, INF_I32,
                               xs + tiles.weights[0, :n_e])
            yc = np.full(tiles.NR, INF_I32, np.int64)
            np.minimum.at(yc, rows, contrib)
            ref = np.where(iv >= 0, yc[np.maximum(iv, 0)], INF_I32)
            ok = np.array_equal(st["y"].cpu().numpy(), ref.astype(np.int32))
        log(f"parity {name_dt} {sem.reduce_kind} spmv3 vs numpy SpMV: "
            f"{'ok' if ok else 'MISMATCH'}")
        if not ok:
            raise AssertionError(f"spmv3 disagrees with numpy ({name_dt})")


def _gated_calls(t, meta, sem, st, maps):
    """(name, kernel call, plain call) for the gated K1-K3 of one SpMV on
    its stage tensors ``st`` and gating maps ``maps``."""
    from graphtap_tpu_torch.kernels import panel_kernels as pk
    from graphtap_tpu_torch.kernels.panel_meta import fill_blocks
    fill, kind = sem.identity, sem.reduce_kind
    mul = "add_sat" if meta.has_w else "none"
    xe_b, xe_q, pa_b, pa_q, fx_b, fx_q = maps
    fb = fill_blocks(meta)
    xe = (st["x2d"], xe_b, t["xe_plan"], t.get("w_stream"), fill,
          meta.exp_panels + 1, meta.xr_nwin, mul)
    pa = (st["s0"], pa_b, t["pa_plan"], fill, meta.pa_panels + 1,
          meta.pa_nwin)
    fx = (st["s1"], fx_b, t["fixr_plan"], t["fix_dst"], t["fixr_seg"],
          meta.nrb, kind, fill, meta.fix_panels, meta.fixr_nwin)
    return [("route_xr_exp_gated",
             lambda: pk.route_xr_exp(*xe, plan_idx=xe_q,
                                     fill_block=fb["xe_plan"]),
             lambda: pk.route_xr_exp_plain(*xe, plan_idx=xe_q)),
            ("route_passa_gated",
             lambda: pk.route_passa(*pa, plan_idx=pa_q,
                                    fill_block=fb["pa_plan"]),
             lambda: pk.route_passa_plain(*pa, plan_idx=pa_q)),
            ("route_fold_gated",
             lambda: pk.route_fold(*fx, plan_idx=fx_q,
                                   fill_block=fb["fixr_plan"]),
             lambda: pk.route_fold_plain(*fx, plan_idx=fx_q))]


def phase_gated_parity(torch, np) -> None:
    from graphtap_tpu_torch import Graph
    from graphtap_tpu_torch.apps import bfs_config, sssp_config
    from graphtap_tpu_torch.ingest import rmat_edges
    from graphtap_tpu_torch.kernels.panel_engine import spmv3_stages
    from graphtap_tpu_torch.kernels.panel_meta import (build_spmv3_meta,
                                                       fill_blocks)
    from graphtap_tpu_torch.kernels.semiring import min_plus, min_select
    from graphtap_tpu_torch.tools.convert import meta_from_numpy
    rng = np.random.default_rng(SEED)
    n = 1 << PARITY_SCALE
    for weighted, cfg_fn, sem in ((True, sssp_config, min_plus()),
                                  (False, bfs_config, min_select())):
        r, c, w = rmat_edges(PARITY_SCALE, EDGE_FACTOR, seed=SEED,
                             weighted=weighted)
        g = Graph.from_edges(r, c, w, cfg_fn(n))
        meta = build_spmv3_meta(g.tiled(), value_dtype=np.int32)
        t = meta_from_numpy(meta.arrays, DEVICE)
        nc, inf = g.part.tile_cols, sem.identity
        for share in (0.02, 0.30, 0.0):
            xv = np.full(nc, inf, np.int32)
            k = int(nc * share)
            lo = (nc - k) // 2
            xv[lo:lo + k] = rng.integers(0, 1000, k)
            x = torch.from_numpy(xv).to(DEVICE)
            st = spmv3_stages(x, t, meta, sem, g.part.tile_rows, gate=True)
            static = spmv3_stages(x, t, meta, sem, g.part.tile_rows)
            maps = st["maps"]
            fb = fill_blocks(meta)
            # real panels gated off (the fill panels point at themselves)
            off = [int((q[:n] == fb[nm]).sum()) for q, nm, n in zip(
                maps[1::2], ("xe_plan", "pa_plan", "fixr_plan"),
                (meta.exp_panels, meta.pa_panels, meta.fix_panels))]
            tag = (f"{'weighted' if weighted else 'unweighted'} "
                   f"{share:.0%} frontier")
            for name, kern, plain in _gated_calls(t, meta, sem, st, maps):
                a, b = kern(), plain()
                ok = _same(a, b)
                log(f"gated parity {tag} {name}: "
                    f"{'ok' if ok else 'MISMATCH'}")
                if not ok:
                    raise AssertionError(f"{name} disagrees with its "
                                         f"plain version ({tag})")
            ok = _same(st["y"], static["y"])
            log(f"gated parity {tag}: gated spmv3 vs static "
                f"{'ok' if ok else 'MISMATCH'}; panels gated off (xe, pa, "
                f"fixr) {off}")
            if not ok:
                raise AssertionError(f"gated spmv3 != static ({tag})")


def _ms(fn, torch, reps: int) -> float:
    """Mean device time of one call (CUDA events over ``reps`` calls)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _golden():
    """tests/golden.py, the NumPy golden models (loaded by path)."""
    from graphtap_tpu_torch import _host
    return _host.load_file(os.path.join(ROOT, "tests", "golden.py"),
                           "graphtap_tpu_torch._host.golden")


def phase_main(torch, np):
    from graphtap_tpu_torch import GraphConfig, Graph
    from graphtap_tpu_torch.apps import run_pagerank
    from graphtap_tpu_torch.ingest import rmat_edges
    from graphtap_tpu_torch.kernels import panel_kernels as pk
    t0 = time.perf_counter()
    r, c, _ = rmat_edges(SCALE, EDGE_FACTOR, seed=SEED)
    n = 1 << SCALE
    g = Graph.from_edges(r, c, None, GraphConfig(num_vertices=n,
                                                 transpose=True))
    log(f"main: edges RMAT-{SCALE} E={r.size} in "
        f"{time.perf_counter() - t0:.1f} s")
    pk.reset_launches()
    t0 = time.perf_counter()
    ex = run_pagerank(g, ITERS, torch.float32, kernel="panel",
                      device=DEVICE)
    wall = time.perf_counter() - t0
    launches = dict(pk.LAUNCHES)
    tm = ex.timings
    log(f"main: PageRank tiles {tm['tiles']:.1f} s, plans "
        f"{tm['plans']:.1f} s, upload {tm['upload']:.2f} s")
    log(f"main: degree phase + PageRank setup "
        f"{wall - tm['tiles'] - tm['plans'] - tm['upload'] - tm['execute']:.1f}"
        f" s; run_pagerank wall {wall:.1f} s")
    log(f"main: launches {launches}")
    _need_launches("main", launches, {
        "route_xr_exp": ITERS, "route_passa": ITERS,
        "route_fold": 2 * ITERS, "hub_fold": ITERS})
    checksum, reach = ex.checksum()
    golden = _golden()
    gsum = float(golden.pagerank(r, c, n + 1, ITERS).sum())
    rel = abs(checksum - gsum) / abs(gsum)
    log(f"main: checksum {checksum!r} (reachable {reach}) vs f64 golden "
        f"{gsum!r}: rel err {rel:.3e}")
    if not rel < GOLDEN_RTOL:
        raise AssertionError(f"checksum rel err {rel} >= {GOLDEN_RTOL}")
    nnz = ex.tiles.nnz_total
    first = tm["execute"]
    ex.execute(ITERS)                   # the same 20 supersteps, warm
    warm = ex.timings["execute"]
    log(f"main: {ITERS} iterations {first:.4f} s first, {warm:.4f} s warm; "
        f"{nnz * ITERS / warm / 1e9:.4f} GTEPS warm "
        f"({nnz * ITERS / first / 1e9:.4f} first), nnz {nnz}")
    return ex, launches


def phase_kernels(torch, ex, launches):
    from graphtap_tpu_torch.kernels.panel_engine import spmv3_stages
    from graphtap_tpu_torch.tools.convert import meta_from_numpy
    meta, sem = ex.meta, ex.program.semiring
    t = meta_from_numpy(meta.arrays, DEVICE)
    x = ex.program.messenger(ex.state).to(torch.float32)
    st = spmv3_stages(x, t, meta, sem, ex.part.tile_rows)
    rows = {}
    for name, kern, plain in _kernel_calls(t, meta, sem, st):
        a, b = kern(), plain()
        err = float((a.double() - b.double()).abs().max())
        scale = float(b.double().abs().max())
        ok = (err <= FOLD_RTOL["float32"] * scale if name == "route_fold"
              else _same(a, b))
        if not ok:
            raise AssertionError(f"{name} at RMAT-{SCALE} shapes: max "
                                 f"|diff| {err} (max |plain| {scale})")
        _time_row(torch, rows, name, kern, plain, err, launches[name])
    return list(rows.values())


def _time_row(torch, rows, name, kern, plain, err, launches) -> None:
    """Add one call's kernel and plain times (CUDA events, in turns:
    plain, kernel, kernel, plain) to the kernels-line row ``name``."""
    p1 = _ms(plain, torch, 3)
    k1 = _ms(kern, torch, 10)
    k2 = _ms(kern, torch, 10)
    p2 = _ms(plain, torch, 3)
    row = rows.setdefault(name, {
        "name": name, "route": "cuda", "source": SOURCE,
        "replaces": REPLACES[name], "launches": launches,
        "max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0})
    row["max_abs_err"] = max(row["max_abs_err"], err)
    row["ms"] += (k1 + k2) / 2
    row["plain_ms"] += (p1 + p2) / 2
    log(f"kernel {name}: {(k1 + k2) / 2:.4f} ms vs plain "
        f"{(p1 + p2) / 2:.4f} ms, max |diff| {err!r}")


def _need_launches(path, launches, need) -> None:
    """Fail unless each kernel (or tuple of kernels, summed) of ``need``
    was launched at least that many times on the path."""
    for k, v in need.items():
        got = sum(launches[n] for n in ((k,) if isinstance(k, str) else k))
        if got < v:
            raise AssertionError(f"{path}: {k} launched {got} < {v} times")


def _log_supersteps(path, ex) -> None:
    for i, s in enumerate(ex.supersteps):
        log(f"{path}: superstep {i} "
            f"{'gated' if s['gated'] else 'static'} {s['ms']:.4f} ms")


def phase_bfs(torch, np):
    """BFS on RMAT-FRONTIER_SCALE to convergence; returns the gated
    kernels' rows of the kernels line."""
    from graphtap_tpu_torch import Graph
    from graphtap_tpu_torch.apps import bfs_config, run_bfs
    from graphtap_tpu_torch.ingest import rmat_edges
    from graphtap_tpu_torch.kernels import panel_kernels as pk
    from graphtap_tpu_torch.kernels.panel_engine import spmv3_stages
    t0 = time.perf_counter()
    r, c, _ = rmat_edges(FRONTIER_SCALE, EDGE_FACTOR, seed=SEED)
    n = 1 << FRONTIER_SCALE
    g = Graph.from_edges(r, c, None, bfs_config(n))
    log(f"bfs: edges RMAT-{FRONTIER_SCALE} E={r.size} (mirrored, no "
        f"self-loops: {g.nedges}) in {time.perf_counter() - t0:.1f} s")
    pk.reset_launches()
    t0 = time.perf_counter()
    ex = run_bfs(g, 0, kernel="panel", device=DEVICE)
    wall = time.perf_counter() - t0
    launches = dict(pk.LAUNCHES)
    tm = ex.timings
    log(f"bfs: tiles {tm['tiles']:.1f} s, plans {tm['plans']:.1f} s, "
        f"upload {tm['upload']:.2f} s; run_bfs wall {wall:.1f} s, "
        f"{ex.iteration} iterations in {tm['execute']:.4f} s (first)")
    log(f"bfs: launches {launches}")
    _log_supersteps("bfs", ex)
    _need_launches("bfs", launches, {**{k: 1 for k in GATED},
                                     "hub_fold": ex.iteration,
                                     "route_fold": ex.iteration})
    t0 = time.perf_counter()
    parent, hops = _golden().bfs(r.astype(np.int64), c.astype(np.int64),
                                 n + 1, 0)
    sv = ex.state_vector()
    ok = (np.array_equal(sv["hops"], hops)
          and np.array_equal(sv["parent"], parent))
    log(f"bfs: hops and parents vs golden.bfs "
        f"{'equal' if ok else 'DIFFER'} (golden {time.perf_counter() - t0:.1f}"
        f" s); checksum {ex.checksum()}")
    if not ok:
        raise AssertionError("BFS hops/parents differ from golden.bfs")
    nnz = ex.tiles.nnz_total
    ex.initialize()                      # warm re-run, as bench_suite.py
    iters = ex.execute(0)
    warm = ex.timings["execute"]
    if not np.array_equal(ex.state_vector()["hops"], hops):
        raise AssertionError("BFS warm re-run differs from golden.bfs")
    log(f"bfs: warm re-run {iters} iterations in {warm:.4f} s, "
        f"{nnz * iters / warm / 1e9:.4f} GTEPS (nnz x iterations / s), "
        f"nnz {nnz}")
    _log_supersteps("bfs warm", ex)
    # the gated kernels at the shapes of BFS's first superstep
    ex.initialize()
    x = ex._messages(ex.state, ex.changed)
    st = spmv3_stages(x, ex._dev, ex.meta, ex.program.semiring,
                      ex.part.tile_rows, gate=True)
    rows = {}
    for name, kern, plain in _gated_calls(ex._dev, ex.meta,
                                          ex.program.semiring, st,
                                          st["maps"]):
        a, b = kern(), plain()
        if not _same(a, b):
            raise AssertionError(f"{name} at the BFS shapes disagrees with "
                                 f"its plain version")
        err = float((a.double() - b.double()).abs().max())
        _time_row(torch, rows, name, kern, plain, err, launches[name])
    ex.free()
    return list(rows.values())


def phase_cc_sssp(torch, np) -> None:
    from graphtap_tpu_torch import Graph
    from graphtap_tpu_torch.apps import (cc_config, run_cc, run_sssp,
                                         sssp_config)
    from graphtap_tpu_torch.ingest import rmat_edges
    from graphtap_tpu_torch.kernels import panel_kernels as pk
    golden = _golden()
    n = 1 << SUITE_SCALE
    for app in ("cc", "sssp"):
        t0 = time.perf_counter()
        weighted = app == "sssp"
        r, c, w = rmat_edges(SUITE_SCALE, EDGE_FACTOR, seed=SEED,
                             weighted=weighted)
        cfg = sssp_config(n) if weighted else cc_config(n)
        g = Graph.from_edges(r, c, w, cfg)
        edges_s = time.perf_counter() - t0
        pk.reset_launches()
        t0 = time.perf_counter()
        ex = (run_sssp(g, 0, kernel="panel", device=DEVICE) if weighted
              else run_cc(g, kernel="panel", device=DEVICE))
        wall = time.perf_counter() - t0
        launches = dict(pk.LAUNCHES)
        _need_launches(app, launches, {
            "hub_fold": ex.iteration, "route_fold": ex.iteration,
            ("route_xr_exp", "route_xr_exp_gated"): ex.iteration,
            ("route_passa", "route_passa_gated"): ex.iteration})
        tm = ex.timings
        log(f"{app}: RMAT-{SUITE_SCALE} edges {edges_s:.1f} s, tiles "
            f"{tm['tiles']:.1f} s, plans {tm['plans']:.1f} s, upload "
            f"{tm['upload']:.2f} s; {ex.iteration} iterations in "
            f"{tm['execute']:.4f} s (first), wall {wall:.1f} s")
        log(f"{app}: launches {launches}")
        _log_supersteps(app, ex)
        t0 = time.perf_counter()
        r64, c64 = r.astype(np.int64), c.astype(np.int64)
        if weighted:
            want = golden.sssp(r64, c64, w.astype(np.int64), n + 1, 0)
            got = ex.state_vector()["distance"]
        else:
            want = golden.cc(r64, c64, n + 1)
            got = ex.state_vector()["label"]
        ok = np.array_equal(got, want)
        log(f"{app}: state vs golden.{app} {'equal' if ok else 'DIFFER'} "
            f"(golden {time.perf_counter() - t0:.1f} s); checksum "
            f"{ex.checksum()}")
        if not ok:
            raise AssertionError(f"{app} differs from golden.{app}")
        nnz = ex.tiles.nnz_total
        ex.initialize()
        iters = ex.execute(0)
        warm = ex.timings["execute"]
        log(f"{app}: warm re-run {iters} iterations in {warm:.4f} s, "
            f"{nnz * iters / warm / 1e9:.4f} GTEPS, nnz {nnz}")
        ex.free()


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    import numpy as np
    sys.path.insert(0, ROOT)
    phase_device(torch)
    phase_build()
    phase_parity(torch, np)
    phase_gated_parity(torch, np)
    ex, launches = phase_main(torch, np)
    kernels = phase_kernels(torch, ex, launches)
    ex.free()
    del ex
    kernels += phase_bfs(torch, np)
    phase_cc_sssp(torch, np)
    log("ms per superstep; route_fold sums its fixr and fix2 calls; the "
        f"gated rows are timed at BFS's first superstep "
        f"(RMAT-{FRONTIER_SCALE})")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
