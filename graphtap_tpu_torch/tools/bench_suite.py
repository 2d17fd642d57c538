"""The benchmark suite's rows on the port: seconds to convergence, PageRank
at a larger scale, and the mesh's exchange bytes.

Counterpart of the rows the JAX package's ``bench_suite.py::main`` writes
(its ``scaling_table`` is not called there, and is not ported):

* ``comm_model_row``: PageRank, 5 iterations on the scan kernel, on
  RMAT-17 at mesh shapes 1x8, 2x4 and 8x1, eight ``torch.distributed``
  ranks of one launch (``parallel/launch.py``; gloo, so on one card the
  ranks time-share it and stage every exchange through host memory).
  Per shape: the timed run's seconds (rank 0's wall, every rank starting
  at a barrier), L, the bytes each collective of a superstep moved on a
  rank as the executor counts them (``Executor.exchange_bytes``:
  [sent, received]), and the JAX row's formula ((R-1)*L + (C-1)*L)*4; a
  rank or superstep whose count differs from the formula raises.
  ``value`` is the spread of the seconds across the shapes.
* ``nonstationary_apps``: BFS (root 0), CC and weighted SSSP (root 0) at
  ``--scale``, each through its own config, to convergence on
  ``--kernel``: a warm-up run, then one timed run; gated on
  ``tests/golden.py`` as the JAX suite gates them (reachable equal, the
  checksum equal or within 1e-6 relative), the golden memoized. Tiles and
  plans are cached keyed on the config's hash, so CC runs on its own
  (self-loop keeping) tiles, not on BFS's.
* ``pagerank_large``: ``tools/bench.py`` in a fresh process at
  ``--pr-scale`` for SUITE_PR_ITERS (default 5) iterations, its kernel
  the child's default (BENCH_KERNEL, else panel); the row is iterations
  per second of its median run, with the child's detail and GTEPS. A
  child that fails fails the suite, with its last stderr lines.

    python -m graphtap_tpu_torch.tools.bench_suite [--scale 18]
        [--pr-scale 22] [--kernel panel] [--device cuda] [--cache DIR]
        [--out PATH] [--skip-comm]

Each row is one JSON object a line, printed and appended to ``--out``
(default ``graphtap_tpu_torch/build/bench_suite.jsonl``); a row whose
metric is already in the file is skipped. The defaults also come from
SUITE_SCALE, SUITE_PR_SCALE, SUITE_KERNEL and SUITE_SKIP_SCALING.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from typing import Callable, Dict, List

import numpy as np
import torch

from graphtap_tpu_torch.apps.bfs import BFSProgram, bfs_config
from graphtap_tpu_torch.apps.cc import CCProgram, cc_config
from graphtap_tpu_torch.apps.sssp import SSSPProgram, sssp_config
from graphtap_tpu_torch.config import EngineConfig, Ordering
from graphtap_tpu_torch.engine.executor import KERNELS, Executor, _device
from graphtap_tpu_torch.engine.program import numpy_dtype
from graphtap_tpu_torch.ingest.graph import Graph
from graphtap_tpu_torch.tools import artifact_cache as ac
from graphtap_tpu_torch.tools import bench
from graphtap_tpu_torch.tools.bench import EDGE_FACTOR, SEED, GateFailed

OUT = os.path.join(bench.PKG, "build", "bench_suite.jsonl")
CHECKSUM_RTOL = 1e-6
PR_TIMEOUT = 3300.0
COMM_SCALE, COMM_ITERS = 17, 5
COMM_SHAPES = ((1, 8), (2, 4), (8, 1))
COMM_TIMEOUT = 900.0
# name -> (config, weighted, program, engine flags), bench_suite.py:129-136
APPS = {
    "bfs": (bfs_config, False, lambda: BFSProgram(root=0),
            dict(stationary=False, apply_depends_on_iter=True)),
    "cc": (cc_config, False, CCProgram,
           dict(stationary=False, gather_depends_on_apply=True)),
    "sssp": (sssp_config, True, lambda: SSSPProgram(root=0),
             dict(stationary=False, gather_depends_on_apply=True)),
}


def emit(fh, rec: Dict) -> None:
    line = json.dumps(rec)
    print(line, flush=True)
    fh.write(line + "\n")
    fh.flush()


def recorded(path: str) -> set:
    """The metrics already in the rows file ``path``."""
    if not os.path.exists(path):
        return set()
    with open(path) as f:
        return {json.loads(ln)["metric"] for ln in f if ln.strip()}


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def golden_nonstationary(name: str, scale: int, cache: str):
    """The golden (checksum, reachable) of ``name`` on RMAT-``scale``,
    derived as the JAX suite's ``_golden_nonstationary`` derives it and
    memoized in ``cache``."""
    gp = os.path.join(cache, f"golden_{name}_rmat{scale}_ef{EDGE_FACTOR}_"
                      f"s{SEED}.txt")
    if os.path.exists(gp):
        with open(gp) as f:
            cs, reach = f.read().split()
        return float(cs), int(reach)
    golden = bench.golden_module()
    nv = (1 << scale) + 1
    s, d, w = ac.cached_rmat(scale, EDGE_FACTOR, SEED, cache,
                             weighted=name == "sssp")
    s, d = s.astype(np.int64), d.astype(np.int64)
    if name == "sssp":
        dist = golden.sssp(s, d, w.astype(np.int64), nv, 0)
        m = dist != golden.INF
        cs, reach = float(dist[m].sum()), int(m.sum())
    elif name == "bfs":
        _, hops = golden.bfs(s, d, nv, 0)
        m = hops != golden.INF
        cs, reach = float(hops[m].sum()), int(m.sum())
    else:
        lab = golden.cc(s, d, nv)
        cs, reach = float(lab.sum()), int(lab.size)
    with open(gp, "w") as f:
        f.write(f"{cs!r} {reach}")
    return cs, reach


def _card_fields() -> Dict:
    info = bench.card()
    return {"name": info["name"], "power_limit": info["power_limit"]}


def app_row(name: str, scale: int, kernel: str, device, cache: str,
            log: Callable = bench._log) -> Dict:
    """One ``nonstationary_apps`` row: ``name`` to convergence, warm,
    gated on the golden model (``GateFailed`` on a miss)."""
    cfg_fn, weighted, program, flags = APPS[name]
    dev = _device(device)
    t0 = time.perf_counter()
    src, dst, w = ac.cached_rmat(scale, EDGE_FACTOR, SEED, cache,
                                 weighted=weighted)
    g = Graph.from_edges(src, dst, w, cfg_fn(1 << scale))
    prog = program()
    tiles, plans, secs = bench.artifacts(g, scale, Ordering.ROW, kernel,
                                         numpy_dtype(prog.value_dtype),
                                         cache, log)
    ex = Executor(g, prog, EngineConfig(ordering=Ordering.ROW, **flags),
                  kernel=kernel, plans=plans, device=dev, tiles=tiles)
    log(f"[suite] {name}: " + ex.tiles.balance_report())
    ex.initialize()
    build_s = time.perf_counter() - t0
    t_w = time.perf_counter()
    ex.execute(0)
    warmup_s = time.perf_counter() - t_w
    ex.initialize()
    _sync(dev)
    t1 = time.perf_counter()
    iters = ex.execute(0)
    _sync(dev)
    dt = time.perf_counter() - t1
    cs, reach = ex.checksum()
    gcs, greach = golden_nonstationary(name, scale, cache)
    if not (reach == greach and (cs == gcs or abs(cs - gcs)
                                 <= CHECKSUM_RTOL * max(abs(gcs), 1.0))):
        raise GateFailed(f"{name}: checksum {cs}/{reach} != golden "
                         f"{gcs}/{greach}")
    log(f"[suite] {name}: {iters} iterations in {dt:.4f} s, checksum "
        f"{cs:.0f}/{reach} equal to the golden")
    nnz = ex.tiles.nnz_total
    return {"metric": f"{name}_seconds_rmat{scale}", "value": dt, "unit": "s",
            "detail": {
                "iterations": iters, "edges": int(nnz),
                "gteps": nnz * iters / dt / 1e9, "checksum": cs,
                "reachable": reach, "kernel": kernel,
                "build_seconds": build_s,
                "upload_seconds": ex.timings["upload"],
                "warmup_seconds": warmup_s,
                "imbalance": ex.tiles.edge_balance()["imbalance"],
                "gated": [s["gated"] for s in ex.supersteps],
                "artifact_seconds": secs,
                "device": str(dev), **_card_fields()}}


def nonstationary_apps(fh, scale: int, kernel: str, device, cache: str,
                       done: set, log: Callable = bench._log) -> None:
    for name in APPS:
        if f"{name}_seconds_rmat{scale}" in done:
            log(f"[suite] {name}: already recorded, skipping")
            continue
        emit(fh, app_row(name, scale, kernel, device, cache, log))


def pagerank_large(fh, pr_scale: int, iters: int, device, cache: str,
                   done: set, log: Callable = bench._log) -> None:
    """``tools/bench.py`` at ``pr_scale`` in a fresh process -> the
    iterations-per-second row; a child that fails raises."""
    metric = f"pagerank_iters_per_sec_rmat{pr_scale}"
    if metric in done:
        log("[suite] pagerank_large: already recorded, skipping")
        return
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (bench.ROOT, os.environ.get("PYTHONPATH")) if p))
    out = subprocess.run(
        [sys.executable, "-m", "graphtap_tpu_torch.tools.bench", "--scale",
         str(pr_scale), "--iters", str(iters), "--device", str(device),
         "--cache", cache],
        capture_output=True, text=True, env=env, cwd=bench.ROOT,
        timeout=PR_TIMEOUT)
    for ln in out.stderr.splitlines():
        log(f"[suite] pagerank_large: {ln}")
    if out.returncode != 0:
        tail = "\n".join(out.stderr.splitlines()[-20:])
        raise RuntimeError(f"pagerank_large: tools/bench.py at RMAT-"
                           f"{pr_scale} exited {out.returncode}:\n{tail}")
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    d = rec["detail"]
    emit(fh, {"metric": metric, "value": d["iters"] / d["seconds"],
              "unit": "iters/s", "detail": {**d, "gteps": rec["value"]}})


def _rank_main(spec_path: str) -> int:
    """One rank of ``comm_model`` (started through the launcher): at each
    mesh shape, load this rank's byte range, run the degree phase and
    time PageRank on scan; rank 0 writes ``rows.json`` to the spec's
    ``out``."""
    import torch.distributed as dist
    from graphtap_tpu_torch.apps.degree import run_degree
    from graphtap_tpu_torch.apps.pagerank import PageRankProgram
    from graphtap_tpu_torch.parallel import multihost as mh
    from graphtap_tpu_torch.parallel.layout import make_mesh

    with open(spec_path) as f:
        spec = json.load(f)
    dev = _device(spec["device"])
    rank, _ = mh.initialize(backend="gloo")
    rows, iters = [], spec["iters"]
    for R, C in spec["shapes"]:
        mesh = make_mesh((R, C))
        g = Graph.load(spec["path"], bench.graph_config(spec["scale"]),
                       mesh=mesh)
        deg = run_degree(g, torch.float32, Ordering.COL, "scan", dev)
        pr = Executor(g, PageRankProgram(torch.float32),
                      EngineConfig(stationary=True, ordering=Ordering.ROW),
                      kernel="scan", device=dev)
        pr.initialize(other=deg)
        pr.execute(iters)                      # warm-up
        pr.initialize(other=deg)
        _sync(dev)
        mh.barrier(mesh)
        t0 = time.perf_counter()
        pr.execute(iters)
        _sync(dev)
        dt = time.perf_counter() - t0
        counted = [s["bytes"] for s in pr.supersteps]
        every = [None] * mesh.D
        dist.all_gather_object(every, counted, group=mesh.host_group)
        cs, reach = pr.checksum()
        L = pr.part.L
        rows.append({"R": R, "C": C, "seconds": dt, "L": L,
                     "formula_bytes_per_dev_iter": ((R - 1) * L
                                                    + (C - 1) * L) * 4,
                     "exchange_bytes": every, "checksum": cs,
                     "reachable": reach})
        print(f"[suite] rank {rank}: {R}x{C} {dt:.4f} s, bytes "
              f"{counted[0]}", flush=True)
    if rank == 0:
        with open(os.path.join(spec["out"], "rows.json"), "w") as f:
            json.dump(rows, f)
    mh.barrier(mesh)
    return 0


def comm_model(scale: int = COMM_SCALE, shapes=COMM_SHAPES, device="cuda",
               cache: str = bench.CACHE, log: Callable = bench._log) -> Dict:
    """The ``comm_model_row`` record: PageRank at each of ``shapes`` (one
    launch of R*C ranks); raises ``GateFailed`` when a rank's counted
    bytes of a superstep differ from the formula."""
    from graphtap_tpu_torch.parallel.launch import launch
    dev = _device(device)
    nranks = {R * C for R, C in shapes}
    if len(nranks) != 1:
        raise ValueError(f"shapes {shapes}: one rank count for all")
    nranks = nranks.pop()
    ac.cached_rmat(scale, EDGE_FACTOR, SEED, cache)
    with tempfile.TemporaryDirectory(prefix="graphtap_comm_") as tmp:
        spec = {"path": os.path.join(
                    cache, f"rmat{scale}_ef{EDGE_FACTOR}_s{SEED}.bin"),
                "scale": scale, "device": str(dev), "iters": COMM_ITERS,
                "shapes": [list(s) for s in shapes], "out": tmp}
        path = os.path.join(tmp, "spec.json")
        with open(path, "w") as f:
            json.dump(spec, f)
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            p for p in (bench.ROOT, os.environ.get("PYTHONPATH")) if p))
        launch([sys.executable, "-m", "graphtap_tpu_torch.tools.bench_suite",
                "--rank", path], nranks, COMM_TIMEOUT, env=env,
               cwd=bench.ROOT)
        with open(os.path.join(tmp, "rows.json")) as f:
            rows: List[Dict] = json.load(f)
    for row in rows:
        want = row["formula_bytes_per_dev_iter"]
        got = {sum(b[1] for b in step.values())
               for rank in row["exchange_bytes"] for step in rank}
        if got != {want}:
            raise GateFailed(f"{row['R']}x{row['C']}: counted bytes a "
                             f"superstep {sorted(got)} != formula {want}")
        row["counted_bytes_per_dev_iter"] = want
        row["exchange_bytes"] = row["exchange_bytes"][0][0]
        log(f"[suite] comm_model {row['R']}x{row['C']}: "
            f"{row['seconds']:.4f} s, L {row['L']}, bytes "
            f"{row['exchange_bytes']} = formula {want}")
    secs = [r["seconds"] for r in rows]
    card = _card_fields()
    transport = (f"{nranks} gloo ranks on one card, every exchange staged "
                 f"through host memory; {card['name']}, "
                 f"{card['power_limit']}" if dev.type == "cuda"
                 else f"{nranks} gloo ranks on the CPU")
    return {"metric": f"comm_model_{nranks}dev_rmat{scale}",
            "value": (max(secs) - min(secs)) / max(secs),
            "unit": "mesh-shape time spread (0 = invariant)",
            "detail": {
                "rows": rows, "mesh": transport, **card,
                "note": (
                    "exchange_bytes: per collective of one superstep, "
                    "[sent, received] by one rank, counted by the executor "
                    "from the tensors it hands each collective (its part "
                    "to, and as many bytes from, each other member of the "
                    "group); the x all-gather runs over the mesh column "
                    "(R members) and the partial-y all-to-all over the "
                    "mesh row (C members), so the received bytes are the "
                    "formula (R-1)*L*4 + (C-1)*L*4 at every shape, 1x8 "
                    "(no x bytes) and 8x1 (no y bytes) included, on every "
                    "rank and superstep. The JAX row read output shapes "
                    "from the compiled HLO instead, which differ from the "
                    "formula on 1x8 and 8x1. value: the spread of the "
                    "seconds across the shapes at fixed total work; the "
                    f"ranks share {'one card' if dev.type == 'cuda' else 'the host CPU'} "
                    "here, as the JAX row's eight virtual CPU devices "
                    "shared one host, so it measures the time-sharing and "
                    "the transport, not multi-device scaling")}}


def main(argv=None) -> int:
    env = os.environ
    p = argparse.ArgumentParser(prog="graphtap_tpu_torch.tools.bench_suite")
    p.add_argument("--scale", type=int,
                   default=int(env.get("SUITE_SCALE", "18")))
    p.add_argument("--pr-scale", type=int,
                   default=int(env.get("SUITE_PR_SCALE", "22")))
    p.add_argument("--kernel", default=env.get("SUITE_KERNEL") or "panel",
                   choices=KERNELS)
    p.add_argument("--device", default="cuda")
    p.add_argument("--cache", default=bench.CACHE)
    p.add_argument("--out", default=OUT)
    p.add_argument("--skip-comm", action="store_true",
                   default=bool(env.get("SUITE_SKIP_SCALING")))
    p.add_argument("--rank", default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.rank is not None:
        return _rank_main(args.rank)
    _device(args.device)
    os.makedirs(args.cache, exist_ok=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    done = recorded(args.out)
    with open(args.out, "a") as fh:
        R, C = COMM_SHAPES[0]
        comm = f"comm_model_{R * C}dev_rmat{COMM_SCALE}"
        if not args.skip_comm and comm not in done:
            emit(fh, comm_model(device=args.device, cache=args.cache))
        nonstationary_apps(fh, args.scale, args.kernel, args.device,
                           args.cache, done)
        pagerank_large(fh, args.pr_scale,
                       int(env.get("SUITE_PR_ITERS", "5")), args.device,
                       args.cache, done)
    return 0


if __name__ == "__main__":
    sys.exit(main())
