"""PageRank GTEPS on an RMAT graph, one device: the port's benchmark.

Counterpart of the JAX package's ``bench.py``, step for step:

1. RMAT-``scale`` edges (edge factor 16, seed 1; ``cached_rmat``) read
   through ``GraphConfig(2**scale, directed=True, transpose=True,
   compression=TCSC)``.
2. COL tiles for the degree phase and ROW tiles for PageRank, each with
   its kernel's plans (``cached_spmv3_meta``, ``cached_shuffle_plans``,
   ``cached_spmv2_meta``), all cached in ``--cache`` and keyed on the
   config's hash (``tiles_path``; the plans by ``artifact_cache.meta_key``).
3. The degree phase: one SpMV on the COL ordering on ``degree_kernel``'s
   kernel, then ``free()`` before the PageRank upload.
4. PageRank on the ROW ordering: one warm-up ``execute(iters)``, then
   ``--runs`` timed runs, each ``initialize(other=degree)`` and
   ``execute(iters)`` between two device synchronizes; beside them one
   superstep's device-only ms (``tools/timing.py::device_ms``).
5. The gate: the checksum within 1e-4 relative of the f64 golden model
   (``tests/golden.py::pagerank``, its sum memoized in the cache). A miss
   raises ``GateFailed``, and no JSON line is printed.
6. One JSON line on stdout: ``metric`` pagerank_gteps_rmat<scale>,
   ``value`` the GTEPS of the median run (stored edges x iters / its
   seconds; the lower middle run for an even count), ``unit``, and
   ``detail`` (the JAX bench's keys, then every run's seconds and their
   GTEPS range, the device-only superstep, the device bytes and memory
   around the degree phase's ``free()``, the artifacts' seconds, the host
   RSS, the launches, the card and the versions). The JAX bench's
   ``vs_baseline`` is left out: its divisor is a CPU rate measured on
   the TPU host.

    python -m graphtap_tpu_torch.tools.bench [--scale 20] [--iters 20]
        [--kernel panel] [--runs 5] [--device cuda] [--cache DIR]

``--scale``, ``--iters`` and ``--kernel`` default to BENCH_SCALE,
BENCH_ITERS and BENCH_KERNEL where those are set, as the JAX bench
reads them. Progress goes to stderr.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import resource
import shutil
import subprocess
import sys
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from graphtap_tpu_torch.apps.degree import DegreeProgram
from graphtap_tpu_torch.apps.pagerank import PageRankProgram
from graphtap_tpu_torch.config import (Compression, EngineConfig,
                                       GraphConfig, Ordering)
from graphtap_tpu_torch.engine.executor import KERNELS, Executor, _device
from graphtap_tpu_torch.ingest.graph import Graph
from graphtap_tpu_torch.tools import artifact_cache as ac
from graphtap_tpu_torch.tools.timing import device_ms, launches

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(PKG)
CACHE = os.path.join(PKG, "build", "bench")
EDGE_FACTOR, SEED = 16, 1
MIN_RUNS = 5
GOLDEN_RTOL = 1e-4
# the kernels whose plans are cached: their cache kind and reader
PLANNED = {"panel": ("spmv3", ac.cached_spmv3_meta),
           "shuffle": ("shuffle", ac.cached_shuffle_plans),
           "shuffle2": ("spmv2", ac.cached_spmv2_meta)}


class GateFailed(RuntimeError):
    """A result differs from its golden model beyond the gate."""


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def degree_kernel(kernel: str, scale: int) -> str:
    """The degree phase's kernel for a PageRank ``kernel`` (the JAX
    bench's rule, its bench.py:128-134): the v1 shuffle for panel and
    shuffle2, which plans in seconds, but scan from RMAT-21 on, where the
    shuffle plans (~8.7 GB at RMAT-22) would not fit beside the PageRank
    plans on a 16 GB TPU; any other kernel runs both phases."""
    if kernel in ("panel", "shuffle2"):
        return "scan" if scale >= 21 else "shuffle"
    return kernel


def graph_config(scale: int) -> GraphConfig:
    return GraphConfig(num_vertices=1 << scale, directed=True,
                       transpose=True, compression=Compression.TCSC)


def tiles_path(cache: str, scale: int, config: GraphConfig,
               ordering: Ordering) -> str:
    """The tile file of RMAT-``scale`` read through ``config``, keyed on
    every field of it (one edge list read through two configs gives two
    tile sets)."""
    return os.path.join(cache, f"tiles_rmat{scale}_ef{EDGE_FACTOR}_s{SEED}_"
                        f"cfg{ac.config_hash(config)}_{ordering.value}_1x1"
                        f".npz")


def plans_path(cache: str, tiles, scale: int, config: GraphConfig,
               ordering: Ordering, kernel: str, value_dtype) -> str:
    """Where ``artifact_cache`` keeps ``kernel``'s plans of ``tiles``."""
    return os.path.join(cache, ac.meta_key(
        scale, EDGE_FACTOR, SEED, config, ordering, value_dtype,
        tiles.weights is not None, PLANNED[kernel][0]) + ".npz")


def artifacts(g: Graph, scale: int, ordering: Ordering, kernel: str,
              value_dtype, cache: str, log: Callable = _log):
    """(tiles, plans or None, seconds) of ``g`` in ``ordering`` for
    ``kernel``, each read from ``cache`` when there, else built and
    written there; ``seconds``: {"tiles", "plans"} of this call (a
    build, or a read) and whether each was read (``*_cached``)."""
    secs = {}
    tp = tiles_path(cache, scale, g.config, ordering)
    secs["tiles_cached"] = os.path.exists(tp)
    t0 = time.perf_counter()
    if secs["tiles_cached"]:
        tiles = ac.load_tileset(tp)
    else:
        tiles = g.tiled(ordering)
        os.makedirs(cache, exist_ok=True)
        ac.save_tileset(tiles, tp)
    secs["tiles"] = time.perf_counter() - t0
    plans = None
    if kernel in PLANNED:
        secs["plans_cached"] = os.path.exists(plans_path(
            cache, tiles, scale, g.config, ordering, kernel, value_dtype))
        t0 = time.perf_counter()
        plans = PLANNED[kernel][1](tiles, scale, EDGE_FACTOR, SEED,
                                   g.config, ordering, value_dtype,
                                   cache_dir=cache)
        secs["plans"] = time.perf_counter() - t0
    how = {True: "read", False: "built"}
    log(f"[bench] {ordering.value} tiles {how[secs['tiles_cached']]} in "
        f"{secs['tiles']:.1f} s"
        + (f", {kernel} plans {how[secs['plans_cached']]} in "
           f"{secs['plans']:.1f} s" if plans is not None else ""))
    return tiles, plans, secs


def golden_module():
    """``tests/golden.py``, the NumPy golden models (loaded by path)."""
    spec = importlib.util.spec_from_file_location(
        "golden", os.path.join(ROOT, "tests", "golden.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def golden_path(cache: str, scale: int, iters: int) -> str:
    return os.path.join(cache, f"golden_rmat{scale}_ef{EDGE_FACTOR}_s{SEED}"
                        f"_i{iters}.txt")


def golden_sum(src, dst, scale: int, iters: int, cache: str) -> float:
    """The sum of the f64 golden PageRank (``golden.pagerank(src, dst,
    2**scale + 1, iters)``), memoized in ``cache``."""
    gp = golden_path(cache, scale, iters)
    if os.path.exists(gp):
        with open(gp) as f:
            return float(f.read())
    v = golden_module().pagerank(src.astype(np.int64), dst.astype(np.int64),
                                 (1 << scale) + 1, iters)
    total = float(v.sum())
    with open(gp, "w") as f:
        f.write(repr(total))
    return total


def card() -> Dict:
    """The card's name and power limit (nvidia-smi) and the torch, CUDA
    and nvcc versions; the card's fields None without one."""
    info = {"name": None, "power_limit": None, "torch": torch.__version__,
            "cuda": torch.version.cuda, "nvcc": None}
    if torch.cuda.is_available():
        from graphtap_tpu_torch.tools.bw_probe import card as smi
        info["name"], info["power_limit"] = (
            s.strip() for s in smi().split(",", 1))
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if os.path.exists(nvcc):
        info["nvcc"] = subprocess.run(
            [nvcc, "--version"], capture_output=True, text=True, timeout=60,
            check=True).stdout.strip().splitlines()[-1]
    return info


def _since(counted: Dict[str, int]) -> Dict[str, int]:
    """The launches made since ``launches()`` gave ``counted`` (the
    counters are the caller's too, so they are never reset here)."""
    return {k: n - counted.get(k, 0) for k, n in launches().items()
            if n > counted.get(k, 0)}


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _allocated(dev: torch.device) -> Optional[int]:
    return torch.cuda.memory_allocated(dev) if dev.type == "cuda" else None


def run(scale: int = 20, iters: int = 20, kernel: str = "panel",
        runs: int = MIN_RUNS, device="cuda", cache: str = CACHE,
        log: Callable = _log) -> Dict:
    """The benchmark (the module docstring's steps 1-5) -> its JSON
    record. Raises ``GateFailed`` when the checksum misses the golden."""
    if kernel not in KERNELS:
        raise ValueError(f"unknown kernel {kernel!r}; use one of {KERNELS}")
    if runs < MIN_RUNS:
        raise ValueError(f"runs={runs}: the median needs at least "
                         f"{MIN_RUNS} timed runs")
    dev = _device(device)
    t_start = time.perf_counter()
    src, dst, _ = ac.cached_rmat(scale, EDGE_FACTOR, SEED, cache)
    artifact_s = {"edges": time.perf_counter() - t_start}
    log(f"[bench] edges RMAT-{scale} E={src.size} "
        f"({artifact_s['edges']:.1f} s)")
    g = Graph.from_edges(src, dst, None, graph_config(scale))
    dk = degree_kernel(kernel, scale)
    tiles_col, plans_col, s_col = artifacts(g, scale, Ordering.COL, dk,
                                            np.float32, cache, log)
    tiles_row, plans_row, s_row = artifacts(g, scale, Ordering.ROW, kernel,
                                            np.float32, cache, log)
    artifact_s.update({f"{k}_COL": v for k, v in s_col.items()})
    artifact_s.update({f"{k}_ROW": v for k, v in s_row.items()})

    counted = launches()
    deg = Executor(g, DegreeProgram(torch.float32),
                   EngineConfig(stationary=True, ordering=Ordering.COL),
                   kernel=dk, plans=plans_col, device=dev, tiles=tiles_col)
    deg.initialize()
    deg.execute(1)
    degree_bytes = deg.device_bytes
    degree_launches = _since(counted)
    before_free = _allocated(dev)
    deg.free()
    after_free = _allocated(dev)
    log(f"[bench] degree phase on {dk}: {degree_bytes} device bytes, "
        f"{deg.timings['execute'] * 1e3:.3f} ms; allocated {before_free} "
        f"-> {after_free} bytes across free()")

    pr = Executor(g, PageRankProgram(torch.float32),
                  EngineConfig(stationary=True, ordering=Ordering.ROW),
                  kernel=kernel, plans=plans_row, device=dev,
                  tiles=tiles_row)
    upload_s = deg.timings["upload"] + pr.timings["upload"]
    nnz = pr.tiles.nnz_total
    pr.initialize(other=deg)
    t0 = time.perf_counter()
    pr.execute(iters)
    _sync(dev)
    warmup_s = time.perf_counter() - t0
    log(f"[bench] warm-up {iters} iterations {warmup_s:.4f} s")

    counted = launches()
    secs = []
    for _ in range(runs):
        pr.initialize(other=deg)
        _sync(dev)
        t0 = time.perf_counter()
        pr.execute(iters)
        _sync(dev)
        secs.append(time.perf_counter() - t0)
    run_launches = _since(counted)
    rates = [nnz * iters / s / 1e9 for s in secs]
    median_s = sorted(secs)[(runs - 1) // 2]
    gteps = nnz * iters / median_s / 1e9
    log(f"[bench] {runs} runs of {iters} iterations: "
        + ", ".join(f"{s:.4f} s ({r:.4f})" for s, r in zip(secs, rates))
        + f"; median {gteps:.4f} GTEPS")

    step_ms = device_ms(pr.step_call(), 10, log) \
        if dev.type == "cuda" else None

    checksum, _ = pr.checksum()
    gsum = golden_sum(src, dst, scale, iters, cache)
    rel = abs(checksum - gsum) / abs(gsum)
    if not rel < GOLDEN_RTOL:
        raise GateFailed(f"checksum {checksum!r} vs golden {gsum!r}: "
                         f"relative error {rel:.3e} >= {GOLDEN_RTOL}")
    log(f"[bench] checksum {checksum!r} vs f64 golden {gsum!r} "
        f"(rel {rel:.3e})")
    return {
        "metric": f"pagerank_gteps_rmat{scale}",
        "value": gteps,
        "unit": "GTEPS",
        "detail": {
            "edges": int(nnz), "iters": iters, "seconds": median_s,
            "checksum": checksum, "kernel": kernel, "devices": 1,
            "warmup_seconds": warmup_s, "upload_seconds": upload_s,
            "runs_seconds": secs, "gteps_range": [min(rates), max(rates)],
            "device_superstep_ms": step_ms,
            "device_bytes": pr.device_bytes,
            "degree_kernel": dk, "degree_device_bytes": degree_bytes,
            "allocated_before_free": before_free,
            "allocated_after_free": after_free,
            "golden": gsum, "golden_rel_err": rel,
            "artifact_seconds": artifact_s,
            "host_max_rss_bytes": resource.getrusage(
                resource.RUSAGE_SELF).ru_maxrss * 1024,
            "launches": {"degree": degree_launches, "runs": run_launches},
            "device": str(dev), **card(),
        },
    }


def main(argv=None) -> int:
    env = os.environ
    p = argparse.ArgumentParser(prog="graphtap_tpu_torch.tools.bench")
    p.add_argument("--scale", type=int,
                   default=int(env.get("BENCH_SCALE", "20")))
    p.add_argument("--iters", type=int,
                   default=int(env.get("BENCH_ITERS", "20")))
    p.add_argument("--kernel", default=env.get("BENCH_KERNEL", "panel"),
                   choices=KERNELS)
    p.add_argument("--runs", type=int, default=MIN_RUNS)
    p.add_argument("--device", default="cuda")
    p.add_argument("--cache", default=CACHE)
    args = p.parse_args(argv)
    rec = run(args.scale, args.iters, args.kernel, args.runs, args.device,
              args.cache)
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
