"""Nonstationary (BFS) profile and the panel frontier-gating A/B.

Counterpart of the JAX package's ``tools_dev/bfs_profile.py``: BFS from
root 0 to convergence on the panel kernel, run with the gate forced
(``GRAPHTAP_PANEL_GATE=1``), off (``0``) and by the per-superstep vote
(``auto``) on identical artifacts, each the best of three timed runs
after a warm-up; all three must give the same checksum in as many
iterations. Then one ``execute_profiled`` run under auto gives the
per-phase (scatter_gather, exchange, combine, apply), per-iteration
breakdown (fenced host ms).

The artifacts (the RMAT edge file, the ROW tiles, the int32 panel meta)
are cached in ``--cache`` (default ``graphtap_tpu_torch/build/
bfs_profile/``), so a re-run skips the plan build.

    python -m graphtap_tpu_torch.tools.bfs_profile [scale] [--device cpu]
        [--cache DIR]

``scale`` defaults to 18 (RMAT, edge factor 16, seed 1, through
``bfs_config(2**scale + 1)``; ``profile(nv=)`` takes another vertex
count, so that plans cached for it are read back), the highest BFS scale the
panel planner routes. On the card it prints the card's name and power
limit first.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Dict

import numpy as np
import torch

from graphtap_tpu_torch.apps.bfs import BFSProgram, bfs_config
from graphtap_tpu_torch.config import EngineConfig, Ordering
from graphtap_tpu_torch.engine.executor import GATE_ENV, Executor, _device
from graphtap_tpu_torch.ingest.graph import Graph
from graphtap_tpu_torch.tools import artifact_cache as ac

CACHE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "build", "bfs_profile")
EDGE_FACTOR, SEED = 16, 1
GATES = ("1", "0", "auto")          # forced, off, auto
REPS = 3


def artifacts(scale: int, cache=CACHE, nv=None):
    """(graph, ROW tiles, int32 panel meta) of RMAT-``scale`` through
    ``bfs_config(nv)``, each read from ``cache`` when there."""
    nv = (1 << scale) + 1 if nv is None else nv
    src, dst, _ = ac.cached_rmat(scale, EDGE_FACTOR, SEED, cache)
    g = Graph.from_edges(src, dst, None, bfs_config(nv))
    tp = os.path.join(cache, f"tiles_rmat{scale}_ef{EDGE_FACTOR}_s{SEED}_"
                      f"cfg{ac.config_hash(g.config)}_row_1x1.npz")
    if os.path.exists(tp):
        tiles = ac.load_tileset(tp)
    else:
        tiles = g.tiled(Ordering.ROW)
        ac.save_tileset(tiles, tp)
    plans = ac.cached_spmv3_meta(tiles, scale, EDGE_FACTOR, SEED, g.config,
                                 Ordering.ROW, np.int32, cache_dir=cache)
    return g, tiles, plans


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(g, tiles, plans, gate: str, device):
    """BFS under ``GRAPHTAP_PANEL_GATE=gate`` (read once, by the
    Executor): one warm-up, then the best of REPS timed runs ->
    (executor, best seconds, iterations, checksum, reachable). The
    variable is left as the caller had it."""
    before = os.environ.get(GATE_ENV)
    os.environ[GATE_ENV] = gate
    try:
        ex = Executor(g, BFSProgram(root=0),
                      EngineConfig(stationary=False,
                                   apply_depends_on_iter=True,
                                   ordering=Ordering.ROW),
                      tiles=tiles, kernel="panel", plans=plans,
                      device=device)
    finally:
        if before is None:
            os.environ.pop(GATE_ENV, None)
        else:
            os.environ[GATE_ENV] = before
    ex.initialize()
    ex.execute(0)                          # warm-up
    best = float("inf")
    for _ in range(REPS):
        ex.initialize()
        _sync(ex.device)
        t0 = time.perf_counter()
        iters = ex.execute(0)
        _sync(ex.device)
        best = min(best, time.perf_counter() - t0)
    cs, reach = ex.checksum()
    return ex, best, iters, cs, reach


def profile(scale: int = 18, device="cuda", cache=CACHE, nv=None,
            log=None) -> Dict:
    """The gate A/B and the breakdown: {"gates": gate -> {"seconds",
    "iters", "checksum", "reachable", "gated"} (``gated``: each
    superstep's branch), "phases": name -> per-iteration seconds of the
    profiled auto run, "state": its final state in vertex order}. Raises
    AssertionError when the gates disagree."""
    dev = _device(device)
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    t0 = time.perf_counter()
    g, tiles, plans = artifacts(scale, cache, nv)
    log(f"[prof] artifacts ready +{time.perf_counter() - t0:.0f}s")
    gates, runs = {}, {}
    for gate in GATES:
        ex, best, iters, cs, reach = run(g, tiles, plans, gate, dev)
        gates[gate] = {"seconds": best, "iters": iters, "checksum": cs,
                       "reachable": reach,
                       "gated": [s["gated"] for s in ex.supersteps]}
        runs[gate] = ex
        log(f"[prof] gate={gate}: {best:.4f}s / {iters} iters "
            f"cs={cs:.0f}/{reach}")
    first = gates[GATES[0]]
    for gate, r in gates.items():
        if (r["checksum"], r["reachable"], r["iters"]) != (
                first["checksum"], first["reachable"], first["iters"]):
            raise AssertionError(f"gate {gate}: {r} differs from gate "
                                 f"{GATES[0]}: {first}")
    auto = runs["auto"]
    auto.initialize()
    timer = auto.execute_profiled(0, printer=None)
    return {"gates": gates, "phases": dict(timer.samples),
            "state": auto.state_vector()}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="graphtap_tpu_torch.tools.bfs_profile")
    p.add_argument("scale", type=int, nargs="?", default=18)
    p.add_argument("--device", default="cuda")
    p.add_argument("--cache", default=CACHE)
    args = p.parse_args(argv)
    if _device(args.device).type == "cuda":
        from graphtap_tpu_torch.tools.bw_probe import card
        print(f"[prof] card: {card()}", flush=True)
    res = profile(args.scale, args.device, args.cache)
    t = [res["gates"][gate]["seconds"] for gate in GATES]
    print(f"[prof] gate forced/off/auto: {t[0]:.4f}s / {t[1]:.4f}s / "
          f"{t[2]:.4f}s")
    print("[prof] per-phase totals (s):")
    for name, xs in res["phases"].items():
        per = " ".join(f"{x * 1e3:.1f}" for x in xs)
        print(f"  {name:15s} total={sum(xs):.4f}  per-iter(ms): {per}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
