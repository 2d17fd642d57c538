"""Run the apps on a mesh, one rank per shard, and write what they give.

The rank side of a mesh run (``parallel/launch.py`` starts the ranks):

    python -m graphtap_tpu_torch.parallel.launch -n 4 -- \\
        python -m graphtap_tpu_torch.tools.mesh_run spec.json

``spec.json`` names the mesh (``shape`` [R, C]; ``backend`` "gloo" or
"nccl"; ``device`` "cuda", the default, which raises without CUDA, or
"cpu"), the output directory ``out``, the graphs (``graphs``: name ->
{"path": an edge-list file, "nv": the vertex count, "config": "pr",
"bfs", "cc" or "sssp", the app config it is read through, "overrides":
GraphConfig fields, "compression" by value}), each loaded by every rank
from its byte range (``Graph.load``), and what to run on them:

  * ``runs``: {"name", "graph", "app": "degree" (one SpMV on the COL
    ordering, PageRank's degree phase), "pagerank" (that degree phase on
    ``degree_kernel``, then ``iters`` supersteps; "profiled": true runs
    them through ``execute_profiled``), "bfs", "cc" or "sssp" (to
    convergence from ``root``; their int32 plans are built once a graph
    and kernel and shared by its runs), "kernel", "dtype" (degree
    and pagerank: "float32" or "float64"), "capacity" (the sparse
    exchange's K), "plain": also run it on the group-free 1x1 layout in
    this process}. Rank 0 writes ``<name>.npz`` (the state in vertex order)
    and ``<name>.json``: checksum, reachable, iterations, the exchange's
    transport and, per rank, each superstep's branches (gated, sparse,
    sparse_y), its ms, the executor's timings in seconds, the kernel
    launches counted in the run and, profiled, each phase's fenced host
    ms (``phases``: name -> [sum, samples]); a plain run is
    ``<name>_1x1``.
  * ``plans``: {"graph", "ordering", "kind": "spmv3", "shuffle",
    "spmv2" or "onehot", "dtype"}: each rank writes its shard's plan
    arrays to ``plan_<graph>_<ordering>_<kind>_b<rank>.npz``.
  * ``tiles``: {"graph", "ordering", "cf"}: each rank writes its row of
    the tiles (or of the four TCSC_CF tilesets) to ``tiles_<graph>_
    <ordering>[_cf]_b<rank>.npz`` (``<set>_<field>`` arrays).
  * ``edges``: graph names: each rank writes the edges it holds after
    the exchange to ``edges_<graph>_b<rank>.npz`` (r, c[, w]).

Every rank runs the same cases in the same order (they are collective).
The ranks print one ``[mesh_run]`` line per case; rank 0's are the
record.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch

from graphtap_tpu_torch.apps import bfs, cc, sssp
from graphtap_tpu_torch.apps.degree import run_degree
from graphtap_tpu_torch.apps.pagerank import PageRankProgram
from graphtap_tpu_torch.config import (Compression, EngineConfig,
                                       GraphConfig, Ordering)
from graphtap_tpu_torch.engine.executor import Executor, _PLANNERS, _device
from graphtap_tpu_torch.ingest.graph import Graph
from graphtap_tpu_torch.parallel import multihost as mh
from graphtap_tpu_torch.parallel.layout import make_mesh
from graphtap_tpu_torch.tools.timing import launches, reset_launches

_DTYPES = {"float32": torch.float32, "float64": torch.float64}
_PLAN_KINDS = {"spmv3": "panel", "shuffle": "shuffle", "spmv2": "shuffle2",
               "onehot": "onehot"}
_TILE_FIELDS = ("rows", "cols", "weights", "nnz", "ja", "ir", "iv_dense",
                "nnzrows", "i_own", "j_own", "regular_own", "source_own",
                "sink_own", "nnzcols", "dev_nnz")


def app_config(kind: str, nv: int, overrides=None) -> GraphConfig:
    """The config an app reads its graph through (pr.cpp's PageRank:
    transposed TCSC; ``bfs_config``, ``cc_config``, ``sssp_config``),
    with ``overrides`` (GraphConfig fields; ``compression`` by value)."""
    cfg = {"pr": GraphConfig(num_vertices=nv, directed=True, transpose=True,
                             compression=Compression.TCSC),
           "bfs": bfs.bfs_config(nv), "cc": cc.cc_config(nv),
           "sssp": sssp.sssp_config(nv)}[kind]
    over = dict(overrides or {})
    if "compression" in over:
        over["compression"] = Compression(over["compression"])
    return dataclasses.replace(cfg, **over)


class Runner:
    """The cases of one spec on this rank's mesh."""

    def __init__(self, spec: dict):
        self.spec = spec
        self.out = spec["out"]
        self.device = _device(spec.get("device", "cuda"))
        rank, world = mh.initialize(backend=spec.get("backend", "gloo"))
        self.rank = rank
        self.mesh = make_mesh(tuple(spec["shape"]))
        self.graphs, self.degrees, self.plans = {}, {}, {}
        os.makedirs(self.out, exist_ok=True)

    def graph(self, name: str, plain: bool = False) -> Graph:
        key = (name, plain)
        if key not in self.graphs:
            g = self.spec["graphs"][name]
            cfg = app_config(g["config"], g["nv"], g.get("overrides"))
            t0 = time.perf_counter()
            self.graphs[key] = Graph.load(g["path"], cfg,
                                          mesh=None if plain else self.mesh)
            self.log(f"graph {name}{' 1x1' if plain else ''}: "
                     f"{self.graphs[key].nedges} edges on this rank, "
                     f"loaded in {time.perf_counter() - t0:.2f} s")
        return self.graphs[key]

    def log(self, msg: str) -> None:
        print(f"[mesh_run] rank {self.rank}: {msg}", flush=True)

    # ------------------------------------------------------------- runs
    def _degree(self, g: Graph, kernel: str, dtype) -> Executor:
        key = (id(g), kernel, dtype)
        if key not in self.degrees:
            self.degrees[key] = run_degree(g, dtype, Ordering.COL, kernel,
                                           self.device)
        return self.degrees[key]

    def _int_plans(self, g: Graph, kernel: str):
        """The int32 plans of ``g``'s ROW tiles on ``kernel`` (BFS, CC and
        SSSP run int32 values), built once; None for the kernels that
        read the tiles."""
        if kernel not in _PLANNERS:
            return None
        key = (id(g), kernel)
        if key not in self.plans:
            self.plans[key] = _PLANNERS[kernel][1](g.tiled(Ordering.ROW),
                                                   value_dtype=np.int32)
        return self.plans[key]

    def _execute(self, run: dict, g: Graph):
        """``run`` on ``g`` -> (its executor, the ``PhaseTimer`` of a
        profiled run, else None)."""
        app, kernel = run["app"], run["kernel"]
        K = run.get("capacity", 0)
        if app == "degree":
            return self._degree(g, kernel, _DTYPES[run["dtype"]]), None
        if app == "pagerank":
            dtype = _DTYPES[run["dtype"]]
            deg = self._degree(g, run.get("degree_kernel", "shuffle"), dtype)
            deg.free()
            ex = Executor(g, PageRankProgram(dtype),
                          EngineConfig(stationary=True,
                                       ordering=Ordering.ROW),
                          kernel=kernel, device=self.device)
            ex.initialize(other=deg)
            if run.get("profiled"):
                return ex, ex.execute_profiled(run["iters"], printer=None)
            ex.execute(run["iters"])
            return ex, None
        plans = self._int_plans(g, kernel)
        if app == "bfs":
            return bfs.run_bfs(g, run.get("root", 0), kernel, self.device,
                               plans, sparse_exchange_capacity=K), None
        if app == "cc":
            return cc.run_cc(g, kernel, self.device, plans,
                             sparse_exchange_capacity=K), None
        if app == "sssp":
            return sssp.run_sssp(g, run.get("root", 0), kernel=kernel,
                                 device=self.device, plans=plans,
                                 sparse_exchange_capacity=K), None
        raise ValueError(f"unknown app {app!r}")

    def run(self, run: dict, plain: bool = False) -> None:
        name = run["name"] + ("_1x1" if plain else "")
        g = self.graph(run["graph"], plain)
        reset_launches()
        t0 = time.perf_counter()
        ex, timer = self._execute(run, g)
        wall = time.perf_counter() - t0
        mine = {"launches": launches(), "timings": dict(ex.timings),
                "wall_s": wall,
                "supersteps": [{k: rec[k] for k in ("gated", "sparse",
                                                     "sparse_y", "ms")}
                               for rec in ex.supersteps]}
        if timer is not None:
            mine["phases"] = {k: [sum(v) * 1e3, len(v)]
                              for k, v in timer.samples.items()}
        ranks = self.gather(mine) if not plain else [mine]
        sv = ex.state_vector()
        checksum, reachable = ex.checksum()
        if self.rank == 0:
            np.savez(os.path.join(self.out, f"{name}.npz"), **sv)
            with open(os.path.join(self.out, f"{name}.json"), "w") as f:
                json.dump({"checksum": checksum, "reachable": reachable,
                           "iteration": ex.iteration,
                           "exchange": ex.exchange, "ranks": ranks}, f)
        self.log(f"{name}: checksum {checksum!r}, reachable {reachable}, "
                 f"{ex.iteration} iterations, {wall:.2f} s")

    def gather(self, obj) -> list:
        import torch.distributed as dist
        out = [None] * self.mesh.D
        dist.all_gather_object(out, obj, group=self.mesh.host_group)
        return out

    # ------------------------------------------------------ plans, tiles
    def plan(self, p: dict) -> None:
        g = self.graph(p["graph"])
        ordering = Ordering[p["ordering"]]
        tiles = g.tiled(ordering)
        build = _PLANNERS[_PLAN_KINDS[p["kind"]]][1]
        t0 = time.perf_counter()
        meta = build(tiles, value_dtype=np.dtype(p.get("dtype", "float32")))
        np.savez(os.path.join(self.out, f"plan_{p['graph']}_{p['ordering']}_"
                              f"{p['kind']}_b{self.rank}.npz"),
                 **meta.arrays)
        self.log(f"plan {p['graph']} {p['ordering']} {p['kind']}: "
                 f"{time.perf_counter() - t0:.2f} s")

    def tiles(self, t: dict) -> None:
        g = self.graph(t["graph"])
        ordering = Ordering[t["ordering"]]
        sets = g.tiled_cf(ordering) if t.get("cf") else \
            {"main": g.tiled(ordering)}
        arrays = {}
        for nm, ts in sets.items():
            for f in _TILE_FIELDS:
                a = getattr(ts, f)
                if a is not None:
                    arrays[f"{nm}_{f}"] = a if f == "dev_nnz" \
                        else a[self.mesh.shard]
            arrays[f"{nm}_scalars"] = np.array([ts.Ep, ts.NR, ts.nnz_total])
        tag = "_cf" if t.get("cf") else ""
        np.savez(os.path.join(self.out, f"tiles_{t['graph']}_"
                              f"{t['ordering']}{tag}_b{self.rank}.npz"),
                 **arrays)

    def edges(self, name: str) -> None:
        g = self.graph(name)
        arrays = {"r": g.r, "c": g.c}
        if g.w is not None:
            arrays["w"] = g.w
        np.savez(os.path.join(self.out, f"edges_{name}_b{self.rank}.npz"),
                 **arrays)

    def all(self) -> None:
        for name in self.spec.get("edges", ()):
            self.edges(name)
        for t in self.spec.get("tiles", ()):
            self.tiles(t)
        for p in self.spec.get("plans", ()):
            self.plan(p)
        for run in self.spec.get("runs", ()):
            self.run(run)
            if run.get("plain"):
                self.run(run, plain=True)
        mh.barrier(self.mesh)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    with open(argv[0]) as f:
        spec = json.load(f)
    Runner(spec).all()
    return 0


if __name__ == "__main__":
    sys.exit(main())
