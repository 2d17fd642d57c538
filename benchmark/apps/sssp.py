"""Graph500 kernel 3 queries as users run them on the port: float32 SSSP
over float weights, one executor, and each job sets its root on the
executor's ``SSSPProgram`` (which only ``init`` reads), then
``initialize()`` and ``execute(0)`` to convergence.

The weights are ``g500_weights.pair_weights`` of each raw edge, computed
here on the card (the harness hands the raw edges alone); the reference
computes the same function on the stored edges.

The traced run's profiled jobs (``profile``: the ``PhaseTimer`` that
``execute_profiled`` opens as the process's tracer) carry the executor's
``relaxed_edges`` and ``frontier_edges`` counters; after each, the
counts that job added go into the set-up record ``times`` given at
construction, under ``counters.relaxed_edges`` and
``counters.frontier_edges``, which the harness hands the metric readers
as ``ctx["setup"]`` (``metrics/kernels.wasted_edge_share.py``).
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from benchmark.apps import common
from benchmark.g500_weights import pair_weights
from benchmark.reference import sssp as reference
from graphtap_tpu_torch.apps.sssp import SSSPProgram
from graphtap_tpu_torch.config import (Compression, EngineConfig,
                                       GraphConfig, Ordering)
from graphtap_tpu_torch.engine.executor import Executor
from graphtap_tpu_torch.ingest.graph import Graph

FIELDS = ("distance",)
COUNTERS = ("relaxed_edges", "frontier_edges")
WEIGHT_BLOCK = 1 << 22      # edges hashed at once on the card


def weights(r: np.ndarray, c: np.ndarray, device) -> np.ndarray:
    """float32 pair weights of the raw edges, hashed on ``device`` in
    blocks (so the hash's temporaries stay small), back on the host."""
    out = np.empty(r.shape, np.float32)
    for s in range(0, r.size, WEIGHT_BLOCK):
        e = s + WEIGHT_BLOCK
        out[s:e] = pair_weights(torch.from_numpy(r[s:e]).to(device),
                                torch.from_numpy(c[s:e]).to(device)
                                ).cpu().numpy()
    return out


class System:
    def __init__(self, cfg: Dict, edges, device, times: Dict):
        dtype = common.DTYPES[cfg["value_dtype"]]
        t0 = time.perf_counter()
        r, c = edges
        gc = dict(cfg["graph"])
        gc["compression"] = Compression(gc["compression"])
        g = Graph.from_edges(r, c, weights(r, c, device),
                             GraphConfig(num_vertices=1 << cfg["scale"],
                                         **gc))
        times["graph"] = time.perf_counter() - t0
        self.ex = Executor(g, SSSPProgram(root=0, weighted=True,
                                          value_dtype=dtype),
                           EngineConfig(stationary=False,
                                        gather_depends_on_apply=True,
                                        ordering=Ordering.ROW),
                           kernel=cfg["kernel"], device=device)
        common.add_times(self.ex, times)
        self.times = times

    def job(self, params: Dict, profile=None, span=common.no_span) -> None:
        self.ex.program.root = params["root"]
        before = {k: profile.counters.get(k, 0) for k in COUNTERS} \
            if profile is not None else None
        with span("initialize"):
            self.ex.initialize()
        with span("execute"):
            common.execute(self.ex, params["iterations"], profile)
        if profile is not None:
            for k in COUNTERS:
                key = f"counters.{k}"
                self.times[key] = (self.times.get(key, 0)
                                   + profile.counters.get(k, 0) - before[k])

    def supersteps(self) -> int:
        """The supersteps the last job ran (the flush not counted)."""
        return self.ex.iteration

    def snapshot(self, params: Dict) -> Dict:
        snap = {k: self.ex.state[k].clone() for k in FIELDS}
        snap.update(root=params["root"], supersteps=self.ex.iteration)
        return snap

    def answer(self, snap: Dict) -> Dict:
        out = dict(snap)
        for k in FIELDS:
            out[k] = common.vertex_order(self.ex, snap[k])
        return out

    def free(self) -> None:
        self.ex.free()


def make_reference(cfg: Dict, traffic: Dict, rows, cols, nv: int):
    return reference.Reference(rows, cols, nv)


def compare(ref, answer: Dict) -> Dict:
    return ref.compare(answer)


def control(cfg: Dict, traffic: Dict, ref, rows, cols, nv: int,
            roots) -> List[Dict]:
    """The lower-precision control's answers, in the program's place."""
    return reference.control_answers(ref, roots)


def control_compare(ref, answer: Dict) -> Dict:
    return ref.compare(answer)
