"""What every system under test shares: the port's graph of the raw
edges, built afresh in every run, the executors' own set-up seconds, and
answers read back in vertex order."""

from __future__ import annotations

import contextlib
import time
from typing import Dict

import numpy as np
import torch

from graphtap_tpu_torch.config import Compression, GraphConfig
from graphtap_tpu_torch.ingest.graph import Graph

DTYPES = {"float32": torch.float32, "float64": torch.float64,
          "int32": torch.int32}


def graph(cfg: Dict, edges, times: Dict) -> Graph:
    """The port's graph of the raw ``edges`` under ``cfg["graph"]``; its
    seconds go to ``times["graph"]``."""
    t0 = time.perf_counter()
    g = dict(cfg["graph"])
    g["compression"] = Compression(g["compression"])
    config = GraphConfig(num_vertices=1 << cfg["scale"], **g)
    out = Graph.from_edges(edges[0], edges[1], None, config)
    times["graph"] = time.perf_counter() - t0
    return out


def add_times(ex, times: Dict) -> None:
    """An executor's own set-up seconds into ``times``: the tiles and
    plans it built, and its upload."""
    for k in ("tiles", "plans", "upload"):
        times[k] = times.get(k, 0.0) + ex.timings.get(k, 0.0)


def vertex_order(ex, t: torch.Tensor) -> np.ndarray:
    """A 1x1 executor's state field ``t`` on the host, in vertex-id
    order, truncated to the graph's vertices."""
    return ex.part.to_vertex_order(t.cpu().numpy()[None])[:ex.graph.nv]


def no_span(name: str):
    return contextlib.nullcontext()


def execute(ex, iterations: int, profile=None) -> None:
    """``ex.execute(iterations)``, or, given a ``PhaseTimer``, the port's
    fenced ``execute_profiled`` into it."""
    if profile is None:
        ex.execute(iterations)
    else:
        ex.execute_profiled(iterations, profile, printer=None)
