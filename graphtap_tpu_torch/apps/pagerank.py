"""PageRank: the two-phase degree -> rank pipeline.

Counterpart of ``graphtap_tpu/apps/pagerank.py`` (reference: src/apps/pr.h,
pr.cpp): one load of Aᵀ (transpose=True); the degree phase on the COL
ordering (out-degree of A), then PageRank on the ROW ordering, with the
degree handed over only where the I bit (in-edge mask) is set
(vertex_program.hpp:476-483). pr.cpp loads with TCSC_CF, whose PageRank
runs the first/middle/last phases (``engine/executor.py``).
``run_pagerank_two_load`` is pr1.cpp's variant: two loads of plain TCSC.
"""

from __future__ import annotations

import torch

from graphtap_tpu_torch.config import (Compression, EngineConfig,
                                       GraphConfig, Ordering)
from graphtap_tpu_torch.engine.executor import Executor
from graphtap_tpu_torch.engine.program import VertexProgram
from graphtap_tpu_torch.ingest.graph import Graph
from graphtap_tpu_torch.kernels.semiring import plus_times
from graphtap_tpu_torch.apps.degree import run_degree

ALPHA = 0.15   # reference: pr.h:13
TOL = 1e-5     # reference: pr.h:12


class PageRankProgram(VertexProgram):
    stationary = True

    def __init__(self, value_dtype: torch.dtype = torch.float32,
                 alpha: float = ALPHA, tol: float = TOL):
        self.semiring = plus_times()
        self.value_dtype = value_dtype
        self.alpha = alpha
        self.tol = tol

    def init(self, vids, i_mask, other):
        dt = self.value_dtype
        if other is None:
            degree = torch.zeros(vids.shape, dtype=dt, device=vids.device)
        else:
            # copy the degree only where the I bit is set (reference quirk,
            # vertex_program.hpp:476-483)
            degree = torch.where(i_mask, other["degree"].to(dt), 0.0)
        state = {"rank": torch.full(vids.shape, self.alpha, dtype=dt,
                                    device=vids.device),
                 "degree": degree}
        return state, i_mask.clone()

    def messenger(self, state):
        d = state["degree"]
        has = d > 0
        return torch.where(has, state["rank"] /
                           torch.where(has, d, torch.ones_like(d)),
                           torch.zeros_like(d))

    def applicator(self, state, y, iteration):
        new_rank = self.alpha + (1 - self.alpha) * y
        changed = torch.abs(new_rank - state["rank"]) > self.tol
        return {"rank": new_rank, "degree": state["degree"]}, changed

    def get_state(self, state):
        return state["rank"]

    def format_state(self, row):
        return f"Rank={row['rank']:.6f},Degree={row['degree']}"


def run_pagerank(graph: Graph, num_iterations: int = 0,
                 value_dtype: torch.dtype = torch.float32,
                 kernel: str = "panel", device="cuda",
                 degree_kernel: str = "shuffle") -> Executor:
    """The pr.cpp pipeline on a loaded (transposed) graph, on ``device``
    ('cuda' unless the caller passes 'cpu').

    The degree phase is one SpMV on ``degree_kernel`` ('shuffle': the v1
    K6-K8 pipeline, which plans in seconds, as the JAX bench composes it
    at RMAT-20; or any other kernel of ``Executor``), integer sums, exact
    in f32; PageRank runs ``num_iterations`` supersteps on ``kernel``
    ('panel': the K1-K4 pipeline; 'shuffle': K6-K8; 'shuffle2': the v2
    K9 + K8 pipeline; 'onehot': K5; 'segment' or 'scan': plain torch), or,
    for num_iterations=0, runs to tol-convergence. The degree phase's
    tiles and plans are freed before the PageRank plans are uploaded; its
    executor, with its state, is the returned executor's ``degree_phase``.
    """
    deg_ex = run_degree(graph, value_dtype, Ordering.COL, degree_kernel,
                        device)
    return _ranks(graph, deg_ex, num_iterations, value_dtype, kernel, device)


def run_pagerank_two_load(path: str, num_vertices: int,
                          num_iterations: int = 0,
                          value_dtype: torch.dtype = torch.float32,
                          kernel: str = "panel", device="cuda",
                          degree_kernel: str = "shuffle",
                          mesh=None) -> Executor:
    """pr1.cpp: load the edge-list file twice with plain TCSC, untransposed
    for the degree phase (``run_degree``, ROW ordering, on
    ``degree_kernel``; the JAX package's ``run_degree_for_handoff``) and
    transposed for PageRank on ``kernel`` (pr1.cpp:32-53), on ``device``;
    both loads on ``mesh`` (``Graph.load``)."""
    cfg_deg = GraphConfig(num_vertices=num_vertices, directed=True,
                          transpose=False, compression=Compression.TCSC)
    cfg_pr = GraphConfig(num_vertices=num_vertices, directed=True,
                         transpose=True, compression=Compression.TCSC)
    deg_ex = run_degree(Graph.load(path, cfg_deg, mesh=mesh), value_dtype,
                        kernel=degree_kernel, device=device)
    return _ranks(Graph.load(path, cfg_pr, mesh=mesh), deg_ex,
                  num_iterations, value_dtype, kernel, device)


def _ranks(graph: Graph, deg_ex: Executor, num_iterations: int, value_dtype,
           kernel: str, device) -> Executor:
    """Free the degree phase's arrays, then run PageRank on the ROW
    ordering of ``graph`` from its handed-over state."""
    deg_ex.free()
    pr_ex = Executor(graph, PageRankProgram(value_dtype=value_dtype),
                     EngineConfig(stationary=True, ordering=Ordering.ROW),
                     kernel=kernel, device=device)
    pr_ex.degree_phase = deg_ex
    pr_ex.initialize(other=deg_ex)
    pr_ex.execute(num_iterations)
    return pr_ex

