"""SSSP: min-plus relaxation (the only weighted app).

Counterpart of ``graphtap_tpu/apps/sssp.py`` (reference: src/apps/sssp.h,
sssp.cpp): combiner y1 = min(y1, y2 + w), min-update applicator, the
unweighted fallback y+1; nonstationary, directed with transpose flipped
for a pull along in-edges, self-loops and parallel edges removed, TCSC,
gather_depends_on_apply, run to convergence.


``python -m graphtap_tpu_torch.apps.sssp <file> <nvertices> [<root>]``
loads the (weighted) file through ``sssp_config`` and prints the balance
line and the five oracle lines (``apps/_cli.py``)."""

from __future__ import annotations

import torch

from graphtap_tpu_torch.config import (Compression, EngineConfig,
                                       GraphConfig, Ordering)
from graphtap_tpu_torch.engine.executor import Executor
from graphtap_tpu_torch.engine.program import VertexProgram
from graphtap_tpu_torch.ingest.graph import Graph
from graphtap_tpu_torch.kernels.semiring import (inf_of, min_plus,
                                                 min_select)


class SSSPProgram(VertexProgram):
    """``value_dtype``: int32, GraphTap's distances (INF = INT32_MAX), or
    float32, Graph500 kernel 3's (INF = +inf, float weights)."""
    stationary = False
    gather_depends_on_apply = True
    value_dtype = torch.int32

    def __init__(self, root: int = 0, weighted: bool = True,
                 value_dtype: torch.dtype = torch.int32):
        self.value_dtype = value_dtype
        self.inf = inf_of(value_dtype)
        self.semiring = (min_plus if weighted else min_select)(self.inf)
        self.weighted = weighted
        self.root = root

    def init(self, vids, i_mask, other):
        is_root = vids == self.root
        distance = torch.full(vids.shape, self.inf, dtype=self.value_dtype,
                              device=vids.device)
        return {"distance": distance.masked_fill_(is_root, 0)}, is_root

    def messenger(self, state):
        return state["distance"]

    def applicator(self, state, y, iteration):
        if not self.weighted:
            # unweighted fallback: hop count y+1 (reference: sssp.h:60-64)
            y = torch.where(y >= self.inf, y, y + 1)
        new = torch.minimum(state["distance"], y)
        return {"distance": new}, new != state["distance"]

    def infinity(self):
        return self.inf

    def get_state(self, state):
        return state["distance"]

    def format_state(self, row):
        d = "INF" if row["distance"] == self.inf else row["distance"]
        return f"Distance={d}"


def sssp_config(num_vertices: int, weighted: bool = True) -> GraphConfig:
    """sssp.cpp:26-45 defaults. Directed pull: the engine requirement
    ``if(not stationary and directed) transpose = not transpose``
    (sssp.cpp:37-38) flips transpose to True."""
    return GraphConfig(num_vertices=num_vertices, directed=True,
                       transpose=True, self_loops=False, acyclic=False,
                       parallel_edges=False, has_weight=weighted,
                       compression=Compression.TCSC)


def run_sssp(graph: Graph, root: int = 0, weighted: bool = True,
             kernel: str = "panel", device="cuda", plans=None,
             sparse_exchange_capacity: int = 0,
             value_dtype: torch.dtype = torch.int32) -> Executor:
    """SSSP from ``root`` to convergence on ``device`` ('cuda' unless the
    caller passes 'cpu'; ``kernel`` any of ``Executor``'s: 'panel',
    'shuffle', 'shuffle2' (its ⊗ is K9's add_sat), 'onehot', 'segment' or
    'scan');
    ``graph`` is read through ``sssp_config`` (with its weights when
    ``weighted``); ``plans`` and ``sparse_exchange_capacity``: as
    ``run_bfs`` takes them; ``value_dtype``: ``SSSPProgram``'s (float32
    with a float-weighted graph: Graph500 kernel 3 on 'onehot', 'scan'
    or 'segment')."""
    ex = Executor(graph, SSSPProgram(root=root, weighted=weighted,
                                     value_dtype=value_dtype),
                  EngineConfig(stationary=False, gather_depends_on_apply=True,
                               ordering=Ordering.ROW,
                               sparse_exchange_capacity=(
                                   sparse_exchange_capacity)),
                  kernel=kernel, plans=plans, device=device)
    ex.initialize()
    ex.execute(0)
    return ex


if __name__ == "__main__":
    from graphtap_tpu_torch.apps._cli import app_main, timed

    def _run(path, nv, root, kernel, device, mesh):
        g = Graph.load(path, sssp_config(nv), mesh=mesh)
        return timed(run_sssp, g, root=root, kernel=kernel, device=device)

    app_main("sssp", _run, third_arg="root", default_third=0)
