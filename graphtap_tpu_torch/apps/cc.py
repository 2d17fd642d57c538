"""Connected components via min-label propagation.

Counterpart of ``graphtap_tpu/apps/cc.py`` (reference: src/apps/cc.h,
cc.cpp): messenger = label, combiner = min, the applicator keeps the min
and reports a change iff the label shrank; nonstationary, undirected,
self-loops kept, parallel edges removed, TCSC, gather_depends_on_apply,
run to convergence.


``python -m graphtap_tpu_torch.apps.cc <file> <nvertices>`` loads the
file through ``cc_config`` and prints the balance line and the five
oracle lines (``apps/_cli.py``)."""

from __future__ import annotations

import torch

from graphtap_tpu_torch.config import (Compression, EngineConfig,
                                       GraphConfig, Ordering)
from graphtap_tpu_torch.engine.executor import Executor
from graphtap_tpu_torch.engine.program import VertexProgram
from graphtap_tpu_torch.ingest.graph import Graph
from graphtap_tpu_torch.kernels.semiring import INF_I32, min_select


class CCProgram(VertexProgram):
    stationary = False
    gather_depends_on_apply = True
    value_dtype = torch.int32

    def __init__(self):
        self.semiring = min_select()

    def init(self, vids, i_mask, other):
        return ({"label": vids.to(torch.int32, copy=True)},
                torch.ones_like(i_mask))

    def messenger(self, state):
        return state["label"]

    def applicator(self, state, y, iteration):
        new = torch.minimum(state["label"], y)
        return {"label": new}, new != state["label"]

    def infinity(self):
        return INF_I32

    def get_state(self, state):
        return state["label"]

    def format_state(self, row):
        return f"Label={row['label']}"


def cc_config(num_vertices: int) -> GraphConfig:
    """cc.cpp:25-43 defaults: undirected, keep self-loops, dedup parallel."""
    return GraphConfig(num_vertices=num_vertices, directed=False,
                       transpose=False, self_loops=True, acyclic=False,
                       parallel_edges=False, compression=Compression.TCSC)


def run_cc(graph: Graph, kernel: str = "panel", device="cuda",
           plans=None, sparse_exchange_capacity: int = 0) -> Executor:
    """CC to convergence on ``device`` ('cuda' unless the caller passes
    'cpu'; ``kernel`` any of ``Executor``'s: 'panel', 'shuffle',
    'shuffle2', 'onehot', 'segment' or 'scan'); ``graph`` is read
    through ``cc_config``; ``plans`` and ``sparse_exchange_capacity``: as
    ``run_bfs`` takes them."""
    ex = Executor(graph, CCProgram(),
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

    def _run(path, nv, _third, kernel, device, mesh):
        g = Graph.load(path, cc_config(nv), mesh=mesh)
        return timed(run_cc, g, kernel=kernel, device=device)

    app_main("cc", _run, third_arg="iters", default_third=0)
