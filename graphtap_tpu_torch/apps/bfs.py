"""BFS: frontier-driven parent/hops via min-vid messages.

Counterpart of ``graphtap_tpu/apps/bfs.py`` (reference: src/apps/bfs.h,
bfs.cpp): messenger = vid, combiner = min, the applicator sets hops =
iteration+1 and parent = y only for unvisited vertices
(apply_depends_on_iter); nonstationary, undirected, self-loops and
parallel edges removed, TCSC, run to convergence. The changed bitmap is
the frontier, so the panel kernel runs frontier-gated.


``python -m graphtap_tpu_torch.apps.bfs <file> <nvertices> [<root>]``
loads the file through ``bfs_config`` and prints the balance line and the
five oracle lines (``apps/_cli.py``)."""

from __future__ import annotations

import torch

from graphtap_tpu_torch.config import (Compression, EngineConfig,
                                       GraphConfig, Ordering)
from graphtap_tpu_torch.engine.executor import Executor
from graphtap_tpu_torch.engine.program import VertexProgram
from graphtap_tpu_torch.ingest.graph import Graph
from graphtap_tpu_torch.kernels.semiring import INF_I32, min_select


class BFSProgram(VertexProgram):
    stationary = False
    apply_depends_on_iter = True
    value_dtype = torch.int32

    def __init__(self, root: int = 0):
        self.semiring = min_select()
        self.root = root

    def init(self, vids, i_mask, other):
        vid = vids.to(torch.int32, copy=True)
        is_root = vid == self.root
        state = {
            "vid": vid,
            "parent": torch.where(is_root, vid, 0),
            "hops": torch.full_like(vid, INF_I32).masked_fill_(is_root, 0),
        }
        return state, is_root

    def messenger(self, state):
        return state["vid"]

    def applicator(self, state, y, iteration):
        newly = (state["hops"] == INF_I32) & (y != INF_I32)
        hops = torch.where(newly, torch.full_like(state["hops"],
                                                  iteration + 1),
                           state["hops"])
        parent = torch.where(newly, y, state["parent"])
        return {"vid": state["vid"], "parent": parent, "hops": hops}, newly

    def infinity(self):
        return INF_I32

    def get_state(self, state):
        return state["hops"]

    def format_state(self, row):
        h = "INF" if row["hops"] == INF_I32 else row["hops"]
        return f"Parent={row['parent']},Hops={h}"


def bfs_config(num_vertices: int) -> GraphConfig:
    """bfs.cpp:26-45 defaults."""
    return GraphConfig(num_vertices=num_vertices, directed=False,
                       transpose=False, self_loops=False, acyclic=False,
                       parallel_edges=False, compression=Compression.TCSC)


def run_bfs(graph: Graph, root: int = 0, kernel: str = "panel",
            device="cuda", plans=None,
            sparse_exchange_capacity: int = 0) -> Executor:
    """BFS from ``root`` to convergence on ``device`` ('cuda' unless the
    caller passes 'cpu'; ``kernel`` 'panel': the frontier-gated K1-K4
    pipeline; 'shuffle': K6-K8; 'shuffle2': K9 and K8; 'onehot': K5;
    'segment' or 'scan': plain torch). ``graph`` is read through
    ``bfs_config``; ``plans``: the kernel's prebuilt int32 plans of its
    ROW tiles (``tools/artifact_cache.py``), as ``Executor`` takes them;
    ``sparse_exchange_capacity``: K of the sparse exchange (0: dense;
    ``engine/executor.py``)."""
    ex = Executor(graph, BFSProgram(root=root),
                  EngineConfig(stationary=False, apply_depends_on_iter=True,
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
        g = Graph.load(path, bfs_config(nv), mesh=mesh)
        return timed(run_bfs, g, root=root, kernel=kernel, device=device)

    app_main("bfs", _run, third_arg="root", default_third=0)
