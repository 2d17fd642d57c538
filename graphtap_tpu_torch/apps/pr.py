"""pr: the two-phase PageRank binary (reference: src/apps/pr.cpp).

``python -m graphtap_tpu_torch.apps.pr <file> <nvertices> [<iters>]`` —
one load of the transposed matrix with TCSC_CF, the degree phase on the
COL ordering, then PageRank on the ROW ordering with the state handoff
(pr.cpp:36-50). A ``__main__`` shim; the API is ``apps.pagerank``."""
from graphtap_tpu_torch.apps._cli import app_main, timed
from graphtap_tpu_torch.apps.pagerank import run_pagerank
from graphtap_tpu_torch.config import Compression, GraphConfig
from graphtap_tpu_torch.ingest.graph import Graph


def _run(path, nv, iters, kernel, device, mesh):
    g = Graph.load(path, GraphConfig(num_vertices=nv, directed=True,
                                     transpose=True,
                                     compression=Compression.TCSC_CF),
                   mesh=mesh)
    return timed(run_pagerank, g, num_iterations=iters, kernel=kernel,
                 device=device)


if __name__ == "__main__":
    app_main("pr", _run)
