"""deg: the degree binary (reference: src/apps/deg.cpp — stationary,
TCSC, untransposed, one iteration). A ``__main__`` shim; the API is
``apps.degree``."""
from graphtap_tpu_torch.apps._cli import app_main, timed
from graphtap_tpu_torch.apps.degree import run_degree
from graphtap_tpu_torch.config import Compression, GraphConfig
from graphtap_tpu_torch.ingest.graph import Graph


def _run(path, nv, _third, kernel, device, mesh):
    g = Graph.load(path, GraphConfig(num_vertices=nv, directed=True,
                                     transpose=False,
                                     compression=Compression.TCSC),
                   mesh=mesh)
    return timed(run_degree, g, kernel=kernel, device=device)


if __name__ == "__main__":
    app_main("deg", _run, third_arg="iters", default_third=1)
