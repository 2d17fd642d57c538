"""pr1: the two-load PageRank binary (reference: src/apps/pr1.cpp) — the
graph loaded twice with plain TCSC, untransposed for the degree phase and
transposed for PageRank (pr1.cpp:32-53)."""
from graphtap_tpu_torch.apps._cli import app_main, timed
from graphtap_tpu_torch.apps.pagerank import run_pagerank_two_load


def _run(path, nv, iters, kernel, device, mesh):
    return timed(run_pagerank_two_load, path, nv, num_iterations=iters,
                 kernel=kernel, device=device, mesh=mesh)


if __name__ == "__main__":
    app_main("pr1", _run)
