"""Seconds from the run's first statement to the first timed job:
imports, the CUDA context, the edges, the port's graph, tiles and plans,
the degree phase, the upload and the warm-up."""


def read(ctx):
    return ctx["setup_s"]
