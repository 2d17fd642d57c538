"""Seconds of the graph's preparation, built afresh in every run: the
edges drawn on the card and what the harness takes from them, the port's
graph, and the tiles and plans its executors build (the harness's host
clock and ``Executor.timings``)."""


def read(ctx):
    s = ctx["setup"]
    return sum(s.get(k, 0.0) for k in ("edges", "graph", "tiles", "plans"))
