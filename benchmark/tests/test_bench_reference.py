"""The plain references against brute force on tiny graphs, transforms
included, and the least-bytes count on a graph made by hand."""

import numpy as np
import pytest

import bench_testutil  # noqa: F401
from benchmark import graph500
from benchmark.reference import bfs as ref_bfs
from benchmark.reference import pagerank as ref_pr

PR_GRAPH = {"directed": True, "transpose": True, "self_loops": True,
            "acyclic": False, "parallel_edges": True}
BFS_GRAPH = {"directed": False, "transpose": False, "self_loops": False,
             "acyclic": False, "parallel_edges": False}


def _raw(seed, n=40, m=160):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, n, m).astype(np.int64),
            rng.integers(0, n, m).astype(np.int64), n + 1)


def _brute_pagerank(r, c, nv, iters, alpha):
    """Edge by edge, on the raw (untransposed) edges: u -> v sends
    rank[u] / outdeg[u] to v; only vertices with an in-edge update."""
    out = [0] * nv
    has_in = [False] * nv
    for u, v in zip(r, c):
        out[u] += 1
        has_in[v] = True
    deg = [out[u] if has_in[u] else 0 for u in range(nv)]
    rank = [alpha] * nv
    for _ in range(iters):
        y = [0.0] * nv
        for u, v in zip(r, c):
            if deg[u]:
                y[v] += rank[u] / deg[u]
        rank = [alpha + (1 - alpha) * y[v] if has_in[v] else rank[v]
                for v in range(nv)]
    return np.array(rank), np.array(out, dtype=np.float64)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pagerank_reference_matches_brute_force(seed):
    r, c, nv = _raw(seed)
    rows, cols = graph500.stored_edges(r, c, PR_GRAPH)
    want, outdeg = _brute_pagerank(r, c, nv, 7, 0.15)
    np.testing.assert_allclose(ref_pr.pagerank(rows, cols, nv, 7, 0.15),
                               want, rtol=1e-12)
    np.testing.assert_array_equal(ref_pr.degrees(rows, cols, nv), outdeg)


def _brute_bfs(r, c, nv, root):
    """Undirected, self-loops dropped: levels by Python sets, the parent
    the least previous-level neighbour."""
    adj = {v: set() for v in range(nv)}
    for u, v in zip(r, c):
        if u != v:
            adj[u].add(v)
            adj[v].add(u)
    hops = {root: 0}
    parent = {root: root}
    frontier, steps = [root], 0
    while True:
        steps += 1
        new = {}
        for f in frontier:
            for v in adj[f]:
                if v not in hops:
                    new[v] = min(new.get(v, f), f)
        if not new:
            break
        for v, p in new.items():
            hops[v], parent[v] = steps, p
        frontier = list(new)
    h = np.full(nv, ref_bfs.INF, dtype=np.int64)
    p = np.zeros(nv, dtype=np.int64)
    for v in hops:
        h[v], p[v] = hops[v], parent[v]
    return p, h, steps


@pytest.mark.parametrize("seed,root", [(0, 1), (1, 5), (2, 0), (3, 17)])
def test_bfs_reference_matches_brute_force(seed, root):
    r, c, nv = _raw(seed)
    rows, cols = graph500.stored_edges(r, c, BFS_GRAPH)
    parent, hops, steps = ref_bfs.Reference(rows, cols, nv).run(root)
    wp, wh, ws = _brute_bfs(r, c, nv, root)
    np.testing.assert_array_equal(hops, wh)
    np.testing.assert_array_equal(parent, wp)
    assert steps == ws


def test_stored_edges_drop_self_loops_and_parallel_edges():
    r = np.array([0, 0, 1, 2, 2])
    c = np.array([1, 1, 1, 0, 3])
    rows, cols = graph500.stored_edges(r, c, BFS_GRAPH)
    assert sorted(zip(rows.tolist(), cols.tolist())) == [
        (0, 1), (0, 2), (1, 0), (2, 0), (2, 3), (3, 2)]
    rows, cols = graph500.stored_edges(r, c, PR_GRAPH)
    assert list(zip(rows.tolist(), cols.tolist())) == [
        (1, 0), (1, 0), (1, 1), (0, 2), (3, 2)]


def test_least_superstep_bytes_by_hand():
    # 5 stored edges; columns {0, 1, 2} and rows {0, 1, 3} are non-empty;
    # 6 vertices with 2 state fields each, read and written
    rows = np.array([0, 0, 1, 3, 3])
    cols = np.array([1, 2, 0, 0, 2])
    assert graph500.min_superstep_bytes(rows, cols, 6, 2) == \
        4 * (5 + 3 + 3 + 2 * 2 * 6)
