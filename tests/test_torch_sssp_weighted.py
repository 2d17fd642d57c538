"""Graph500 kernel 3 on the port, on the CPU: float32 SSSP over float
weights (the pair hash of ``benchmark/g500_weights.py``) on small
undirected Kronecker graphs, to convergence through ``Executor``,
``initialize()`` and ``execute(0)``:

  * on the scan and onehot kernels (K5's plain version) the distances
    equal ``tests/reference_sssp.py`` bit for bit, in equal supersteps;
  * float weights survive ``Graph.tiled`` (each tile weight is its
    stored edge's pair weight, and the tiles equal the JAX package's
    build in float32), and int-weighted tiles with parallel edges equal
    the JAX package's byte for byte;
  * ``min_plus`` over floats keeps +inf as +inf; K5 takes f32 min and
    max, and the kernels that share ``_REDUCE_OK`` do not;
  * under a tracer, ``frontier_edges`` equals the reference's sum of the
    frontier's out-edges over its levels and ``relaxed_edges`` the
    stored edges times the supersteps; with none open nothing is counted
    and the vote reads ``C.any()`` alone.
"""

import os
import sys

import numpy as np
import pytest
import torch

from graphtap_tpu.config import Compression as JCompression
from graphtap_tpu.format.tiles import build_tileset as j_build_tileset
from graphtap_tpu.parallel.layout import Partition as JPartition

from benchmark.g500_weights import pair_weights
from graphtap_tpu_torch import (Compression, EngineConfig, Graph,
                                GraphConfig, Ordering)
from graphtap_tpu_torch.apps.sssp import SSSPProgram, run_sssp
from graphtap_tpu_torch.engine.executor import Executor
from graphtap_tpu_torch.format.tiles import build_tileset
from graphtap_tpu_torch.ingest import rmat_edges
from graphtap_tpu_torch.kernels import onehot_spmv, panel_kernels
from graphtap_tpu_torch.kernels.semiring import inf_of, min_plus
from graphtap_tpu_torch.parallel.layout import Partition
from graphtap_tpu_torch.tools import timing

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import reference_sssp  # noqa: E402

SCALE = 9
N = 1 << SCALE
SEEDS = [1, 2, 3]
KERNELS = ["scan", "onehot"]
INF = float("inf")


def _config():
    """Graph500 kernel 3's graph: undirected, no self loops, parallel
    edges dropped, float weights."""
    return GraphConfig(num_vertices=N, directed=False, transpose=False,
                       self_loops=False, parallel_edges=False,
                       has_weight=True, compression=Compression.TCSC)


@pytest.fixture(scope="module", params=SEEDS)
def case(request):
    """(graph, stored rows, cols, weights, roots) of one seed: the raw
    edges weighted by their pair hash, the stored ones deduplicated."""
    r, c, _ = rmat_edges(SCALE, 16, seed=request.param)
    w = pair_weights(torch.from_numpy(r), torch.from_numpy(c)).numpy()
    g = Graph.from_edges(r, c, w, _config())
    keep = r != c
    rr, cc = np.concatenate([r[keep], c[keep]]), \
        np.concatenate([c[keep], r[keep]])
    key = np.unique(rr << 32 | cc)
    rows, cols = key >> 32, key & 0xFFFFFFFF
    sw = pair_weights(torch.from_numpy(rows), torch.from_numpy(cols))
    roots = [int(rows[0]), int(rows[len(rows) // 2])]
    return g, rows, cols, sw, roots


def _executor(g, kernel):
    return Executor(g, SSSPProgram(root=0, value_dtype=torch.float32),
                    EngineConfig(stationary=False,
                                 gather_depends_on_apply=True,
                                 ordering=Ordering.ROW),
                    kernel=kernel, device="cpu")


def _bits(t):
    return np.asarray(t, np.float32).view(np.int32)


@pytest.mark.parametrize("kernel", KERNELS)
def test_f32_sssp_matches_reference(case, kernel):
    g, rows, cols, w, roots = case
    ex = _executor(g, kernel)
    for root in roots:
        d, steps, _ = reference_sssp.sssp(rows, cols, w, N + 1, root)
        ex.program.root = root
        ex.initialize()
        ex.execute(0)
        dist = ex.state_vector()["distance"]
        assert dist.dtype == np.float32
        np.testing.assert_array_equal(_bits(dist), _bits(d.numpy()))
        assert ex.iteration == steps > 3
    # run_sssp's own path: the same bits
    ex2 = run_sssp(g, roots[0], kernel=kernel, device="cpu",
                   value_dtype=torch.float32)
    d, steps, _ = reference_sssp.sssp(rows, cols, w, N + 1, roots[0])
    np.testing.assert_array_equal(_bits(ex2.state_vector()["distance"]),
                                  _bits(d.numpy()))
    assert ex2.iteration == steps
    assert "Distance=INF" in ex2.display(N + 1) or not np.isinf(d).any()


def test_float_weights_survive_tiling(case):
    g, *_ = case
    t = g.tiled()
    n = int(t.nnz[0, 0])
    assert t.weights.dtype == np.float32
    rows = t.ir[0][t.rows[0, :n]]
    want = pair_weights(torch.from_numpy(rows.astype(np.int64)),
                        torch.from_numpy(t.cols[0, :n].astype(np.int64)))
    np.testing.assert_array_equal(t.weights[0, :n], want.numpy())
    j = j_build_tileset(g.r, g.c, g.w, JPartition.build(N + 1, 1, 1),
                        compression=JCompression.TCSC, parallel_edges=False,
                        weight_dtype=np.float32)
    for f in ("rows", "cols", "weights", "nnz", "ja", "ir", "iv_dense"):
        a, b = getattr(t, f), np.asarray(getattr(j, f))
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f


@pytest.mark.parametrize("compression", ["TCSC", "CSC"])
def test_int_weighted_dedup_tiles_match_jax(compression):
    """Parallel edges of unequal int weights keep the least, as the JAX
    package's build does, byte for byte."""
    rng = np.random.default_rng(5)
    n, e = 700, 9000
    r = rng.integers(0, n, e)
    c = rng.integers(0, n, e)
    r[: e // 3], c[: e // 3] = r[e // 3: 2 * (e // 3)], \
        c[e // 3: 2 * (e // 3)]                      # many parallel edges
    w = rng.integers(1, 129, e).astype(np.uint32)
    ts = build_tileset(r, c, w, Partition.build(n, 1, 1),
                       compression=Compression[compression],
                       parallel_edges=False)
    j = j_build_tileset(r, c, w, JPartition.build(n, 1, 1),
                        compression=JCompression[compression],
                        parallel_edges=False)
    assert ts.weights.dtype == np.int32
    for f in ("rows", "cols", "weights", "nnz", "ja"):
        a, b = getattr(ts, f), np.asarray(getattr(j, f))
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f


def test_min_plus_float_keeps_inf():
    sem = min_plus(inf_of(torch.float32))
    assert sem.identity == INF and inf_of(torch.int32) == 2147483647
    x = torch.tensor([INF, 1.0, 0.0])
    out = sem.mul(x, torch.tensor([0.5, 0.25, 0.75]))
    assert out.tolist() == [INF, 1.25, 0.75]
    y = sem.segment_reduce(out, torch.tensor([0, 0, 2]), 4)
    assert y.tolist() == [1.25, INF, 0.75, INF]
    assert sem.identity_like(torch.float32).item() == INF


@pytest.mark.parametrize("kind", ["min", "max"])
def test_k5_takes_f32_min_max(kind):
    """K5's wrapper folds f32 min and max (its plain version on the
    CPU); f64 min stays refused, and the check shared with K3 and K8 is
    unchanged."""
    rng = np.random.default_rng(0)
    nblocks, nchunks = 3, 4
    ep = nchunks * onehot_spmv.CHUNK
    contrib = torch.from_numpy(rng.random(ep).astype(np.float32))
    lrows = torch.from_numpy(rng.integers(0, 128, ep).astype(np.int32))
    cb = torch.tensor([0, 0, 2, 2], dtype=torch.int32)
    ident = INF if kind == "min" else -INF
    y = onehot_spmv.segment_reduce(contrib, lrows, cb, nblocks, 300, kind,
                                   ident)
    blk = torch.repeat_interleave(cb.long(), onehot_spmv.CHUNK)
    seg = blk * 128 + lrows.long()
    want = torch.full((nblocks * 128,), ident).scatter_reduce_(
        0, seg, contrib, "amin" if kind == "min" else "amax")[:300]
    assert torch.equal(y, want)
    assert y[128:256].tolist() == [ident] * 128      # block 1 has no chunk
    with pytest.raises(ValueError):
        onehot_spmv.segment_reduce(contrib.double(), lrows, cb, nblocks,
                                   300, kind, ident)
    assert panel_kernels._REDUCE_OK[torch.float32] == ("sum",)


@pytest.mark.parametrize("kernel", KERNELS)
def test_edge_counters(case, kernel, monkeypatch):
    g, rows, cols, w, roots = case
    ex = _executor(g, kernel)
    nnz = int(ex.tiles.nnz[0, 0])
    assert nnz == len(rows)
    for root in roots:
        _, steps, frontier = reference_sssp.sssp(rows, cols, w, N + 1, root)
        ex.program.root = root
        with timing.tracing() as tr:
            ex.initialize()
            ex.execute(0)
        assert ex.iteration == steps
        assert tr.counters["frontier_edges"] == frontier
        assert tr.counters["relaxed_edges"] == nnz * steps
        assert 0 < frontier <= nnz * steps
    # no tracer: no count, and the vote is C.any() alone
    seen = []
    monkeypatch.setattr(ex, "_frontier_edges",
                        lambda *a: pytest.fail("counted with no tracer"))
    voted = ex._voted
    monkeypatch.setattr(ex, "_voted",
                        lambda C, frontier=None: seen.append(frontier)
                        or voted(C, frontier))
    assert timing.current() is None
    ex.initialize()
    ex.execute(0)
    assert seen and all(f is None for f in seen)
    # fixed iterations have no vote: nothing counted under a tracer
    with timing.tracing() as tr:
        ex.initialize()
        ex.execute(2)
    assert not {"frontier_edges", "relaxed_edges"} & set(tr.counters)
