"""PageRank as pr.cpp runs it (TCSC_CF, to tolerance 1e-5) on the port, on
the CPU at RMAT-12, Graph500's generator (``benchmark/graph500.py``):

  * float64 runs to convergence on onehot's plain path and on scan take
    the superstep count of the plain reference
    (``benchmark/reference/pagerank_cf.py``) and its ranks at rtol 1e-10,
    through the phases first, middle until the vote, then the flush;
  * the phase tilesets taken from the main tiles' sorted edges
    (``Graph.tiled_cf``, ``format/tiles.py::build_cf_subsets``) equal
    ``build_cf_tilesets`` built from scratch, byte for byte, in both
    orderings, weighted and with parallel edges dropped too;
  * under an open tracer ``cf_phase_edges`` adds up to first + (n - 1) x
    middle + last stored edges for a run of n supersteps and its flush
    (first + (n - 2) x middle + last for n fixed supersteps, nothing on
    TCSC), and the phases' build is a ``cf_phases`` span with its
    ``tiles``, ``plans`` and ``upload`` children and a ``tiles.cf_subset``
    span a phase.
"""

import numpy as np
import pytest
import torch

from benchmark import graph500
from benchmark.reference import pagerank_cf as reference
from graphtap_tpu_torch import Compression, Graph, GraphConfig, Ordering
from graphtap_tpu_torch.apps import run_pagerank
from graphtap_tpu_torch.format import tiles as ttiles
from graphtap_tpu_torch.tools import timing

SCALE = 12
NV = (1 << SCALE) + 1
PR_GRAPH = {"directed": True, "transpose": True, "self_loops": True,
            "acyclic": False, "parallel_edges": True}
TILE_FIELDS = ("rows", "cols", "weights", "nnz", "ja", "ir", "iv_dense",
               "nnzrows", "i_own", "j_own", "regular_own", "source_own",
               "sink_own", "nnzcols", "jc", "dev_nnz")


def _raw(seed):
    r, c = graph500.kronecker_edges(SCALE, 16, 0.57, 0.19, 0.19,
                                    graph500.uniforms(seed,
                                                      torch.device("cpu")))
    return r.numpy(), c.numpy()


def _graph(r, c, w=None, **kw):
    return Graph.from_edges(r, c, w, GraphConfig(
        num_vertices=1 << SCALE, transpose=True,
        compression=Compression.TCSC_CF, **kw))


@pytest.fixture(scope="module")
def rmat12():
    r, c = _raw(1)
    rows, cols = graph500.stored_edges(r, c, PR_GRAPH)
    ref = reference.Reference(rows, cols, NV, 0.15, 1e-5)
    return r, c, ref


@pytest.mark.parametrize("kernel", ["onehot", "scan"])
def test_cf_converges_as_the_reference(rmat12, kernel):
    r, c, ref = rmat12
    ex = run_pagerank(_graph(r, c), 0, torch.float64, kernel=kernel,
                      device="cpu", degree_kernel="scan")
    assert ex.iteration == ref.supersteps > 50
    assert [s["phase"] for s in ex.supersteps] == (
        ["first"] + ["middle"] * (ref.supersteps - 1))
    sv = ex.state_vector()
    np.testing.assert_allclose(sv["rank"], ref.rank, rtol=1e-10, atol=0)
    np.testing.assert_array_equal(sv["degree"], ref.handed)
    assert ref.compare({**sv, "supersteps": ex.iteration},
                       ex.degree_phase.state_vector()["degree"]) == {
        "degree_mismatch": 0, "rank_rel_err": pytest.approx(0, abs=1e-10),
        "supersteps_off": 0}


def _same_tiles(a, b):
    assert (a.Ep, a.NR, a.nnz_total) == (b.Ep, b.NR, b.nnz_total)
    for f in TILE_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        if x is None or y is None:
            assert x is None and y is None, f
            continue
        assert x.dtype == y.dtype and x.shape == y.shape, f
        assert x.tobytes() == y.tobytes(), f


@pytest.mark.parametrize("seed,weighted", [(1, False), (2, False),
                                           (3, True), (4, True)])
def test_cf_subsets_equal_the_build_from_scratch(seed, weighted):
    """Weighted seeds drop parallel edges (each run keeps its least
    weight) and self loops."""
    r, c = _raw(seed)
    w, kw = None, {}
    if weighted:
        w = np.random.default_rng(seed).random(r.size).astype(np.float32)
        kw = dict(has_weight=True, self_loops=False, parallel_edges=False)
    for o in (Ordering.ROW, Ordering.COL):
        g = _graph(r, c, w, **kw)
        mine = g.tiled_cf(o)
        assert mine["full"] is g.tiled(o)
        assert o not in g._cf_sorted
        rr, cc, ww = g._oriented(o)
        scratch = ttiles.build_cf_tilesets(
            rr, cc, ww, g.part, parallel_edges=g.config.parallel_edges,
            edge_align=g.config.edge_align, weight_dtype=g._weight_dtype)
        for ph in ("full", "first", "middle", "last"):
            _same_tiles(mine[ph], scratch[ph])
        assert mine["middle"].nnz_total < mine["first"].nnz_total
    # a TCSC build keeps no sorted edges
    g = Graph.from_edges(r, c, None, GraphConfig(num_vertices=1 << SCALE,
                                                 transpose=True))
    g.tiled()
    assert not g._cf_sorted


def test_cf_phase_edges_and_spans(rmat12):
    r, c, ref = rmat12
    g = _graph(r, c)
    with timing.tracing() as tr:
        ex = run_pagerank(g, 0, torch.float32, kernel="onehot",
                          device="cpu", degree_kernel="scan")
    nnz = {ph: int(ts.nnz[0, 0]) for ph, ts in g.tiled_cf().items()}
    n = ex.iteration
    assert tr.counters["cf_phase_edges"] == (
        nnz["first"] + (n - 1) * nnz["middle"] + nnz["last"])
    assert nnz["middle"] < nnz["first"] <= nnz["full"]
    spans = tr.summary()["spans"]
    for name, count in (("cf_phases", 1), ("cf_phases.tiles", 1),
                        ("cf_phases.plans", 3), ("cf_phases.upload", 3),
                        ("tiles.cf_subset", 3)):
        assert spans[name]["n"] == count, name
    kids = {sp.name for sp in tr.spans
            if sp.parent >= 0 and tr.spans[sp.parent].name == "cf_phases"}
    assert kids == {"cf_phases.tiles", "cf_phases.plans",
                    "cf_phases.upload"}
    assert [sp.attrs["phase"] for sp in tr.spans
            if sp.name == "tiles.cf_subset"] == ["first", "middle", "last"]
    assert set(ex.timings) >= {"cf_tiles", "cf_plans", "cf_upload"}
    # a fixed run: first, n - 2 middles, last, no flush
    with timing.tracing() as tr:
        ex.initialize(other=ex.degree_phase)
        ex.execute(5)
    assert tr.counters["cf_phase_edges"] == (
        nnz["first"] + 3 * nnz["middle"] + nnz["last"])
    assert "cf_phases" not in tr.summary()["spans"]     # built once
    # TCSC runs no phase and counts nothing
    with timing.tracing() as tr:
        run_pagerank(Graph.from_edges(r, c, None, GraphConfig(
            num_vertices=1 << SCALE, transpose=True)), 3, torch.float32,
            kernel="scan", device="cpu", degree_kernel="scan")
    assert "cf_phase_edges" not in tr.counters
