"""TCSC_CF (computation filtering) and the reference's PageRank entry
points on the port, on the CPU, against the JAX package and the f64 NumPy
golden model (tests/golden.py), on generated graphs.

  * ``classify_vertices`` and the four CF tilesets (full, first, middle,
    last) byte-identical to the JAX package's; the TCSC_CF main tiles
    equal the TCSC ones;
  * CF PageRank (pr.cpp's config, f64, 20 iterations) on scan, onehot,
    shuffle and panel equal to ``golden.pagerank`` at rtol 1e-10, through
    the phases first, middle x 18, last; equal to the JAX CF executor on a
    1x1 mesh (scan; panel in interpret mode, 3 iterations);
  * convergence mode takes as many iterations as the JAX CF run;
  * ``Graph.load`` of a written binary equals ``Graph.from_edges``;
    ``run_pagerank_two_load`` equals the JAX one; the ``pr``, ``pr1`` and
    ``deg`` mains print the five oracle lines;
  * the plan cache keys on the CF phase; ``phase_plans`` and ``free``.
"""

import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from graphtap_tpu.apps.degree import DegreeProgram as JDegreeProgram
from graphtap_tpu.apps.pagerank import PageRankProgram as JPageRankProgram
from graphtap_tpu.apps.pagerank import run_pagerank as j_run_pagerank
from graphtap_tpu.apps.pagerank import \
    run_pagerank_two_load as j_run_pagerank_two_load
from graphtap_tpu.config import Compression as JCompression
from graphtap_tpu.config import EngineConfig as JEngineConfig
from graphtap_tpu.config import GraphConfig as JGraphConfig
from graphtap_tpu.config import Ordering as JOrdering
from graphtap_tpu.engine.executor import Executor as JExecutor
from graphtap_tpu.format import tiles as jtiles
from graphtap_tpu.ingest.graph import Graph as JGraph
from graphtap_tpu.parallel.layout import make_mesh

from graphtap_tpu_torch import (Compression, EngineConfig, Graph,
                                GraphConfig, Ordering)
from graphtap_tpu_torch.apps import (DegreeProgram, PageRankProgram,
                                     run_pagerank, run_pagerank_two_load)
from graphtap_tpu_torch.engine.executor import Executor
from graphtap_tpu_torch.format import tiles as ttiles
from graphtap_tpu_torch.ingest import rmat_edges
from graphtap_tpu_torch.ingest.io import write_binary
from graphtap_tpu_torch.kernels.panel_meta import build_spmv3_meta
from graphtap_tpu_torch.tools import artifact_cache

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import golden  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 1024
ITERS = 20
PHASES = ("full", "first", "middle", "last")
TILE_FIELDS = ("rows", "cols", "weights", "nnz", "ja", "ir", "iv_dense",
               "nnzrows", "i_own", "j_own", "regular_own", "source_own",
               "sink_own", "nnzcols")


def _cfg(n=N, comp=Compression.TCSC_CF, **kw):
    return GraphConfig(num_vertices=n, transpose=True, compression=comp, **kw)


def _jcfg(n=N, comp=JCompression.TCSC_CF):
    return JGraphConfig(num_vertices=n, transpose=True, compression=comp)


def _mesh():
    return make_mesh(jax.devices()[:1], shape=(1, 1))


@pytest.fixture(scope="module")
def rmat10():
    r, c, _ = rmat_edges(10, 16, seed=1)
    return r, c, golden.pagerank(r, c, N + 1, ITERS)


def _same_tiles(a, b):
    assert (a.Ep, a.NR, a.nnz_total) == (b.Ep, b.NR, b.nnz_total)
    for f in TILE_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        if x is None or y is None:
            assert x is None and y is None, f
            continue
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape, f
        assert x.tobytes() == y.tobytes(), f


def test_cf_tilesets_match_jax(rmat10):
    r, c, _ = rmat10
    g = Graph.from_edges(r, c, None, _cfg())
    jg = JGraph.from_edges(r, c, None, _jcfg(), mesh=_mesh())
    mine, theirs = g.tiled_cf(), jg.tiled_cf()
    for ph in PHASES:
        _same_tiles(mine[ph], theirs[ph])
    assert mine["first"].nnz_total < mine["full"].nnz_total
    # the stored matrix is the transpose: rows = dst, cols = src
    n_pad = g.part.n_pad
    cls, jcls = (ttiles.classify_vertices(g.r, g.c, n_pad),
                 jtiles.classify_vertices(jg.r, jg.c, n_pad))
    assert cls.keys() == jcls.keys()
    for k in cls:
        np.testing.assert_array_equal(cls[k], jcls[k])
    # TCSC_CF renumbers as TCSC does: its main tiles are TCSC's, byte for
    # byte, in both orderings
    t = Graph.from_edges(r, c, None, _cfg(comp=Compression.TCSC))
    for o in (Ordering.ROW, Ordering.COL):
        _same_tiles(g.tiled(o), t.tiled(o))
    assert g.tiled() is g.tiled()            # built once per ordering


@pytest.mark.parametrize("kernel", ["scan", "onehot", "shuffle", "panel"])
def test_cf_pagerank_matches_golden(rmat10, kernel):
    r, c, gold = rmat10
    g = Graph.from_edges(r, c, None, _cfg())
    ex = run_pagerank(g, ITERS, torch.float64, kernel=kernel, device="cpu",
                      degree_kernel="scan")
    np.testing.assert_allclose(ex.state_vector()["rank"], gold, rtol=1e-10,
                               atol=0)
    assert [s["phase"] for s in ex.supersteps] == (
        ["first"] + ["middle"] * (ITERS - 2) + ["last"])
    assert [s["phase"] for s in ex.degree_phase.supersteps] == ["main"]
    # the phases' arrays are counted once built; free() drops them all
    assert ex.device_bytes > sum(
        v.numel() * v.element_size() for v in ex._dev.values()
        if isinstance(v, torch.Tensor))
    ex.free()
    with pytest.raises(RuntimeError, match="free"):
        ex.execute(ITERS)


def test_cf_pagerank_scan_matches_jax(rmat10):
    r, c, _ = rmat10
    jex = j_run_pagerank(JGraph.from_edges(r, c, None, _jcfg(), mesh=_mesh()),
                         ITERS, jnp.float64, kernel="scan")
    ex = run_pagerank(Graph.from_edges(r, c, None, _cfg()), ITERS,
                      torch.float64, kernel="scan", device="cpu",
                      degree_kernel="scan")
    np.testing.assert_allclose(ex.state_vector()["rank"],
                               jex.state_vector()["rank"], rtol=1e-13, atol=0)
    assert ex.checksum()[1] == jex.checksum()[1]


def test_cf_pagerank_panel_matches_jax_interpret():
    """The JAX CF executor on the panel kernel (Pallas in interpret mode),
    3 iterations (first, middle, last) on RMAT-8, against the port's panel
    run with the same degrees."""
    r, c, _ = rmat_edges(8, 16, seed=1)
    n = 256
    jg = JGraph.from_edges(r, c, None, _jcfg(n), mesh=_mesh())
    jdeg = JExecutor(jg, JDegreeProgram(jnp.float64),
                     JEngineConfig(stationary=True, ordering=JOrdering.COL),
                     kernel="scan")
    jdeg.initialize()
    jdeg.execute(1)
    jex = JExecutor(jg, JPageRankProgram(jnp.float64),
                    JEngineConfig(stationary=True, ordering=JOrdering.ROW),
                    kernel="panel")
    jex.initialize(other=jdeg)
    jex.execute(3)
    ex = run_pagerank(Graph.from_edges(r, c, None, _cfg(n)), 3,
                      torch.float64, kernel="panel", device="cpu",
                      degree_kernel="scan")
    np.testing.assert_array_equal(ex.degree_phase.state_vector()["degree"],
                                  jdeg.state_vector()["degree"])
    np.testing.assert_allclose(ex.state_vector()["rank"],
                               jex.state_vector()["rank"], rtol=1e-13, atol=0)


def test_cf_convergence_matches_jax(rmat10):
    """execute(0) on a CF graph: a first step, middle steps with the
    regular-rows vote, the flush on last — as many iterations as the JAX
    CF run, and within the tolerance of the port's TCSC run."""
    r, c, _ = rmat10
    jex = j_run_pagerank(JGraph.from_edges(r, c, None, _jcfg(), mesh=_mesh()),
                         0, jnp.float64, kernel="scan")
    ex = run_pagerank(Graph.from_edges(r, c, None, _cfg()), 0, torch.float64,
                      kernel="onehot", device="cpu", degree_kernel="scan")
    assert ex.iteration == jex.iteration > 1
    np.testing.assert_allclose(ex.state_vector()["rank"],
                               jex.state_vector()["rank"], rtol=1e-12, atol=0)
    assert ex.supersteps[0]["phase"] == "first"
    assert {s["phase"] for s in ex.supersteps[1:]} == {"middle"}
    tcsc = run_pagerank(Graph.from_edges(r, c, None,
                                         _cfg(comp=Compression.TCSC)),
                        0, torch.float64, kernel="onehot", device="cpu",
                        degree_kernel="scan")
    np.testing.assert_allclose(ex.state_vector()["rank"],
                               tcsc.state_vector()["rank"], rtol=0, atol=2e-5)


@pytest.fixture(scope="module")
def edge_file(tmp_path_factory, rmat10):
    path = tmp_path_factory.mktemp("edges") / "rmat10.bin"
    write_binary(str(path), rmat10[0], rmat10[1])
    return str(path)


@pytest.mark.parametrize("weighted", [False, True])
def test_graph_load_matches_from_edges(tmp_path, weighted):
    r, c, w = rmat_edges(9, 16, seed=2, weighted=weighted)
    path = str(tmp_path / "g.bin")
    write_binary(path, r, c, w)
    cfg = _cfg(512, has_weight=weighted)
    loaded, built = Graph.load(path, cfg), Graph.from_edges(r, c, w, cfg)
    np.testing.assert_array_equal(loaded.r, built.r)
    np.testing.assert_array_equal(loaded.c, built.c)
    if weighted:
        np.testing.assert_array_equal(loaded.w, built.w)
    else:
        assert loaded.w is None and built.w is None
    _same_tiles(loaded.tiled(), built.tiled())


def test_two_load_matches_jax(edge_file, rmat10):
    ex = run_pagerank_two_load(edge_file, N, ITERS, torch.float64,
                               kernel="scan", device="cpu",
                               degree_kernel="scan")
    jex = j_run_pagerank_two_load(edge_file, N, ITERS, jnp.float64,
                                  mesh=_mesh(), kernel="scan")
    np.testing.assert_allclose(ex.state_vector()["rank"],
                               jex.state_vector()["rank"], rtol=1e-13, atol=0)
    np.testing.assert_allclose(ex.state_vector()["rank"], rmat10[2],
                               rtol=1e-10, atol=0)
    assert ex.degree_phase.graph.config.transpose is False


@pytest.mark.parametrize("app", ["pr", "pr1", "deg"])
def test_cli_prints_oracle_lines(edge_file, rmat10, app):
    res = subprocess.run(
        [sys.executable, "-m", f"graphtap_tpu_torch.apps.{app}", edge_file,
         str(N), str(ITERS), "--device", "cpu"], cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO), capture_output=True,
        text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    balance, *lines = res.stdout.strip().splitlines()
    assert balance.startswith("Edge balance: edges=")
    assert [ln.split(":")[0] for ln in lines] == [
        f"{app} end-to-end time", "Execute time", "Iterations",
        "Value checksum", "Reachable vertices"]
    fields = {ln.split(":")[0]: ln.split(":")[1].split()[0] for ln in lines}
    if app == "deg":
        assert fields["Iterations"] == "1"
        assert float(fields["Value checksum"]) == rmat10[0].size
    else:
        assert fields["Iterations"] == str(ITERS)
        gold = rmat10[2].sum()
        assert abs(float(fields["Value checksum"]) - gold) <= 1e-4 * gold
        assert fields["Reachable vertices"] == str(N + 1)


def test_cf_phase_plans_and_cache_key(tmp_path):
    """Prebuilt phase plans (from the cache, keyed by phase) give the
    same run as plans built by the executor; the three phases' keys and
    plans differ; a phase_plans on a TCSC graph, or an unknown phase,
    raises."""
    r, c, _ = rmat_edges(8, 16, seed=1)
    cfg = _cfg(256)
    g = Graph.from_edges(r, c, None, cfg)
    cf = g.tiled_cf()
    keys = {ph: artifact_cache.meta_key(8, 16, 1, cfg, Ordering.ROW,
                                        np.float64, False, phase=ph)
            for ph in ("main", "first", "middle", "last")}
    assert len(set(keys.values())) == 4
    with pytest.raises(ValueError):
        artifact_cache.meta_key(8, 16, 1, cfg, Ordering.ROW, np.float64,
                                False, phase="full")
    plans = {ph: artifact_cache.cached_spmv3_meta(
        cf[ph], 8, 16, 1, cfg, Ordering.ROW, np.float64, cache_dir=tmp_path,
        phase=ph) for ph in ("first", "middle", "last")}
    assert len(list(tmp_path.iterdir())) == 3
    assert cf["middle"].nnz_total < cf["first"].nnz_total
    deg = Executor(g, DegreeProgram(torch.float64),
                   EngineConfig(stationary=True, ordering=Ordering.COL),
                   kernel="scan", device="cpu")
    deg.initialize()
    deg.execute(1)
    runs = []
    for pp in (plans, None):
        ex = Executor(g, PageRankProgram(torch.float64),
                      EngineConfig(stationary=True, ordering=Ordering.ROW),
                      kernel="panel", device="cpu", phase_plans=pp)
        ex.initialize(other=deg)
        ex.execute(4)
        runs.append(ex.state["rank"])
    assert torch.equal(runs[0], runs[1])
    fresh = build_spmv3_meta(cf["middle"], value_dtype=np.float64)
    for k in fresh.arrays:
        np.testing.assert_array_equal(plans["middle"].arrays[k],
                                      fresh.arrays[k])
    with pytest.raises(ValueError, match="phase_plans"):
        Executor(g, PageRankProgram(torch.float64), kernel="panel",
                 device="cpu", phase_plans={"full": plans["first"]})
    t = Graph.from_edges(r, c, None, _cfg(256, comp=Compression.TCSC))
    with pytest.raises(ValueError, match="phase_plans"):
        Executor(t, PageRankProgram(torch.float64), kernel="panel",
                 device="cpu", phase_plans=plans)
    # a 1-iteration CF run (the degree phase) runs the main tiles only
    one = Executor(g, PageRankProgram(torch.float64), kernel="scan",
                   device="cpu")
    one.initialize(other=types.SimpleNamespace(state=deg.state))
    one.execute(1)
    assert [s["phase"] for s in one.supersteps] == ["main"]


@pytest.fixture(scope="module")
def rmat12_f32_jax():
    """RMAT-12 f32 PageRank to convergence on the JAX package: scan on
    TCSC, and onehot (K5 in interpret mode) on TCSC_CF: (edges, n,
    {compression value: (iterations, checksum)})."""
    r, c, _ = rmat_edges(12, 16, seed=1)
    n = 1 << 12
    runs = {}
    for comp, kernel in ((JCompression.TCSC, "scan"),
                         (JCompression.TCSC_CF, "onehot")):
        jex = j_run_pagerank(JGraph.from_edges(
            r, c, None, _jcfg(n, comp), mesh=_mesh()), 0, jnp.float32,
            kernel=kernel)
        runs[comp.value] = (jex.iteration, jex.checksum()[0])
    return r, c, n, runs


@pytest.mark.parametrize("kernel,comp", [
    ("scan", Compression.TCSC), ("onehot", Compression.TCSC),
    ("shuffle2", Compression.TCSC), ("panel", Compression.TCSC),
    ("onehot", Compression.TCSC_CF)])
def test_f32_convergence_settles_as_jax(rmat12_f32_jax, kernel, comp):
    """f32 execute(0): the absolute vote (|new - old| > 1e-5) closes on
    the plain versions, whose float folds run in the CUDA kernels' fixed
    order (kernels/fold_order.py), within 2 iterations of the JAX
    package's run, the checksum within 1e-4 relative. The reference is
    the JAX scan on TCSC, and on TCSC_CF the JAX onehot, the same kernel:
    f32 rounding alone moves the vote by a few iterations (on TCSC_CF the
    JAX scan settles in 82, its onehot in 81, the port's onehot in 79)."""
    r, c, n, runs = rmat12_f32_jax
    jit, jsum = runs[comp.value]
    ex = run_pagerank(Graph.from_edges(r, c, None, _cfg(n, comp)), 0,
                      torch.float32, kernel=kernel, device="cpu",
                      degree_kernel="scan")
    assert abs(ex.iteration - jit) <= 2, (ex.iteration, jit)
    assert abs(ex.checksum()[0] - jsum) <= 1e-4 * jsum
    assert ex.checksum()[1] == n + 1
