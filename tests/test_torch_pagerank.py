"""PageRank through the port, end to end on the CPU: the degree phase
(scan) and 20 iterations on the panel pipeline (plain kernels), against
the f64 NumPy golden model and the JAX package's run_pagerank."""

import os
import sys
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from graphtap_tpu.apps.pagerank import run_pagerank as j_run_pagerank
from graphtap_tpu.config import GraphConfig as JGraphConfig
from graphtap_tpu.ingest.graph import Graph as JGraph
from graphtap_tpu.parallel.layout import make_mesh

from graphtap_tpu_torch import (Compression, EngineConfig, Graph,
                                GraphConfig, Ordering)
from graphtap_tpu_torch.apps import PageRankProgram, run_pagerank
from graphtap_tpu_torch.engine.executor import Executor
from graphtap_tpu_torch.ingest import rmat_edges
from graphtap_tpu_torch.tools.convert import state_from_numpy

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import golden  # noqa: E402

ITERS = 20
N = 1024
CHECKSUM_RMAT10 = 708.7927994761114    # JAX panel path, 1x1 and 2x2 meshes


@pytest.fixture(scope="module")
def rmat10():
    r, c, _ = rmat_edges(10, 16, seed=1)
    g = Graph.from_edges(r, c, None, GraphConfig(num_vertices=N,
                                                 transpose=True))
    return r, c, g, golden.pagerank(r, c, N + 1, ITERS)


@pytest.fixture(scope="module")
def port_f64(rmat10):
    return run_pagerank(rmat10[2], ITERS, torch.float64, kernel="panel",
                        device="cpu")


def test_pagerank_f64_matches_golden(rmat10, port_f64):
    ex = port_f64
    rank = ex.state_vector()["rank"]
    assert np.abs(rank - rmat10[3]).max() <= 1e-12
    checksum, reach = ex.checksum()
    assert abs(checksum - CHECKSUM_RMAT10) <= 1e-9
    assert reach == N + 1
    assert ex.iteration == ITERS
    assert "vid=0: Rank=" in ex.display(3)


def test_pagerank_f64_matches_jax_panel(rmat10, port_f64):
    r, c, _, _ = rmat10
    jg = JGraph.from_edges(r, c, None,
                           JGraphConfig(num_vertices=N, transpose=True),
                           mesh=make_mesh(jax.devices()[:1], shape=(1, 1)))
    jex = j_run_pagerank(jg, ITERS, jnp.float64, kernel="panel")
    mine, theirs = port_f64.state_vector(), jex.state_vector()
    np.testing.assert_array_equal(mine["degree"], theirs["degree"])
    np.testing.assert_allclose(mine["rank"], theirs["rank"], rtol=1e-12,
                               atol=0)
    # the JAX executor's state carried over by tools/convert drives the
    # same PageRank in the port: its handed-over degrees give the same ranks
    pr = Executor(port_f64.graph, PageRankProgram(torch.float64),
                  EngineConfig(stationary=True, ordering=Ordering.ROW),
                  kernel="panel", plans=port_f64.meta, device="cpu")
    deg = state_from_numpy({"degree": np.asarray(jex.state["degree"])})
    pr.initialize(other=types.SimpleNamespace(state=deg))
    pr.execute(ITERS)
    assert torch.equal(pr.state["rank"], port_f64.state["rank"])


def test_pagerank_f32_close_to_golden(rmat10):
    ex = run_pagerank(rmat10[2], ITERS, torch.float32, kernel="panel",
                      device="cpu")
    rank = ex.state_vector()["rank"].astype(np.float64)
    want = rmat10[3]
    assert np.abs(rank - want).max() / np.abs(want).max() <= 1e-5
    checksum, _ = ex.checksum()
    assert abs(checksum - want.sum()) / want.sum() <= 1e-5


def test_pagerank_scan_kernel_matches_panel(rmat10, port_f64):
    ex = run_pagerank(rmat10[2], ITERS, torch.float64, kernel="scan",
                      device="cpu")
    np.testing.assert_allclose(ex.state_vector()["rank"],
                               port_f64.state_vector()["rank"], rtol=1e-12,
                               atol=0)


def test_executor_lifecycle_errors(rmat10, port_f64):
    g = rmat10[2]
    dcsc = Graph.from_edges(rmat10[0], rmat10[1], None, GraphConfig(
        num_vertices=N, transpose=True, compression=Compression.DCSC))
    with pytest.raises(ValueError, match="DCSC"):              # as JAX's
        Executor(dcsc, PageRankProgram(torch.float64), kernel="panel",
                 device="cpu")
    ex = Executor(g, PageRankProgram(torch.float64), kernel="scan",
                  device="cpu")
    ex.free()
    with pytest.raises(RuntimeError, match="free"):
        ex.execute(1)
    with pytest.raises(ValueError, match="unknown kernel"):
        Executor(g, PageRankProgram(torch.float64), kernel="shuffle9",
                 device="cpu")
    csc = Graph.from_edges(rmat10[0], rmat10[1], None, GraphConfig(
        num_vertices=N, transpose=True, compression=Compression.CSC))
    with pytest.raises(ValueError, match="requires TCSC"):     # as JAX's
        Executor(csc, PageRankProgram(torch.float64), kernel="shuffle",
                 device="cpu")


def test_stationary_sparse_exchange_capacity_runs_dense(rmat10):
    """A stationary program ignores ``sparse_exchange_capacity`` and
    exchanges dense, as the JAX executor does (its ``_exchange_x`` and
    ``_exchange_y`` take the dense branch for stationary programs): the
    K = 64 run equals the K = 0 run bit for bit, and the JAX executor's
    K = 64 run within the f32 tolerance of this file, and records no
    sparse branch. A nonstationary program with K > 0 takes the sparse
    exchange."""
    from graphtap_tpu.apps.degree import DegreeProgram as JDegreeProgram
    from graphtap_tpu.apps.pagerank import PageRankProgram as JPageRank
    from graphtap_tpu.config import EngineConfig as JEngineConfig
    from graphtap_tpu.config import Ordering as JOrdering
    from graphtap_tpu.engine.executor import Executor as JExecutor
    from graphtap_tpu_torch.apps import BFSProgram
    from graphtap_tpu_torch.apps.degree import run_degree

    r, c, g, _ = rmat10
    k0 = run_pagerank(g, ITERS, torch.float32, kernel="panel", device="cpu")
    deg = run_degree(g, torch.float32, Ordering.COL, "shuffle", "cpu")
    ex = Executor(g, PageRankProgram(torch.float32),
                  EngineConfig(stationary=True, ordering=Ordering.ROW,
                               sparse_exchange_capacity=64),
                  kernel="panel", device="cpu")
    ex.initialize(other=deg)
    ex.execute(ITERS)
    assert ex.iteration == ITERS
    assert torch.equal(ex.state["rank"], k0.state["rank"])
    assert torch.equal(ex.state["degree"], k0.state["degree"])

    jg = JGraph.from_edges(r, c, None,
                           JGraphConfig(num_vertices=N, transpose=True),
                           mesh=make_mesh(jax.devices()[:1], shape=(1, 1)))
    jdeg = JExecutor(jg, JDegreeProgram(value_dtype=jnp.float32),
                     JEngineConfig(stationary=True, ordering=JOrdering.COL,
                                   sparse_exchange_capacity=64),
                     kernel="scan")
    jdeg.initialize()
    jdeg.execute(1)
    jex = JExecutor(jg, JPageRank(value_dtype=jnp.float32),
                    JEngineConfig(stationary=True, ordering=JOrdering.ROW,
                                  sparse_exchange_capacity=64),
                    kernel="scan")
    jex.initialize(other=jdeg)
    jex.execute(ITERS)
    mine = ex.state_vector()
    theirs = jex.state_vector()
    np.testing.assert_array_equal(mine["degree"], theirs["degree"])
    want = np.asarray(theirs["rank"], dtype=np.float64)
    got = mine["rank"].astype(np.float64)
    assert np.abs(got - want).max() / np.abs(want).max() <= 1e-5

    assert {(rec["sparse"], rec["sparse_y"]) for rec in ex.supersteps} \
        == {(None, None)}
    bfs = Executor(g, BFSProgram(0), EngineConfig(
        stationary=False, sparse_exchange_capacity=64), device="cpu")
    bfs.execute(0)
    assert {rec["sparse"] for rec in bfs.supersteps} <= {True, False}
    assert None not in {rec["sparse_y"] for rec in bfs.supersteps}
