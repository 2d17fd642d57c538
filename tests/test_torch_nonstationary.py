"""BFS, CC and SSSP through the port, to convergence on the CPU (plain
kernels), on ``rmat_edges(10, 16, seed=1)`` read through each app's own
config: equal to the NumPy golden models (``tests/golden.py``) bit for
bit on the panel and scan kernels, and to the JAX package's apps (BFS on
its panel kernel, CC and SSSP on scan) in state and iteration count. Also
the ``GRAPHTAP_PANEL_GATE`` switch and PageRank run to convergence."""

import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from graphtap_tpu.apps import bfs as jbfs
from graphtap_tpu.apps import cc as jcc
from graphtap_tpu.apps import sssp as jsssp
from graphtap_tpu.apps.pagerank import run_pagerank as j_run_pagerank
from graphtap_tpu.config import GraphConfig as JGraphConfig
from graphtap_tpu.ingest.graph import Graph as JGraph
from graphtap_tpu.parallel.layout import make_mesh

from graphtap_tpu_torch import EngineConfig, Graph, GraphConfig
from graphtap_tpu_torch.apps import (BFSProgram, bfs_config, cc_config,
                                     run_bfs, run_cc, run_pagerank, run_sssp,
                                     sssp_config)
from graphtap_tpu_torch.engine.executor import GATE_ENV, Executor
from graphtap_tpu_torch.ingest import rmat_edges

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import golden  # noqa: E402

N = 1024


@pytest.fixture(scope="module")
def edges():
    r, c, _ = rmat_edges(10, 16, seed=1)
    rw, cw, w = rmat_edges(10, 16, seed=1, weighted=True)
    return (r.astype(np.int64), c.astype(np.int64)), \
        (rw.astype(np.int64), cw.astype(np.int64), w)


def _graph(app, edges):
    (r, c), (rw, cw, w) = edges
    if app == "bfs":
        return Graph.from_edges(r, c, None, bfs_config(N))
    if app == "cc":
        return Graph.from_edges(r, c, None, cc_config(N))
    return Graph.from_edges(rw, cw, w, sssp_config(N))


def _run(app, g, kernel):
    if app == "bfs":
        return run_bfs(g, 0, kernel=kernel, device="cpu")
    if app == "cc":
        return run_cc(g, kernel=kernel, device="cpu")
    return run_sssp(g, 0, kernel=kernel, device="cpu")


@pytest.fixture(scope="module")
def golden_states(edges):
    (r, c), (rw, cw, w) = edges
    parent, hops = golden.bfs(r, c, N + 1, 0)
    return {"bfs": {"parent": parent, "hops": hops},
            "cc": {"label": golden.cc(r, c, N + 1)},
            "sssp": {"distance": golden.sssp(rw, cw, w.astype(np.int64),
                                             N + 1, 0)}}


@pytest.mark.parametrize("kernel", ["panel", "scan"])
@pytest.mark.parametrize("app", ["bfs", "cc", "sssp"])
def test_app_matches_golden(edges, golden_states, app, kernel):
    ex = _run(app, _graph(app, edges), kernel)
    sv = ex.state_vector()
    for k, want in golden_states[app].items():
        assert sv[k].dtype == np.int32
        np.testing.assert_array_equal(sv[k], want, err_msg=k)
    assert ex.iteration == len(ex.supersteps) > 1
    if kernel == "panel":
        assert all(s["gated"] in (True, False) for s in ex.supersteps)
    else:
        assert all(s["gated"] is None for s in ex.supersteps)
    if app == "bfs":
        # golden.bfs runs one level per frontier; the engine adds the
        # superstep that finds nothing new
        assert ex.iteration == int(sv["hops"][sv["hops"] < golden.INF]
                                   .max()) + 1
        assert ex.checksum() == (1304.0, 886)


def _jax_graph(edges, cfg_fn, weighted=False):
    (r, c), (rw, cw, w) = edges
    mesh = make_mesh(jax.devices()[:1], shape=(1, 1))
    if weighted:
        return JGraph.from_edges(rw, cw, w, cfg_fn(N), mesh=mesh)
    return JGraph.from_edges(r, c, None, cfg_fn(N), mesh=mesh)


def _same_states(port_ex, jax_ex):
    mine, theirs = port_ex.state_vector(), jax_ex.state_vector()
    assert mine.keys() == theirs.keys()
    for k in mine:
        np.testing.assert_array_equal(mine[k], np.asarray(theirs[k]),
                                      err_msg=k)
    assert port_ex.iteration == jax_ex.iteration


def test_bfs_panel_matches_jax_panel(edges):
    jex = jbfs.run_bfs(_jax_graph(edges, jbfs.bfs_config), 0,
                       kernel="panel")
    _same_states(run_bfs(_graph("bfs", edges), 0, kernel="panel",
                         device="cpu"), jex)


@pytest.mark.parametrize("app", ["cc", "sssp"])
def test_cc_sssp_match_jax_scan(edges, app):
    if app == "cc":
        jex = jcc.run_cc(_jax_graph(edges, jcc.cc_config), kernel="scan")
    else:
        jex = jsssp.run_sssp(_jax_graph(edges, jsssp.sssp_config, True), 0,
                             kernel="scan")
    _same_states(_run(app, _graph(app, edges), "panel"), jex)


def test_gate_switch(edges, monkeypatch):
    g = _graph("bfs", edges)
    states, branches = {}, {}
    for value in ("0", "1", "auto", None):
        if value is None:
            monkeypatch.delenv(GATE_ENV, raising=False)
        else:
            monkeypatch.setenv(GATE_ENV, value)
        ex = run_bfs(g, 0, kernel="panel", device="cpu")
        states[value] = ex.state_vector()
        branches[value] = {s["gated"] for s in ex.supersteps}
    for value in ("1", "auto", None):
        for k in states["0"]:
            np.testing.assert_array_equal(states[value][k], states["0"][k])
    assert branches["0"] == {False} and branches["1"] == {True}
    monkeypatch.setenv(GATE_ENV, "yes")
    with pytest.raises(ValueError, match=GATE_ENV):
        Executor(g, BFSProgram(0), kernel="panel", device="cpu")
    # read once, at construction: a later change does not reach the run
    monkeypatch.setenv(GATE_ENV, "1")
    ex = Executor(g, BFSProgram(0), EngineConfig(stationary=False),
                  kernel="panel", device="cpu")
    monkeypatch.setenv(GATE_ENV, "bogus")
    ex.execute(0)
    assert {s["gated"] for s in ex.supersteps} == {True}


def test_nonstationary_fixed_iterations_and_limits(edges, golden_states):
    g = _graph("bfs", edges)
    ex = Executor(g, BFSProgram(0), EngineConfig(stationary=False),
                  kernel="panel", device="cpu")
    ex.execute(2)                        # two levels, no vote, no flush
    hops = ex.state_vector()["hops"]
    want = golden_states["bfs"]["hops"]
    np.testing.assert_array_equal(hops, np.where(want <= 2, want,
                                                 golden.INF))
    # the sparse exchange (K = 256) gives the same two levels bit for bit
    sp = Executor(g, BFSProgram(0), EngineConfig(
        stationary=False, sparse_exchange_capacity=256), kernel="panel",
        device="cpu")
    sp.execute(2)
    np.testing.assert_array_equal(sp.state_vector()["hops"], hops)
    assert all(rec["sparse"] in (True, False) for rec in sp.supersteps)


def test_pagerank_converges_like_jax_scan():
    r, c, _ = rmat_edges(10, 16, seed=1)
    g = Graph.from_edges(r, c, None, GraphConfig(num_vertices=N,
                                                 transpose=True))
    jg = JGraph.from_edges(r, c, None,
                           JGraphConfig(num_vertices=N, transpose=True),
                           mesh=make_mesh(jax.devices()[:1], shape=(1, 1)))
    jex = j_run_pagerank(jg, 0, jnp.float64, kernel="scan")
    for kernel in ("scan", "panel"):
        ex = run_pagerank(g, 0, torch.float64, kernel=kernel, device="cpu")
        assert ex.iteration == jex.iteration > 1
        np.testing.assert_allclose(ex.state_vector()["rank"],
                                   np.asarray(jex.state_vector()["rank"]),
                                   rtol=1e-12, atol=0)
