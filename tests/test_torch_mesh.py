"""The port on a mesh: four gloo ranks on the CPU, at 2x2 and 1x4,
against the JAX package's mesh of four CPU devices and the port's own 1x1.

Graphs: ``rmat_edges(10, 16, seed=1)`` (and its weighted twin for SSSP),
written to binary edge files that every rank reads its byte range of
(``Graph.load(..., mesh=)``), through each app's config with
``segment_align=128`` so that every shard holds vertices. One launch of
four ranks a shape (``parallel/launch.py`` running
``tools/mesh_run.py``; the ranks import no jax) runs every case of the
shape and writes its results to ``tmp_path``:

  * degree (COL, f32), PageRank in f32 and f64 (10 iterations), BFS, CC
    and SSSP on every kernel (plain versions on the CPU): equal to the
    JAX mesh's run on the scan kernel and to the port's 1x1 scan run, bit
    for bit on the integer and min semirings, elementwise within rtol
    1e-5 (f32) / 1e-12 (f64) on PageRank, checksums within 1e-6
    relative; PageRank on onehot also against the JAX mesh's onehot
    (Pallas in interpret mode), and on TCSC_CF tiles (2x2);
  * at 2x2, rank b's panel, shuffle, shuffle2 and one-hot plans equal
    row b of the JAX builders' single-process plans, byte for byte;
  * the sparse exchange, BFS and SSSP with K in {8, 64, 100000} at 1x1
    (in this process) and 2x2: each equal to its dense run and to the JAX
    executor's run with the same K, bit for bit; K = 8 records both
    branches.
"""

import dataclasses
import json
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
from graphtap_tpu.apps.degree import run_degree as j_run_degree
from graphtap_tpu.apps.pagerank import run_pagerank as j_run_pagerank
from graphtap_tpu.config import Compression as JCompression
from graphtap_tpu.config import EngineConfig as JEngineConfig
from graphtap_tpu.config import GraphConfig as JGraphConfig
from graphtap_tpu.config import Ordering as JOrdering
from graphtap_tpu.engine.executor import Executor as JExecutor
from graphtap_tpu.ingest.graph import Graph as JGraph
from graphtap_tpu.kernels.gather_engine import build_spmv2_meta as j_spmv2
from graphtap_tpu.kernels.pallas_spmv import build_pallas_plan as j_onehot
from graphtap_tpu.kernels.panel_engine import build_spmv3_meta as j_spmv3
from graphtap_tpu.kernels.shuffle_engine import \
    build_shuffle_plans as j_shuffle
from graphtap_tpu.parallel.layout import make_mesh as j_make_mesh

from graphtap_tpu_torch import EngineConfig, Executor, Graph, Ordering
from graphtap_tpu_torch.apps import BFSProgram, SSSPProgram, run_cc
from graphtap_tpu_torch.apps.degree import run_degree
from graphtap_tpu_torch.apps.pagerank import run_pagerank
from graphtap_tpu_torch.engine.executor import KERNELS
from graphtap_tpu_torch.ingest import rmat_edges
from graphtap_tpu_torch.ingest.io import write_binary
from graphtap_tpu_torch.parallel.launch import launch
from graphtap_tpu_torch.tools.mesh_run import app_config

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import golden  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCALE, EDGE_FACTOR, SEED = 10, 16, 1
N = 1 << SCALE
ALIGN = {"segment_align": 128}
ITERS = 10
SHAPES = {"2x2": (2, 2), "1x4": (1, 4)}
APPS = ("degree", "pr32", "pr64", "bfs", "cc", "sssp")
GRAPH_OF = {"degree": "pr", "pr32": "pr", "pr64": "pr", "bfs": "bfs",
            "cc": "cc", "sssp": "sssp"}
CAPS = (8, 64, 100000)
PLAN_KINDS = ("spmv3", "shuffle", "spmv2", "onehot")
RTOL = {"pr32": 1e-5, "pr64": 1e-12}
LAUNCH_TIMEOUT = 240


def _run_spec(name, app, kernel, K=0):
    run = {"name": name, "graph": GRAPH_OF[app], "kernel": kernel,
           "app": {"pr32": "pagerank", "pr64": "pagerank"}.get(app, app)}
    if app in ("degree", "pr32", "pr64"):
        run["dtype"] = "float64" if app == "pr64" else "float32"
    if app in ("pr32", "pr64"):
        run.update(iters=ITERS, degree_kernel="scan")
    if K:
        run["capacity"] = K
    return run


@pytest.fixture(scope="module")
def edges():
    r, c, _ = rmat_edges(SCALE, EDGE_FACTOR, seed=SEED)
    rw, cw, w = rmat_edges(SCALE, EDGE_FACTOR, seed=SEED, weighted=True)
    return {"pr": (r, c, None), "bfs": (r, c, None), "cc": (r, c, None),
            "sssp": (rw, cw, w), "prcf": (r, c, None)}


@pytest.fixture(scope="module")
def mesh_out(edges, tmp_path_factory):
    """shape -> the directory its launch wrote (one launch of four gloo
    ranks a shape, at the first test that needs it)."""
    root = tmp_path_factory.mktemp("mesh")
    files = {}
    for nm, (r, c, w) in (("plain", edges["pr"]), ("w", edges["sssp"])):
        files[nm] = str(root / f"rmat{SCALE}{nm}.bin")
        write_binary(files[nm], r, c, w)
    done = {}

    def get(shape):
        if shape in done:
            return done[shape]
        out = root / shape
        graphs = {g: {"path": files["w" if g == "sssp" else "plain"],
                      "nv": N, "config": "pr" if g == "prcf" else g,
                      "overrides": dict(ALIGN)}
                  for g in ("pr", "bfs", "cc", "sssp", "prcf")}
        graphs["prcf"]["overrides"]["compression"] = "tcsc_cf"
        runs = [_run_spec(f"{app}_{k}", app, k) for app in APPS
                for k in KERNELS]
        spec = {"shape": list(SHAPES[shape]), "backend": "gloo",
                "device": "cpu", "out": str(out), "graphs": graphs,
                "runs": runs}
        if shape == "2x2":
            spec["runs"] += [_run_spec(f"{app}_scan_k{K}", app, "scan", K)
                             for app in ("bfs", "sssp") for K in CAPS]
            spec["runs"].append(dict(_run_spec("prcf_onehot", "pr32",
                                               "onehot"), graph="prcf"))
            spec["plans"] = [{"graph": "pr", "ordering": "ROW", "kind": k,
                              "dtype": "float32"} for k in PLAN_KINDS]
        path = root / f"{shape}.json"
        path.write_text(json.dumps(spec))
        env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
        launch([sys.executable, "-m", "graphtap_tpu_torch.tools.mesh_run",
                str(path)], 4, LAUNCH_TIMEOUT, env=env, cwd=REPO)
        done[shape] = out
        return out
    return get


def _result(out, name):
    with np.load(out / f"{name}.npz") as z:
        state = {k: z[k] for k in z.files}
    return state, json.loads((out / f"{name}.json").read_text())


# ------------------------------------------------------------ references
def _jcfg(kind, **over):
    cfg = {"pr": JGraphConfig(num_vertices=N, directed=True, transpose=True,
                              compression=JCompression.TCSC),
           "bfs": jbfs.bfs_config(N), "cc": jcc.cc_config(N),
           "sssp": jsssp.sssp_config(N)}[kind]
    return dataclasses.replace(cfg, **ALIGN, **over)


def _jmesh(shape):
    return j_make_mesh(jax.devices()[:int(np.prod(shape))], shape=shape)


def _jax_run(app, edges, shape, kernel="scan", K=0):
    """The JAX package's run of ``app`` on a ``shape`` mesh -> its state
    in vertex order."""
    g = GRAPH_OF[app]
    r, c, w = edges[g]
    jg = JGraph.from_edges(r, c, w, _jcfg(g), mesh=_jmesh(shape))
    if app == "degree":
        ex = j_run_degree(jg, jnp.float32, JOrdering.COL, kernel=kernel)
    elif app in ("pr32", "pr64"):
        ex = j_run_pagerank(jg, ITERS, jnp.float64 if app == "pr64"
                            else jnp.float32, kernel=kernel)
    elif K:
        prog = (jbfs.BFSProgram(0) if app == "bfs"
                else jsssp.SSSPProgram(0))
        ex = JExecutor(jg, prog, JEngineConfig(
            stationary=False, apply_depends_on_iter=app == "bfs",
            gather_depends_on_apply=app == "sssp", ordering=JOrdering.ROW,
            sparse_exchange_capacity=K), kernel=kernel)
        ex.initialize()
        ex.execute(0)
    else:
        ex = {"bfs": lambda: jbfs.run_bfs(jg, 0, kernel=kernel),
              "cc": lambda: jcc.run_cc(jg, kernel=kernel),
              "sssp": lambda: jsssp.run_sssp(jg, 0, kernel=kernel)}[app]()
    return {k: np.asarray(v) for k, v in ex.state_vector().items()}


def _port_1x1(app, edges, K=0):
    """The port's group-free 1x1 run of ``app`` on the scan kernel."""
    g = GRAPH_OF[app]
    r, c, w = edges[g]
    pg = Graph.from_edges(r, c, w, app_config(g, N, ALIGN))
    if app == "degree":
        ex = run_degree(pg, torch.float32, Ordering.COL, "scan", "cpu")
    elif app in ("pr32", "pr64"):
        ex = run_pagerank(pg, ITERS, torch.float64 if app == "pr64"
                          else torch.float32, kernel="scan", device="cpu",
                          degree_kernel="scan")
    elif app == "cc":
        ex = run_cc(pg, "scan", "cpu")
    else:
        prog = BFSProgram(0) if app == "bfs" else SSSPProgram(0)
        ex = Executor(pg, prog, EngineConfig(
            stationary=False, apply_depends_on_iter=app == "bfs",
            gather_depends_on_apply=app == "sssp", ordering=Ordering.ROW,
            sparse_exchange_capacity=K), kernel="scan", device="cpu")
        ex.initialize()
        ex.execute(0)
    return ex


def _same_state(got, want, app, tag):
    """Bit for bit on the exact semirings; PageRank's ranks elementwise
    within RTOL and its degrees exactly."""
    assert set(got) == set(want), tag
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        if app in RTOL and k == "rank":
            np.testing.assert_allclose(g.astype(np.float64),
                                       w.astype(np.float64),
                                       rtol=RTOL[app], atol=0,
                                       err_msg=f"{tag} {k}")
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"{tag} {k}")


def _checksum(state, app):
    v = state["degree" if app == "degree" else "rank" if app in RTOL
              else {"bfs": "hops", "cc": "label", "sssp": "distance"}[app]]
    return float(np.asarray(v, np.float64)[v != golden.INF].sum())


# ----------------------------------------------------------------- tests
@pytest.mark.parametrize("app", APPS)
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_mesh_matches_jax_mesh_and_1x1(mesh_out, edges, shape, app):
    out = mesh_out(shape)
    want_jax = _jax_run(app, edges, SHAPES[shape])
    ex1 = _port_1x1(app, edges)
    want_1x1 = ex1.state_vector()
    _same_state(want_1x1, want_jax, app, "port 1x1 vs JAX mesh")
    for kernel in KERNELS:
        state, meta = _result(out, f"{app}_{kernel}")
        tag = f"{shape} {app} {kernel}"
        assert meta["exchange"] == "gloo", tag
        assert len(meta["ranks"]) == 4, tag
        _same_state(state, want_jax, app, f"{tag} vs JAX mesh")
        _same_state(state, want_1x1, app, f"{tag} vs port 1x1")
        want = _checksum(want_1x1, app)
        assert abs(meta["checksum"] - want) <= 1e-6 * abs(want), tag
        assert meta["checksum"] == pytest.approx(_checksum(state, app),
                                                 rel=1e-12), tag
        if app not in ("degree", "pr32", "pr64"):
            assert meta["iteration"] == ex1.iteration, tag


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_mesh_onehot_matches_jax_onehot(mesh_out, edges, shape):
    """f32 PageRank on the one-hot kernel against the JAX mesh's (its
    Pallas reduce in interpret mode)."""
    state, _ = _result(mesh_out(shape), "pr32_onehot")
    _same_state(state, _jax_run("pr32", edges, SHAPES[shape], "onehot"),
                "pr32", f"{shape} onehot")


def test_mesh_tcsc_cf_pagerank(mesh_out, edges):
    """PageRank on TCSC_CF tiles (the first/middle/last phases, each
    rank's apply masks its own row) at 2x2 against the port's 1x1."""
    state, meta = _result(mesh_out("2x2"), "prcf_onehot")
    r, c, _ = edges["pr"]
    ex = run_pagerank(Graph.from_edges(r, c, None, app_config(
        "pr", N, dict(ALIGN, compression="tcsc_cf"))), ITERS, torch.float32,
        kernel="scan", device="cpu", degree_kernel="scan")
    _same_state(state, ex.state_vector(), "pr32", "2x2 TCSC_CF")
    assert {rec["gated"] for rk in meta["ranks"]
            for rec in rk["supersteps"]} == {None}


@pytest.mark.parametrize("kind", PLAN_KINDS)
def test_mesh_plans_equal_jax_rows(mesh_out, edges, kind):
    """Rank b's plan arrays are row b of the JAX package's single-process
    plan of the 2x2 tiles, byte for byte."""
    out = mesh_out("2x2")
    r, c, _ = edges["pr"]
    jt = JGraph.from_edges(r, c, None, _jcfg("pr"),
                           mesh=_jmesh((2, 2))).tiled(JOrdering.ROW)
    if kind == "onehot":
        p = j_onehot(jt.rows, jt.cols, jt.weights, jt.nnz, jt.NR)
        want = {"oh_lrows": p.lrows, "oh_cols": p.cols,
                "oh_evalid": p.evalid.astype(np.int8),
                "oh_chunk_block": p.chunk_block}
    else:
        build = {"spmv3": j_spmv3, "shuffle": j_shuffle,
                 "spmv2": j_spmv2}[kind]
        want = build(jt, value_dtype=np.float32).arrays
    for b in range(4):
        with np.load(out / f"plan_pr_ROW_{kind}_b{b}.npz") as z:
            got = {k: z[k] for k in z.files}
        assert set(got) == set(want), (kind, b)
        for k, v in want.items():
            v = np.asarray(v)[b]
            assert got[k].shape == (1,) + v.shape, (kind, b, k)
            assert got[k].dtype == v.dtype, (kind, b, k)
            assert got[k][0].tobytes() == v.tobytes(), (kind, b, k)


@pytest.mark.parametrize("K", CAPS)
@pytest.mark.parametrize("app", ("bfs", "sssp"))
def test_sparse_exchange_matches_dense(mesh_out, edges, app, K):
    """The sparse exchange at 1x1 (here) and 2x2 (the launch) equals the
    dense exchange and the JAX executor's run with the same K, bit for
    bit; at K = 8 the supersteps record both branches."""
    dense = _port_1x1(app, edges)
    sparse = _port_1x1(app, edges, K)
    _same_state(sparse.state_vector(), dense.state_vector(), app,
                f"1x1 K={K}")
    _same_state(sparse.state_vector(),
                _jax_run(app, edges, (1, 1), K=K), app, f"1x1 K={K} JAX")
    assert sparse.iteration == dense.iteration
    branches = {rec["sparse"] for rec in sparse.supersteps}
    assert None not in branches
    assert {rec["sparse"] for rec in dense.supersteps} == {None}

    out = mesh_out("2x2")
    state, meta = _result(out, f"{app}_scan_k{K}")
    d_state, d_meta = _result(out, f"{app}_scan")
    _same_state(state, d_state, app, f"2x2 K={K}")
    _same_state(state, _jax_run(app, edges, (2, 2), K=K), app,
                f"2x2 K={K} JAX")
    assert meta["iteration"] == d_meta["iteration"]
    seen = {rec["sparse"] for rk in meta["ranks"]
            for rec in rk["supersteps"]}
    seen_y = {rec["sparse_y"] for rk in meta["ranks"]
              for rec in rk["supersteps"]}
    assert None not in seen | seen_y
    if K == 8:
        assert branches == {True, False} and seen == {True, False}
    if K == 100000:
        assert branches == {True} and seen == {True} and seen_y == {True}
