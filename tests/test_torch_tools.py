"""The port's single-device tools and mains on the CPU, against the JAX
package on a 1x1 mesh, on generated RMAT-10 graphs:

  * ``TileSet.edge_balance``/``balance_report`` equal the JAX ones;
  * the ``bfs``, ``cc`` and ``sssp`` mains print the balance line and the
    five oracle lines, their values those of the JAX apps;
  * ``Executor.execute_profiled`` equals ``execute`` bit for bit on fixed,
    convergence and TCSC_CF runs, and fills its ``PhaseTimer``;
  * ``Executor.stats`` equals the JAX executor's ``state_stats``;
  * checkpoints round-trip, and a checkpoint of another graph is refused;
  * the converter writes the JAX converter's bytes;
  * ``save_tileset``/``load_tileset`` round-trip byte for byte, in the
    JAX package's cache format; ``cached_rmat`` memoizes the generator.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from graphtap_tpu.apps.bfs import bfs_config as j_bfs_config
from graphtap_tpu.apps.bfs import run_bfs as j_run_bfs
from graphtap_tpu.apps.cc import cc_config as j_cc_config
from graphtap_tpu.apps.cc import run_cc as j_run_cc
from graphtap_tpu.apps.sssp import run_sssp as j_run_sssp
from graphtap_tpu.apps.sssp import sssp_config as j_sssp_config
from graphtap_tpu.config import Compression as JCompression
from graphtap_tpu.config import GraphConfig as JGraphConfig
from graphtap_tpu.config import Ordering as JOrdering
from graphtap_tpu.ingest.graph import Graph as JGraph
from graphtap_tpu.parallel.layout import make_mesh
from graphtap_tpu.tools import artifact_cache as j_cache
from graphtap_tpu.tools.converter import main as j_converter
from graphtap_tpu.tools.oracle import state_stats as j_state_stats

from graphtap_tpu_torch import (Compression, EngineConfig, Graph,
                                GraphConfig, Ordering)
from graphtap_tpu_torch.apps import (BFSProgram, DegreeProgram,
                                     PageRankProgram, bfs_config, run_bfs,
                                     run_pagerank, sssp_config)
from graphtap_tpu_torch.engine.executor import Executor
from graphtap_tpu_torch.ingest import rmat_edges
from graphtap_tpu_torch.ingest.io import read_edge_list, write_binary
from graphtap_tpu_torch.tools import artifact_cache
from graphtap_tpu_torch.tools.checkpoint import load_state, save_state
from graphtap_tpu_torch.tools.converter import main as converter

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 1024
TILE_FIELDS = ("rows", "cols", "weights", "nnz", "ja", "ir", "iv_dense",
               "nnzrows", "i_own", "j_own", "regular_own", "source_own",
               "sink_own", "nnzcols")


def _mesh():
    return make_mesh(jax.devices()[:1], shape=(1, 1))


@pytest.fixture(scope="module")
def edges():
    return rmat_edges(10, 16, seed=1, weighted=True)


@pytest.fixture(scope="module")
def edge_files(tmp_path_factory, edges):
    r, c, w = edges
    d = tmp_path_factory.mktemp("edges")
    plain, weighted = str(d / "rmat10.bin"), str(d / "rmat10w.bin")
    write_binary(plain, r, c)
    write_binary(weighted, r, c, w)
    return {"plain": plain, "weighted": weighted}


# (port config, JAX config, weighted) of each app's graph
CONFIGS = {
    "pr": (GraphConfig(num_vertices=N, transpose=True),
           JGraphConfig(num_vertices=N, transpose=True), False),
    "bfs": (bfs_config(N), j_bfs_config(N), False),
    "sssp": (sssp_config(N), j_sssp_config(N), True),
}


@pytest.mark.parametrize("app", sorted(CONFIGS))
def test_balance_line_matches_jax(edges, app):
    r, c, w = edges
    cfg, jcfg, weighted = CONFIGS[app]
    w = w if weighted else None
    ts = Graph.from_edges(r, c, w, cfg).tiled(Ordering.ROW)
    jts = JGraph.from_edges(r, c, w, jcfg, mesh=_mesh()).tiled(
        JOrdering.ROW)
    assert ts.edge_balance() == jts.edge_balance()
    assert ts.balance_report() == jts.balance_report()
    assert ts.balance_report().startswith(f"Edge balance: edges="
                                          f"{ts.nnz_total} ")


def _jax_app(app, path):
    g_cfg = {"bfs": j_bfs_config, "cc": j_cc_config,
             "sssp": j_sssp_config}[app](N)
    g = JGraph.load(path, g_cfg, mesh=_mesh())
    if app == "bfs":
        return j_run_bfs(g, 0, kernel="scan")
    if app == "cc":
        return j_run_cc(g, kernel="scan")
    return j_run_sssp(g, 0, kernel="scan")


@pytest.mark.parametrize("app", ["bfs", "cc", "sssp"])
def test_mains_print_balance_and_oracle_lines(edge_files, app):
    """``python -m graphtap_tpu_torch.apps.<app> <file> 1024 [0] --device
    cpu``: the balance line, then the five oracle lines; the values equal
    the JAX app's on the same file."""
    path = edge_files["weighted" if app == "sssp" else "plain"]
    third = [] if app == "cc" else ["0"]
    res = subprocess.run(
        [sys.executable, "-m", f"graphtap_tpu_torch.apps.{app}", path,
         str(N), *third, "--device", "cpu"], cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO), capture_output=True,
        text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    balance, *lines = res.stdout.strip().splitlines()
    assert [ln.split(":")[0] for ln in lines] == [
        f"{app} end-to-end time", "Execute time", "Iterations",
        "Value checksum", "Reachable vertices"]
    fields = {ln.split(":")[0]: ln.split(":")[1].split()[0] for ln in lines}
    jex = _jax_app(app, path)
    jsum, jreach = jex.checksum()
    assert balance == jex.tiles.balance_report()
    assert fields["Iterations"] == str(jex.iteration)
    assert fields["Value checksum"] == f"{jsum:f}"
    assert fields["Reachable vertices"] == str(jreach)


def _pr_executor(g, kernel, deg=None):
    if deg is None:
        deg = Executor(g, DegreeProgram(torch.float64),
                       EngineConfig(stationary=True, ordering=Ordering.COL),
                       kernel="scan", device="cpu")
        deg.initialize()
        deg.execute(1)
    ex = Executor(g, PageRankProgram(torch.float64),
                  EngineConfig(stationary=True, ordering=Ordering.ROW),
                  kernel=kernel, device="cpu")
    ex.initialize(other=deg)
    return ex, deg


def _same_state(a, b):
    assert a.iteration == b.iteration
    assert set(a.state) == set(b.state)
    for k in a.state:
        assert torch.equal(a.state[k], b.state[k]), k
    assert torch.equal(a.changed, b.changed)


@pytest.mark.parametrize("kernel", ["scan", "onehot"])
def test_execute_profiled_matches_fixed_run(edges, kernel):
    r, c, _ = edges
    g = Graph.from_edges(r, c, None, CONFIGS["pr"][0])
    ex_a, deg = _pr_executor(g, kernel)
    ex_a.execute(5)
    ex_b, _ = _pr_executor(g, kernel, deg)
    lines = []
    timer = ex_b.execute_profiled(5, printer=lines.append)
    assert lines[:5] == [f"Iteration: {i}" for i in range(1, 6)]
    assert lines[5] == timer.report()
    assert set(timer.samples) == {"scatter_gather", "exchange", "combine",
                                  "apply"}
    assert {k: len(v) for k, v in timer.samples.items()} == {
        "scatter_gather": 5, "exchange": 10, "combine": 5, "apply": 5}
    assert [s["phase"] for s in ex_b.supersteps] == ["main"] * 5
    _same_state(ex_b, ex_a)


def test_execute_profiled_matches_convergence_flush(edges):
    """BFS to convergence: the same iterations and state as execute(0),
    the flush included (its exchanges, combine and apply timed once
    more; the vote an exchange sample a superstep)."""
    r, c, _ = edges
    g = Graph.from_edges(r, c, None, bfs_config(N))
    ex_a = run_bfs(g, 0, kernel="scan", device="cpu")
    ex_b = Executor(g, BFSProgram(root=0), ex_a.engine, kernel="scan",
                    device="cpu")
    ex_b.initialize()
    timer = ex_b.execute_profiled(0, printer=None)
    _same_state(ex_b, ex_a)
    assert len(timer.samples["scatter_gather"]) == ex_a.iteration
    assert len(timer.samples["combine"]) == ex_a.iteration + 1
    assert len(timer.samples["exchange"]) == 3 * ex_a.iteration + 2


@pytest.mark.parametrize("iters", [5, 1, 0])
def test_execute_profiled_matches_cf_phases(edges, iters):
    """TCSC_CF: first, middle, last in execute()'s positions (5), the
    main tiles for one iteration (1), the middle steps and the flush on
    last in convergence mode (0) — bit for bit."""
    r, c, _ = edges
    g = Graph.from_edges(r, c, None, GraphConfig(
        num_vertices=N, transpose=True, compression=Compression.TCSC_CF))
    ex_a, deg = _pr_executor(g, "onehot")
    ex_a.execute(iters)
    ex_b, _ = _pr_executor(g, "onehot", deg)
    ex_b.execute_profiled(iters, printer=None)
    _same_state(ex_b, ex_a)
    assert ([s["phase"] for s in ex_b.supersteps]
            == [s["phase"] for s in ex_a.supersteps])
    if iters == 5:
        assert [s["phase"] for s in ex_b.supersteps] == [
            "first", "middle", "middle", "middle", "last"]
    elif iters == 1:
        assert [s["phase"] for s in ex_b.supersteps] == ["main"]


@pytest.mark.parametrize("app", ["bfs", "pr"])
def test_stats_match_jax(edges, app):
    r, c, _ = edges
    cfg, jcfg, _ = CONFIGS[app]
    jg = JGraph.from_edges(r, c, None, jcfg, mesh=_mesh())
    g = Graph.from_edges(r, c, None, cfg)
    if app == "bfs":
        ex, jex = run_bfs(g, 0, kernel="scan", device="cpu"), \
            j_run_bfs(jg, 0, kernel="scan")
    else:
        from graphtap_tpu.apps.pagerank import run_pagerank as j_run_pr
        ex = run_pagerank(g, 20, torch.float64, kernel="scan", device="cpu",
                          degree_kernel="scan")
        jex = j_run_pr(jg, 20, jnp.float64, kernel="scan")
    got = ex.stats()
    assert got == j_state_stats(np.asarray(ex.program.get_state(
        ex.state_vector())), ex.program.infinity())
    want = jex.stats()
    assert got.keys() == want.keys()
    for k in got:
        assert got[k] == pytest.approx(want[k], rel=1e-12, abs=0), k


def test_checkpoint_resume(edges, tmp_path):
    """Save at iteration 10, restore into a fresh executor, run 10 more:
    bit for bit the straight 20-iteration run."""
    r, c, _ = edges
    g = Graph.from_edges(r, c, None, CONFIGS["pr"][0])
    straight, deg = _pr_executor(g, "scan")
    straight.execute(20)
    first, _ = _pr_executor(g, "scan", deg)
    first.execute(10)
    path = str(tmp_path / "pr_it10.npz")
    save_state(first, path)
    resumed, _ = _pr_executor(g, "scan", deg)
    assert load_state(resumed, path) == 10
    assert resumed.state["rank"].device == resumed.device
    resumed.execute(10)
    np.testing.assert_array_equal(resumed.state_vector()["rank"],
                                  straight.state_vector()["rank"])
    assert resumed.checksum() == straight.checksum()


def test_checkpoint_shape_mismatch_rejected(edges, tmp_path):
    r, c, _ = edges
    g = Graph.from_edges(r, c, None, CONFIGS["pr"][0])
    ex, _ = _pr_executor(g, "scan")
    path = str(tmp_path / "pr.npz")
    save_state(ex, path)
    g2 = Graph.from_edges(r, c, None, GraphConfig(num_vertices=2 * N,
                                                  transpose=True))
    ex2, _ = _pr_executor(g2, "scan")
    with pytest.raises(ValueError, match="nv"):
        load_state(ex2, path)
    with np.load(path) as z:                  # same nv, a cut state array
        arrays = {k: z[k] for k in z.files}
    arrays["rank"] = arrays["rank"][:-1]
    bad = str(tmp_path / "bad.npz")
    np.savez(bad, **arrays)
    with pytest.raises(ValueError, match="shape"):
        load_state(ex, bad)
    with pytest.raises(ValueError):
        save_state(Executor(g, PageRankProgram(torch.float64),
                            kernel="scan", device="cpu"), path)


def test_converter_roundtrip_matches_jax(edge_files, tmp_path, capsys):
    """bin -> text -> bin gives the edges back; the text and binary
    outputs are the JAX converter's bytes."""
    src = edge_files["plain"]
    txt, back = str(tmp_path / "g.el"), str(tmp_path / "g.bin")
    jtxt = str(tmp_path / "j.el")
    assert converter([src, txt, "--text-out"]) == 0
    out = capsys.readouterr().out
    r0, c0, _ = read_edge_list(src)
    assert out.splitlines() == [f"Vertices: {max(r0.max(), c0.max()) + 1}",
                                f"Edges: {r0.size}"]
    assert j_converter([src, jtxt, "--text-out"]) == 0
    assert open(txt, "rb").read() == open(jtxt, "rb").read()
    assert converter([txt, back]) == 0
    r1, c1, _ = read_edge_list(back)
    np.testing.assert_array_equal(r0, r1)
    np.testing.assert_array_equal(c0, c1)


@pytest.mark.parametrize("mode", ["add", "strip"])
def test_converter_weights_and_displacement_match_jax(edge_files, tmp_path,
                                                      mode):
    src = edge_files["plain" if mode == "add" else "weighted"]
    args = ["--weights", mode, "--displacement", "1", "--seed", "7"]
    if mode == "strip":
        args.append("--in-weighted")
    out, jout = str(tmp_path / "w.bin"), str(tmp_path / "jw.bin")
    converter([src, out, *args])
    j_converter([src, jout, *args])
    assert open(out, "rb").read() == open(jout, "rb").read()
    r0, c0, _ = read_edge_list(src, has_weight=mode == "strip")
    r, c, w = read_edge_list(out, has_weight=mode == "add")
    np.testing.assert_array_equal(r, r0 + 1)
    np.testing.assert_array_equal(c, c0 + 1)
    if mode == "add":
        assert w.min() >= 1 and w.max() <= 128


@pytest.mark.parametrize("app", ["pr", "sssp"])
def test_tileset_cache_roundtrip(edges, tmp_path, app):
    """save_tileset/load_tileset give every field back byte for byte, in
    the JAX package's format: its load_tileset reads the port's file as
    its own tiles."""
    r, c, w = edges
    cfg, jcfg, weighted = CONFIGS[app]
    w = w if weighted else None
    ts = Graph.from_edges(r, c, w, cfg).tiled(Ordering.ROW)
    path = str(tmp_path / "ts.npz")
    artifact_cache.save_tileset(ts, path)
    for back in (artifact_cache.load_tileset(path),
                 j_cache.load_tileset(path),
                 JGraph.from_edges(r, c, w, jcfg, mesh=_mesh()).tiled(
                     JOrdering.ROW)):
        assert (back.Ep, back.NR, back.nnz_total, back.has_weight) == (
            ts.Ep, ts.NR, ts.nnz_total, ts.has_weight)
        assert back.compression.value == ts.compression.value
        assert (back.part.nv, back.part.L) == (ts.part.nv, ts.part.L)
        for f in TILE_FIELDS:
            x, y = getattr(ts, f), getattr(back, f)
            if x is None or y is None:
                assert x is None and y is None, f
                continue
            x, y = np.asarray(x), np.asarray(y)
            assert x.dtype == y.dtype and x.shape == y.shape, f
            assert x.tobytes() == y.tobytes(), f
    assert artifact_cache.load_tileset(path).compression == Compression.TCSC


@pytest.mark.parametrize("weighted", [False, True])
def test_cached_rmat(tmp_path, weighted):
    want = rmat_edges(8, 16, seed=3, weighted=weighted)
    got = artifact_cache.cached_rmat(8, 16, 3, str(tmp_path), weighted)
    files = os.listdir(tmp_path)
    assert files == [f"rmat8_ef16_s3{'w' if weighted else ''}.bin"]
    again = artifact_cache.cached_rmat(8, 16, 3, str(tmp_path), weighted)
    for a, b, d in zip(want, got, again):
        if a is None:
            assert b is None and d is None
            continue
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, d)
    assert os.listdir(tmp_path) == files


def test_ring_times_rows_agree_on_cpu(tmp_path):
    """The ring-kernel timer's calls on the CPU at RMAT-10: K1, K11 and P1
    equal their plain versions and their PyTorch calls (the take over the
    index precomputed from the plan; the copy) bit for bit; the meta it
    wrote, under a name that carries its scale and seed, is read back the
    same."""
    from graphtap_tpu_torch.tools import ring_times
    path = ring_times.meta_path(str(tmp_path), scale=10)
    assert os.path.basename(path) == (
        "ring_times_rmat10_ef16_seed1_tcsc_f32.npz")
    meta = ring_times.load_meta(path, scale=10)
    again = ring_times.load_meta(path, scale=10)
    for k, v in meta.arrays.items():
        np.testing.assert_array_equal(v[0], again.arrays[k][0], err_msg=k)
    got = ring_times.rows(again, "cpu", copy_bytes=1 << 20)
    assert [r[0] for r in got] == ["route_xr_exp", "route_expand",
                                   "copy_blocks"]
    for name, kern, plain, lib, nbytes in got:
        ring_times.check(name, kern, plain, lib)
        assert nbytes > 0


def test_ring_times_k6_p2_rows_agree_on_cpu(tmp_path):
    """The timer's K6 and P2 rows on the CPU: K6's three launches of the
    RMAT-10 degree SpMV and P2's two-stream sum equal their plain versions
    and their PyTorch calls (three takes; one add) bit for bit; the
    shuffle plan it wrote, under a name that carries its scale and seed,
    is read back the same."""
    from graphtap_tpu_torch.tools import ring_times
    path = ring_times.shuffle_path(str(tmp_path), scale=10)
    assert os.path.basename(path) == (
        "ring_times_rmat10_ef16_seed1_tcsc_col_shuffle_f32.npz")
    meta = ring_times.load_shuffle(path, scale=10)
    again = ring_times.load_shuffle(path, scale=10)
    for k, v in meta.arrays.items():
        np.testing.assert_array_equal(v[0], again.arrays[k][0], err_msg=k)
    got = [ring_times.expand_row(again, "cpu"),
           ring_times.sum_row("cpu", sum_bytes=1 << 20)]
    assert [r[0] for r in got] == ["expand_stream", "stream_sum"]
    for name, kern, plain, lib, nbytes in got:
        ring_times.check(name, kern, plain, lib)
        assert nbytes > 0
    assert len(got[0][1]()) == 3


def test_ring_times_k5_k8_rows_agree_on_cpu(tmp_path):
    """The timer's K5 and K8 rows on the CPU at RMAT-10: K5 on the one-hot
    plan's PageRank contributions and K8 on the degree SpMV's grouped
    stream equal their plain versions bit for bit and their
    scatter_reduce calls (K5 within its LIB_RTOL); each row carries its
    chunk figures; the one-hot plan it wrote, under a name that carries
    its scale and seed, is read back the same."""
    from graphtap_tpu_torch.tools import ring_times
    path = ring_times.onehot_path(str(tmp_path), scale=10)
    assert os.path.basename(path) == (
        "ring_times_rmat10_ef16_seed1_tcsc_row_onehot.npz")
    plan, nr, nc = ring_times.load_onehot(path, scale=10)
    again, nr2, nc2 = ring_times.load_onehot(path, scale=10)
    assert (nr, nc) == (nr2, nc2)
    for k, v in plan.arrays.items():
        np.testing.assert_array_equal(v, again.arrays[k], err_msg=k)
    meta = ring_times.load_shuffle(ring_times.shuffle_path(str(tmp_path),
                                                           scale=10),
                                   scale=10)
    got = [ring_times.segment_row(again, nr, nc, "cpu"),
           ring_times.grouped_row(meta, "cpu")]
    assert [r[0] for r in got] == ["segment_reduce", "grouped_reduce"]
    for name, kern, plain, lib, nbytes, figs in got:
        ring_times.check(name, kern, plain, lib,
                         ring_times.LIB_RTOL.get(name))
        assert nbytes > 0
        assert figs["chunks"] > 0 and figs["max_list"] >= 1
    assert got[0][5]["chunks"] == again.nchunks
    assert got[1][5]["empty_chunks"] > 0
    assert got[1][5]["max_list"] < got[1][5]["max_block_chunks"]
