"""The kernel lab and the CSC and DCSC formats through the port, on the
CPU, against the JAX package.

DCSC tiles (column renumbering and the JC table) equal the JAX
``build_tileset``'s byte for byte, and survive the artifact cache. For
{CSC, DCSC} x every kernel on RMAT-9 the port raises ``ValueError``
exactly where the JAX executor does, and elsewhere its f64 PageRank state
(5 iterations after the degree handoff) equals the JAX executor's within
rtol 1e-10; BFS on CSC and DCSC equals it bit for bit. The apply rule
(TCSC_CF phase mask, else the I mask under TCSC and TCSC_CF, else none)
is held with a program whose state moves on rows without in-edges, since
PageRank's does not. ``Executor(tiles=)`` runs a TCSC_CF graph's TCSC
tiles as TCSC. The nine lab variants on one RMAT-10 file, 3 iterations:
``operations``, ``slots`` and ``memory_gb`` equal the JAX lab's exactly,
checksums within 1e-5 (f32); then lab_table's cross-variant gates, and
the lab main's seven lines. The JAX side runs as its own tests run it
(Pallas in interpret mode); the port's kernels run their plain versions.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from graphtap_tpu.apps.bfs import bfs_config as j_bfs_config
from graphtap_tpu.apps.bfs import run_bfs as j_run_bfs
from graphtap_tpu.apps.pagerank import PageRankProgram as JPageRank
from graphtap_tpu.apps.pagerank import run_pagerank as j_run_pagerank
from graphtap_tpu.config import Compression as JCompression
from graphtap_tpu.config import EngineConfig as JEngineConfig
from graphtap_tpu.config import GraphConfig as JGraphConfig
from graphtap_tpu.config import Ordering as JOrdering
from graphtap_tpu.engine.executor import Executor as JExecutor
from graphtap_tpu.engine.program import VertexProgram as JVertexProgram
from graphtap_tpu.ingest.graph import Graph as JGraph
from graphtap_tpu.kernels.semiring import plus_times as j_plus_times
from graphtap_tpu.parallel.layout import make_mesh
from graphtap_tpu.tools import kernel_lab as j_lab

from graphtap_tpu_torch import (Compression, EngineConfig, Graph,
                                GraphConfig, Ordering, VertexProgram)
from graphtap_tpu_torch.apps import (PageRankProgram, bfs_config, run_bfs,
                                     run_pagerank)
from graphtap_tpu_torch.apps.degree import run_degree
from graphtap_tpu_torch.engine.executor import KERNELS, Executor
from graphtap_tpu_torch.ingest import rmat_edges
from graphtap_tpu_torch.ingest.io import write_binary
from graphtap_tpu_torch.kernels.semiring import plus_times
from graphtap_tpu_torch.tools import artifact_cache, kernel_lab, lab_table

TILE_FIELDS = ("Ep", "NR", "nnz_total", "has_weight", "rows", "cols",
               "weights", "nnz", "ja", "ir", "iv_dense", "nnzrows", "i_own",
               "j_own", "regular_own", "source_own", "sink_own", "nnzcols",
               "jc")
FORMATS = ("CSC", "DCSC")
PR_ITERS = 5
LAB_SCALE, LAB_ITERS = 10, 3
LAB_NV = (1 << LAB_SCALE) + 1


def _mesh():
    return make_mesh(jax.devices()[:1], shape=(1, 1))


def _same_tiles(a, b):
    for f in TILE_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        if isinstance(x, np.ndarray) or x is None:
            if x is None or y is None:
                assert x is None and y is None, f
                continue
            y = np.asarray(y)
            assert x.dtype == y.dtype and x.shape == y.shape, f
            assert x.tobytes() == y.tobytes(), f
        else:
            assert x == y, f
    assert a.compression.value == b.compression.value


def _graphs(r, c, w, cfg: dict):
    """(port Graph, JAX Graph) of one edge list through one config (its
    ``compression`` given as the port's enum)."""
    jcfg = dict(cfg)
    if "compression" in cfg:
        jcfg["compression"] = JCompression(cfg["compression"].value)
    return (Graph.from_edges(r, c, w, GraphConfig(**cfg)),
            JGraph.from_edges(r, c, w, JGraphConfig(**jcfg), mesh=_mesh()))


@pytest.mark.parametrize("case", ["rmat10_row", "rmat10_col",
                                  "weighted_dedup"])
def test_dcsc_tiles_match_jax(case, tmp_path):
    """DCSC tiles equal the JAX package's byte for byte (``jc``, ``NR``
    and ``Ep`` included), and an artifact-cache round trip keeps them."""
    if case == "weighted_dedup":
        rng = np.random.default_rng(4)
        n, e = 2048, 30000
        r = rng.integers(0, n, size=e).astype(np.int64)
        c = rng.integers(0, n, size=e).astype(np.int64)
        hub = rng.random(e) < 0.2
        c[hub] = rng.integers(0, 16, size=int(hub.sum()))
        w = rng.integers(1, 129, size=e).astype(np.int32)
        cfg = dict(num_vertices=n, directed=True, transpose=False,
                   parallel_edges=False)
        ordering = Ordering.ROW
    else:
        r, c, w = rmat_edges(10, 16, seed=1)
        cfg = dict(num_vertices=1024, directed=True, transpose=True)
        ordering = Ordering.COL if case == "rmat10_col" else Ordering.ROW
    g, jg = _graphs(r, c, w, dict(cfg, compression=Compression.DCSC))
    ts = g.tiled(ordering)
    _same_tiles(ts, jg.tiled(JOrdering(ordering.value)))
    nzc = int(ts.nnzcols[0, 0])
    assert ts.jc.shape == (1, -(-nzc // 128) * 128) and ts.ir is None
    assert int(ts.cols[0, :int(ts.nnz[0, 0])].max()) < nzc
    path = tmp_path / "dcsc.npz"
    artifact_cache.save_tileset(ts, path)
    back = artifact_cache.load_tileset(path)
    _same_tiles(back, ts)
    assert back.compression == Compression.DCSC


# ------------------------------------------------- format x kernel matrix
@pytest.fixture(scope="module")
def rmat9():
    r, c, _ = rmat_edges(9, 16, seed=1)
    return r, c, {comp: _graphs(r, c, None, dict(
        num_vertices=512, transpose=True, compression=Compression[comp]))
        for comp in FORMATS}


def _jax_raises(call):
    try:
        return call(), None
    except ValueError as e:
        return None, e


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("comp", FORMATS)
def test_format_kernel_matrix_pagerank(rmat9, comp, kernel):
    """f64 PageRank with the degree handoff on ``kernel``: ValueError on
    both sides where the JAX executor refuses the format, else the
    state vectors within rtol 1e-10."""
    g, jg = rmat9[2][comp]
    jex, jerr = _jax_raises(lambda: j_run_pagerank(jg, PR_ITERS,
                                                   jnp.float64, kernel))
    if jerr is not None:
        with pytest.raises(ValueError) as err:
            run_pagerank(g, PR_ITERS, torch.float64, kernel=kernel,
                         device="cpu", degree_kernel=kernel)
        assert str(err.value) == str(jerr)
        return
    ex = run_pagerank(g, PR_ITERS, torch.float64, kernel=kernel,
                      device="cpu", degree_kernel=kernel)
    mine, theirs = ex.state_vector(), jex.state_vector()
    np.testing.assert_array_equal(mine["degree"], theirs["degree"])
    np.testing.assert_allclose(mine["rank"], theirs["rank"], rtol=1e-10,
                               atol=0)
    assert ex.iteration == PR_ITERS
    assert ex.checksum()[1] == jex.checksum()[1]


@pytest.mark.parametrize("kernel", ["scan", "onehot"])
@pytest.mark.parametrize("comp", FORMATS)
def test_format_kernel_matrix_bfs(rmat9, comp, kernel):
    """BFS (bfs_config, int32) on CSC and DCSC: equal to the JAX
    executor's bit for bit, or ValueError on both sides (DCSC on
    onehot)."""
    r, c, _ = rmat9
    cfg = dataclasses.replace(bfs_config(512),
                              compression=Compression[comp])
    jcfg = dataclasses.replace(j_bfs_config(512),
                               compression=JCompression[comp])
    g = Graph.from_edges(r, c, None, cfg)
    jg = JGraph.from_edges(r, c, None, jcfg, mesh=_mesh())
    jex, jerr = _jax_raises(lambda: j_run_bfs(jg, 0, kernel=kernel))
    if jerr is not None:
        with pytest.raises(ValueError, match="DCSC"):
            run_bfs(g, 0, kernel=kernel, device="cpu")
        return
    ex = run_bfs(g, 0, kernel=kernel, device="cpu")
    assert ex.iteration == jex.iteration
    mine, theirs = ex.state_vector(), jex.state_vector()
    assert sorted(mine) == sorted(theirs)
    for k in mine:
        np.testing.assert_array_equal(mine[k], np.asarray(theirs[k]))


class _Bump(VertexProgram):
    """y + 1 everywhere: rows without in-edges move unless apply masks
    them (the port's side of ``_JBump``)."""
    stationary = True
    semiring = plus_times()
    value_dtype = torch.float64

    def init(self, vids, i_mask, other):
        return ({"v": torch.zeros(vids.shape, dtype=torch.float64,
                                  device=vids.device)},
                torch.ones_like(i_mask))

    def messenger(self, state):
        return torch.ones_like(state["v"])

    def applicator(self, state, y, iteration):
        v = y + 1.0
        return {"v": v}, v != state["v"]

    def get_state(self, state):
        return state["v"]


class _JBump(JVertexProgram):
    stationary = True
    semiring = j_plus_times()
    value_dtype = jnp.float64

    def init(self, vids, i_mask, other):
        return {"v": np.zeros(vids.shape)}, np.ones(vids.shape, bool)

    def messenger(self, state):
        return jnp.ones_like(state["v"])

    def applicator(self, state, y, iteration):
        v = y + 1.0
        return {"v": v}, v != state["v"]

    def get_state(self, state):
        return state["v"]


@pytest.mark.parametrize("comp", ["CSC", "DCSC", "TCSC"])
def test_apply_mask_rule_matches_jax(rmat9, comp):
    """The apply rule: TCSC applies under the I mask, CSC and DCSC
    everywhere (rows without in-edges become 1, not 0), as the JAX
    executor does; the changed vector too."""
    r, c, _ = rmat9
    g, jg = _graphs(r, c, None, dict(num_vertices=512, transpose=True,
                                     compression=Compression[comp]))
    ex = Executor(g, _Bump(), kernel="scan", device="cpu")
    ex.execute(1)
    jex = JExecutor(jg, _JBump(), kernel="scan")
    jex.execute(1)
    v = ex.state_vector()["v"]
    np.testing.assert_array_equal(v, np.asarray(jex.state_vector()["v"]))
    np.testing.assert_array_equal(ex.changed.numpy(),
                                  np.asarray(jex.changed)[0])
    no_in = ~g.part.to_vertex_order(g.tiled().i_own)[:g.nv]
    assert no_in.any()
    assert (v[no_in] == (0.0 if comp == "TCSC" else 1.0)).all()


def test_tiles_argument_runs_tcsc_on_a_cf_graph(rmat9):
    """``Executor(tiles=g.tiled(ordering, compression=TCSC))`` on a
    TCSC_CF graph runs the "main" tiles under the I mask: equal to the
    JAX executor given the same tiles, and bit for bit to the run on a
    TCSC graph."""
    r, c, _ = rmat9
    cfg = dict(num_vertices=512, transpose=True)
    g, jg = _graphs(r, c, None, dict(cfg, compression=Compression.TCSC_CF))
    tcsc = Graph.from_edges(r, c, None, GraphConfig(**cfg))
    deg = run_degree(tcsc, torch.float64, Ordering.COL, "scan", "cpu")
    pr_cfg = EngineConfig(stationary=True, ordering=Ordering.ROW)

    def port(graph, **kw):
        ex = Executor(graph, PageRankProgram(torch.float64), pr_cfg,
                      kernel="onehot", device="cpu", **kw)
        ex.initialize(other=deg)
        ex.execute(PR_ITERS)
        return ex

    ex = port(g, tiles=g.tiled(Ordering.ROW, compression=Compression.TCSC))
    assert not ex.is_cf and ex.tiles.compression == Compression.TCSC
    assert [s["phase"] for s in ex.supersteps] == ["main"] * PR_ITERS
    assert torch.equal(ex.state["rank"], port(tcsc).state["rank"])
    assert [s["phase"] for s in port(g).supersteps] == (
        ["first"] + ["middle"] * (PR_ITERS - 2) + ["last"])

    from graphtap_tpu.apps.degree import DegreeProgram as JDegree
    jdeg = JExecutor(jg, JDegree(value_dtype=jnp.float64), JEngineConfig(
        stationary=True, ordering=JOrdering.COL),
        tiles=jg.tiled(JOrdering.COL, compression=JCompression.TCSC),
        kernel="scan")
    jdeg.execute(1)
    jex = JExecutor(jg, JPageRank(value_dtype=jnp.float64), JEngineConfig(
        stationary=True, ordering=JOrdering.ROW),
        tiles=jg.tiled(JOrdering.ROW, compression=JCompression.TCSC),
        kernel="onehot")
    jex.initialize(other=jdeg)
    jex.execute(PR_ITERS)
    mine, theirs = ex.state_vector(), jex.state_vector()
    np.testing.assert_array_equal(mine["degree"], theirs["degree"])
    np.testing.assert_allclose(mine["rank"], theirs["rank"], rtol=1e-10,
                               atol=0)


# ------------------------------------------------------------ the lab
@pytest.fixture(scope="module")
def lab_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("lab") / f"rmat{LAB_SCALE}.bin"
    r, c, _ = rmat_edges(LAB_SCALE, 16, seed=1)
    write_binary(str(path), r, c)
    return str(path)


@pytest.fixture(scope="module")
def lab_rows(lab_file):
    """The port's nine lab rows, each run once."""
    return {r["which"]: r for r in lab_table.run_rows(
        lab_file, LAB_NV, LAB_ITERS, device="cpu")}


@pytest.mark.parametrize("which", sorted(kernel_lab.VARIANTS))
def test_lab_variant_matches_jax(lab_file, lab_rows, which):
    """Each variant: variant name, operations, slots and memory equal the
    JAX lab's exactly; the checksum within 1e-5 relative (f32)."""
    assert kernel_lab.VARIANTS == j_lab.VARIANTS
    mine = lab_rows[which]
    theirs = j_lab.run_variant(which, lab_file, LAB_NV, LAB_ITERS)
    for k in ("variant", "operations", "slots", "memory_gb", "reachable"):
        assert mine[k] == theirs[k], k
    assert mine["pad_factor"] == theirs["pad_factor"]
    assert abs(mine["checksum"] - theirs["checksum"]) <= \
        1e-5 * abs(theirs["checksum"])


def test_lab_table_gates_and_render(lab_rows):
    """lab_table's gates pass over the port's nine rows and fail on a
    row whose operations or checksum strays; the table lists every
    variant."""
    rows = list(lab_rows.values())
    lab_table.gates(rows)
    with pytest.raises(AssertionError, match="op-count"):
        lab_table.gates(rows + [dict(rows[0], operations=1)])
    with pytest.raises(AssertionError):
        lab_table.gates(rows + [dict(rows[0], checksum=rows[0]["checksum"]
                                     * (1 + 1e-4))])
    md = lab_table.render(LAB_SCALE, rows)
    for r in rows:
        assert f"| {r['which']} | {r['variant']} |" in md
    assert "operations EQUAL" in md


def test_lab_main_prints_the_jax_lines(lab_file, capsys):
    """``main`` prints the JAX main's seven labelled lines, with the same
    values but for the time and the rate."""
    argv = ["8", lab_file, str(LAB_NV), str(LAB_ITERS)]
    assert j_lab.main(argv) == 0
    theirs = capsys.readouterr().out.strip().splitlines()
    assert kernel_lab.main(argv + ["--device", "cpu"]) == 0
    mine = capsys.readouterr().out.strip().splitlines()
    assert len(mine) == len(theirs) == 7
    for a, b in zip(mine, theirs):
        label = b.split(":")[0]
        assert a.split(":")[0] == label
        if not label.startswith(("Elapsed", "GTEPS")):
            assert a == b, label
