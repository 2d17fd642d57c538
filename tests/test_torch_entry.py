"""The port's top-level entry points against the JAX package's.

``graphtap_tpu_torch.graft_entry.entry(device="cpu")`` against
``__graft_entry__.entry()``: the same RMAT-12 graph, the port's panel
meta arrays equal to the JAX meta's byte for byte, and the step's output
within rtol 1e-5 / atol 1e-6 of the jitted JAX step (Pallas in interpret
mode), its sum within 1e-5 of 1100.7751. ``dryrun_multichip(4,
device="cpu")`` (four gloo ranks, a 2x2 mesh) against the JAX package's
four programs built as ``__graft_entry__.py:84-143`` builds them, on a
2x2 mesh of the conftest's virtual CPU devices: BFS and SSSP bit for bit,
the f32 PageRank checksums within 1e-5 relative; and
``dryrun_multichip(1)`` against the 2x2 run.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import __graft_entry__ as jentry
from graphtap_tpu.apps.bfs import BFSProgram as JBFS
from graphtap_tpu.apps.bfs import bfs_config as j_bfs_config
from graphtap_tpu.apps.degree import DegreeProgram as JDegree
from graphtap_tpu.apps.pagerank import PageRankProgram as JPageRank
from graphtap_tpu.apps.sssp import SSSPProgram as JSSSP
from graphtap_tpu.apps.sssp import sssp_config as j_sssp_config
from graphtap_tpu.config import Compression as JCompression
from graphtap_tpu.config import EngineConfig as JEngineConfig
from graphtap_tpu.config import GraphConfig as JGraphConfig
from graphtap_tpu.config import Ordering as JOrdering
from graphtap_tpu.engine.executor import Executor as JExecutor
from graphtap_tpu.format.tiles import build_tileset as j_build_tileset
from graphtap_tpu.ingest.graph import Graph as JGraph
from graphtap_tpu.ingest.rmat import rmat_edges as j_rmat_edges
from graphtap_tpu.kernels.panel_engine import build_spmv3_meta as j_spmv3
from graphtap_tpu.parallel.layout import Partition as JPartition
from graphtap_tpu.parallel.layout import make_mesh as j_make_mesh

from graphtap_tpu_torch import graft_entry
from graphtap_tpu_torch.format.tiles import build_tileset
from graphtap_tpu_torch.ingest.rmat import rmat_edges
from graphtap_tpu_torch.kernels.panel_meta import build_spmv3_meta
from graphtap_tpu_torch.parallel.layout import Partition

ENTRY_SUM = 1100.7751
STATE_KEY = {"pagerank": "rank", "cf_pagerank": "rank", "bfs": "hops",
             "sssp": "distance"}


def test_entry_matches_jax_entry():
    r, c, _ = rmat_edges(12, 16, seed=3)
    jr, jc, _ = j_rmat_edges(12, 16, seed=3)
    np.testing.assert_array_equal(r, jr)
    np.testing.assert_array_equal(c, jc)
    ts = build_tileset(c, r, None, Partition.build(nv=4097, R=1, C=1,
                                                   segment_align=1024))
    jts = j_build_tileset(jc, jr, None, JPartition.build(
        nv=4097, R=1, C=1, segment_align=1024),
        compression=JCompression.TCSC)
    meta = build_spmv3_meta(ts, value_dtype=np.float32)
    jmeta = j_spmv3(jts, value_dtype=np.float32)
    assert set(meta.arrays) == set(jmeta.arrays)
    for k, v in jmeta.arrays.items():
        got = meta.arrays[k]
        assert got.dtype == v.dtype and got.shape == v.shape, k
        assert got.tobytes() == v.tobytes(), k

    step, (rank0, degree) = graft_entry.entry(device="cpu")
    got = step(rank0, degree)
    jstep, jargs = jentry.entry()
    want = np.asarray(jax.jit(jstep)(*jargs))
    np.testing.assert_array_equal(rank0.numpy(), np.asarray(jargs[0]))
    np.testing.assert_array_equal(degree.numpy(), np.asarray(jargs[1]))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert want.shape == (5120,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    assert abs(float(got.sum()) - ENTRY_SUM) <= 1e-5 * ENTRY_SUM
    # the plain composition is the CPU's SpMV: the same bits
    pstep, pargs = graft_entry.entry(device="cpu", plain=True)
    assert torch.equal(pstep(*pargs), got)


def test_entry_main_prints_shape_and_sum(capsys):
    assert graft_entry.main(["--device", "cpu"]) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("entry ok: (5120,) ")
    assert abs(float(line.split()[-1]) - ENTRY_SUM) <= 1e-5 * ENTRY_SUM


def _jax_dryrun(shape):
    """The JAX package's four dryrun programs (``__graft_entry__.py:84-143``)
    on a ``shape`` mesh -> name -> (state in vertex order, checksum,
    reachable, iteration)."""
    mesh = j_make_mesh(jax.devices()[:int(np.prod(shape))], shape=shape)
    src, dst, n = jentry._small_graph(scale=10)
    align = dict(segment_align=128, edge_align=256)
    cfg = JGraphConfig(num_vertices=n, directed=True, transpose=True,
                       compression=JCompression.TCSC, **align)
    g = JGraph.from_edges(src, dst, None, cfg, mesh=mesh)
    deg = JExecutor(g, JDegree(value_dtype=jnp.float32),
                    JEngineConfig(stationary=True, ordering=JOrdering.COL),
                    kernel="panel")
    deg.initialize()
    deg.execute(1)
    pr = JExecutor(g, JPageRank(value_dtype=jnp.float32),
                   JEngineConfig(stationary=True, ordering=JOrdering.ROW),
                   kernel="panel")
    pr.initialize(other=deg)
    pr.execute(1)
    wts = (1 + (src * 7 + dst * 13) % 128).astype(np.int32)
    gw = JGraph.from_edges(src, dst, wts, j_sssp_config(n), mesh=mesh)
    ss = JExecutor(gw, JSSSP(root=0),
                   JEngineConfig(stationary=False,
                                 gather_depends_on_apply=True,
                                 ordering=JOrdering.ROW), kernel="panel")
    ss.initialize()
    ss.execute(0)
    g2 = JGraph.from_edges(src, dst, None, j_bfs_config(n), mesh=mesh)
    bfs = JExecutor(g2, JBFS(root=0),
                    JEngineConfig(stationary=False,
                                  apply_depends_on_iter=True,
                                  ordering=JOrdering.ROW))
    bfs.initialize()
    bfs.execute(0)
    cfg_cf = JGraphConfig(num_vertices=n, directed=True, transpose=True,
                          compression=JCompression.TCSC_CF, **align)
    g3 = JGraph.from_edges(src, dst, None, cfg_cf, mesh=mesh)
    deg3 = JExecutor(g3, JDegree(value_dtype=jnp.float32),
                     JEngineConfig(stationary=True, ordering=JOrdering.COL))
    deg3.initialize()
    deg3.execute(1)
    pr3 = JExecutor(g3, JPageRank(value_dtype=jnp.float32),
                    JEngineConfig(stationary=True, ordering=JOrdering.ROW))
    pr3.initialize(other=deg3)
    pr3.execute(3)
    out = {}
    for name, ex in (("pagerank", pr), ("sssp", ss), ("bfs", bfs),
                     ("cf_pagerank", pr3)):
        cs, reach = ex.checksum()
        out[name] = ({k: np.asarray(v) for k, v in ex.state_vector().items()},
                     float(cs), int(reach), int(ex.iteration))
    return out


@pytest.fixture(scope="module")
def port_dryrun():
    return {n: graft_entry.dryrun_multichip(n, device="cpu", timeout=300)
            for n in (4, 1)}


def test_dryrun_matches_jax_2x2(port_dryrun):
    got = port_dryrun[4]
    want = _jax_dryrun((2, 2))
    assert list(got) == ["pagerank", "sssp", "bfs", "cf_pagerank"]
    for name, (state, cs, reach, iters) in want.items():
        r = got[name]
        assert r["exchange"] == "gloo" and len(r["ranks"]) == 4, name
        key = STATE_KEY[name]
        assert r["reachable"] == reach, name
        if name in ("bfs", "sssp"):
            assert r["checksum"] == cs and r["iteration"] == iters, name
            for k, v in state.items():
                np.testing.assert_array_equal(r["state"][k], v,
                                              err_msg=f"{name} {k}")
        else:
            assert abs(r["checksum"] - cs) <= 1e-5 * abs(cs), name
            np.testing.assert_allclose(r["state"][key], state[key],
                                       rtol=1e-5, atol=1e-7)
            assert r["iteration"] == iters, name


def test_dryrun_1x1_equals_2x2(port_dryrun):
    a, b = port_dryrun[1], port_dryrun[4]
    for name in graft_entry.DRYRUN_RUNS:
        name = name["name"]
        assert len(a[name]["ranks"]) == 1, name
        assert a[name]["reachable"] == b[name]["reachable"], name
        assert a[name]["iteration"] == b[name]["iteration"], name
        if name in ("bfs", "sssp"):
            assert a[name]["checksum"] == b[name]["checksum"], name
            for k, v in a[name]["state"].items():
                np.testing.assert_array_equal(b[name]["state"][k], v)
        else:
            cs = a[name]["checksum"]
            assert abs(b[name]["checksum"] - cs) <= 1e-6 * abs(cs), name


def test_dryrun_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here")
    with pytest.raises(RuntimeError):
        graft_entry.dryrun_multichip(4)
    with pytest.raises(RuntimeError):
        graft_entry.entry()
