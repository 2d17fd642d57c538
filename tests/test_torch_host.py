"""The torch port's host layer: jax-free import, and partition, tiles and
panel meta byte-identical to the JAX package's."""

import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import jax

from graphtap_tpu.config import Compression as JCompression
from graphtap_tpu.config import GraphConfig as JGraphConfig
from graphtap_tpu.format.tiles import build_tileset as j_build_tileset
from graphtap_tpu.ingest.graph import Graph as JGraph
from graphtap_tpu.kernels.panel_engine import \
    build_spmv3_meta as j_build_spmv3_meta
from graphtap_tpu.parallel.layout import Partition as JPartition
from graphtap_tpu.parallel.layout import make_mesh

from graphtap_tpu_torch import Compression, Graph, GraphConfig, Ordering
from graphtap_tpu_torch.format.tiles import build_tileset
from graphtap_tpu_torch.ingest import rmat_edges
from graphtap_tpu_torch.kernels.panel_meta import (build_spmv3_meta,
                                                   validate_meta)
from graphtap_tpu_torch.parallel.layout import Partition
from graphtap_tpu_torch.tools import artifact_cache
from graphtap_tpu_torch.tools.convert import state_from_numpy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TILE_FIELDS = ("Ep", "NR", "nnz_total", "has_weight", "rows", "cols",
               "weights", "nnz", "ja", "ir", "iv_dense", "nnzrows", "i_own",
               "j_own", "regular_own", "source_own", "sink_own", "nnzcols",
               "jc")
META_SCALARS = artifact_cache._SCALARS


def _same_array(a, b, what):
    if a is None or b is None:
        assert a is None and b is None, what
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, what
    assert a.tobytes() == b.tobytes(), what


def _random_weighted(n=2048, e=30000, seed=4):
    rng = np.random.default_rng(seed)
    r = rng.integers(0, n, size=e).astype(np.int64)
    c = rng.integers(0, n, size=e).astype(np.int64)
    hub = rng.random(e) < 0.2
    c[hub] = rng.integers(0, 16, size=int(hub.sum()))
    w = rng.integers(1, 129, size=e).astype(np.int32)
    return r, c, w, n


def test_import_without_jax_builds_meta():
    """(a) with jax made unimportable, the port imports and plans."""
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "import numpy as np\n"
        "import graphtap_tpu_torch as g\n"
        "from graphtap_tpu_torch.ingest import rmat_edges\n"
        "from graphtap_tpu_torch.kernels.panel_meta import build_spmv3_meta\n"
        "r, c, _ = rmat_edges(8, 16, seed=1)\n"
        "gr = g.Graph.from_edges(r, c, None, g.GraphConfig(\n"
        "    num_vertices=256, transpose=True))\n"
        "m = build_spmv3_meta(gr.tiled(), np.float32)\n"
        "assert m.exp_panels > 0 and m.arrays['xe_plan'].dtype == np.uint8\n"
        "bad = [k for k in sys.modules if k == 'graphtap_tpu'\n"
        "       or k.startswith('graphtap_tpu.')\n"
        "       or (k.startswith('jax') and sys.modules[k] is not None)]\n"
        "assert not bad, bad\n"
        "print('OK')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().endswith("OK")


@pytest.mark.parametrize("nv,segment_align", [(1025, 1024), (5000, 1024),
                                              (300, 128)])
def test_partition_matches_jax(nv, segment_align):
    """The 1x1 layout and the mesh layouts (2x2, 1x4, 2x4) equal the JAX
    package's: sizes, the shard <-> segment maps, the edge -> shard map,
    local/global rows and cols, and the vector layouts."""
    for R, C in ((1, 1), (2, 2), (1, 4), (2, 4)):
        p = Partition.build(nv, R, C, segment_align=segment_align)
        q = JPartition.build(nv, R, C, segment_align=segment_align)
        assert (p.nv, p.R, p.C, p.L) == (q.nv, q.R, q.C, q.L)
        assert (p.n_pad, p.tile_rows, p.tile_cols) == \
            (q.n_pad, q.tile_rows, q.tile_cols)
        _same_array(p.owner_vids(), q.owner_vids(), "owner_vids")
        _same_array(p.shard_perm(), q.shard_perm(), "shard_perm")
        assert [p.shard_of_seg(s) for s in range(p.D)] == \
            [q.shard_of_seg(s) for s in range(q.D)]
        v = np.arange(p.n_pad) * 2 % p.n_pad
        _same_array(p.edge_device(v, v[::-1]), q.edge_device(v, v[::-1]),
                    "dev")
        _same_array(p.local_row(v), q.local_row(v), "local_row")
        _same_array(p.local_col(v), q.local_col(v), "local_col")
        for i in range(R):
            lr = np.arange(p.tile_rows)
            _same_array(p.global_row(i, lr), q.global_row(i, lr), "grow")
        for j in range(C):
            lc = np.arange(p.tile_cols)
            _same_array(p.global_col(j, lc), q.global_col(j, lc), "gcol")
        vec = np.arange(p.n_pad, dtype=np.float32)
        _same_array(p.from_vertex_order(vec), q.from_vertex_order(vec),
                    "from_vertex_order")
        _same_array(p.to_vertex_order(p.from_vertex_order(vec)), vec,
                    "round trip")


def _jax_graph(r, c, w, cfg_kwargs):
    mesh = make_mesh(jax.devices()[:1], shape=(1, 1))
    return JGraph.from_edges(r, c, w, JGraphConfig(**cfg_kwargs), mesh=mesh)


@pytest.mark.parametrize("case", ["pagerank_row", "pagerank_col",
                                  "weighted_int32"])
def test_tiles_and_meta_match_jax(case):
    """(b) tiles and panel meta equal the JAX package's, byte for byte."""
    if case == "weighted_int32":
        r, c, w, n = _random_weighted()
        cfg = dict(num_vertices=n, directed=True, transpose=False,
                   parallel_edges=False)
        ordering, dtype = Ordering.ROW, np.int32
    else:
        r, c, w = rmat_edges(10, 16, seed=1)
        cfg = dict(num_vertices=1024, directed=True, transpose=True)
        ordering = Ordering.COL if case == "pagerank_col" else Ordering.ROW
        dtype = np.float32
    g = Graph.from_edges(r, c, w, GraphConfig(**cfg))
    jg = _jax_graph(r, c, w, cfg)
    for nm in ("r", "c", "w"):
        _same_array(getattr(g, nm), getattr(jg, nm), f"graph.{nm}")
    ts = g.tiled(ordering)
    from graphtap_tpu.config import Ordering as JOrdering
    jts = jg.tiled(JOrdering(ordering.value))
    for f in TILE_FIELDS:
        a, b = getattr(ts, f), getattr(jts, f)
        if isinstance(a, np.ndarray) or a is None:
            _same_array(a, b, f)
        else:
            assert a == b, f
    assert ts.compression.value == jts.compression.value
    meta = build_spmv3_meta(ts, value_dtype=dtype)
    jmeta = j_build_spmv3_meta(jts, value_dtype=dtype)
    for k in META_SCALARS:
        assert getattr(meta, k) == getattr(jmeta, k), k
    assert sorted(meta.arrays) == sorted(jmeta.arrays)
    for k in meta.arrays:
        _same_array(meta.arrays[k], jmeta.arrays[k], k)
    if case == "weighted_int32":
        assert meta.has_w and meta.arrays["w_stream"].dtype == np.int32


def test_build_tileset_matches_jax_csc():
    """Plain CSC (no renumbering) tiles are byte-identical too."""
    r, c, w, n = _random_weighted(n=1500, e=8000, seed=8)
    p = Partition.build(n, 1, 1)
    ts = build_tileset(r, c, w, p, compression=Compression.CSC)
    jts = j_build_tileset(r, c, w, JPartition.build(n, 1, 1),
                          compression=JCompression.CSC)
    for f in TILE_FIELDS:
        a, b = getattr(ts, f), getattr(jts, f)
        if isinstance(a, np.ndarray) or a is None:
            _same_array(a, b, f)
        else:
            assert a == b, f


def test_validate_meta_rejects_out_of_range_indices():
    r, c, _ = rmat_edges(8, 16, seed=1)
    g = Graph.from_edges(r, c, None, GraphConfig(num_vertices=256,
                                                 transpose=True))
    meta = build_spmv3_meta(g.tiled(), np.float32)
    bad = dict(meta.arrays)
    bad["pa_bases"] = bad["pa_bases"].copy()
    bad["pa_bases"][0, -1] = (meta.exp_panels + 1) * 8     # one past s0
    with pytest.raises(ValueError, match="pa_bases"):
        validate_meta(types.SimpleNamespace(**{**meta.__dict__,
                                               "arrays": bad}))
    bad = dict(meta.arrays)
    bad["pa_plan"] = bad["pa_plan"].copy()
    bad["pa_plan"][0, 0, 0] = 200                          # idx1 lane
    with pytest.raises(ValueError, match="idx1"):
        validate_meta(types.SimpleNamespace(**{**meta.__dict__,
                                               "arrays": bad}))


def test_run_pagerank_on_cuda_raises_without_cuda():
    """(c) no silent CPU fallback: asking for the card without one raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from graphtap_tpu_torch.apps import run_pagerank
    r, c, _ = rmat_edges(8, 16, seed=1)
    g = Graph.from_edges(r, c, None, GraphConfig(num_vertices=256,
                                                 transpose=True))
    with pytest.raises(RuntimeError, match="CUDA"):
        run_pagerank(g, 20, torch.float32, kernel="panel", device="cuda")


@pytest.mark.parametrize("entry", ["Executor", "run_pagerank", "run_bfs",
                                   "run_cc", "run_sssp"])
def test_entry_points_default_to_cuda(entry):
    """Every entry point runs on the card unless told 'cpu': without CUDA
    a call with the default device raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from graphtap_tpu_torch import apps
    from graphtap_tpu_torch.engine.executor import Executor
    r, c, _ = rmat_edges(8, 16, seed=1)
    g = Graph.from_edges(r, c, None, apps.bfs_config(256))
    call = {"Executor": lambda: Executor(g, apps.BFSProgram(0)),
            "run_pagerank": lambda: apps.run_pagerank(g, 2),
            "run_bfs": lambda: apps.run_bfs(g, 0),
            "run_cc": lambda: apps.run_cc(g),
            "run_sssp": lambda: apps.run_sssp(g, 0, weighted=False)}[entry]
    with pytest.raises(RuntimeError, match="CUDA"):
        call()


def test_copied_package_runs_alone(tmp_path):
    """The port copied alone (no graphtap_tpu/ beside it), with jax made
    unimportable and an audit hook that fails any open of a path under
    the repository's graphtap_tpu/: it imports, builds its own native
    library, plans a panel meta, a shuffle plan, a v2 meta and a one-hot
    plan, runs the scan SpMV, and runs the kernel lab's variant 8 (DCSC
    tiles) on an edge file it writes."""
    import shutil
    shutil.copytree(os.path.join(REPO, "graphtap_tpu_torch"),
                    tmp_path / "graphtap_tpu_torch",
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    jax_pkg = os.path.join(REPO, "graphtap_tpu")
    code = (
        "import os, sys\n"
        "sys.modules['jax'] = None\n"
        f"JAX_PKG = {jax_pkg!r}\n"
        "def hook(event, args):\n"
        "    if event == 'open' and isinstance(args[0], (str, bytes)):\n"
        "        p = os.path.abspath(os.fsdecode(args[0]))\n"
        "        if p == JAX_PKG or p.startswith(JAX_PKG + os.sep):\n"
        "            raise RuntimeError('opened ' + p)\n"
        "sys.addaudithook(hook)\n"
        "import numpy as np, torch\n"
        "import graphtap_tpu_torch as g\n"
        "assert os.path.dirname(g.__file__).startswith(os.getcwd())\n"
        "from graphtap_tpu_torch import native\n"
        "from graphtap_tpu_torch.ingest import rmat_edges\n"
        "from graphtap_tpu_torch.kernels.panel_meta import build_spmv3_meta\n"
        "from graphtap_tpu_torch.kernels.shuffle_engine import "
        "build_shuffle_plans\n"
        "from graphtap_tpu_torch.kernels.semiring import plus_times\n"
        "from graphtap_tpu_torch.kernels.spmv import (expand_compact,\n"
        "    spmv_sorted_scan)\n"
        "r, c, _ = rmat_edges(8, 16, seed=1)\n"
        "gr = g.Graph.from_edges(r, c, None, g.GraphConfig(\n"
        "    num_vertices=256, transpose=True))\n"
        "ts = gr.tiled()\n"
        "m = build_spmv3_meta(ts, np.float32)\n"
        "assert m.exp_panels > 0\n"
        "s = build_shuffle_plans(ts, np.float32)\n"
        "assert s.arrays['frag_idx'].dtype == np.int8\n"
        "from graphtap_tpu_torch.kernels.gather_engine import "
        "build_spmv2_meta\n"
        "from graphtap_tpu_torch.kernels.onehot_spmv import "
        "build_onehot_plan\n"
        "v2 = build_spmv2_meta(ts, np.float32)\n"
        "assert v2.arrays['exp_meta'].dtype == np.uint8\n"
        "oh = build_onehot_plan(ts)\n"
        "assert int(oh.evalid.sum()) == int(ts.nnz[0, 0])\n"
        "import shutil\n"
        "has_cxx = shutil.which(os.environ.get('CXX', 'g++')) is not None\n"
        "assert native.available() == has_cxx\n"
        "assert native.library_path().startswith(os.getcwd())\n"
        "n = int(ts.nnz[0, 0])\n"
        "T = lambda a: torch.from_numpy(np.ascontiguousarray(a))\n"
        "x = torch.ones(gr.part.tile_cols)\n"
        "y = spmv_sorted_scan(x, T(ts.rows[0].astype(np.int64)),\n"
        "                     T(ts.cols[0].astype(np.int64)), None, n,\n"
        "                     T(ts.ja[0]), plus_times())\n"
        "y = expand_compact(y, T(ts.iv_dense[0]), plus_times())\n"
        "assert int(y.sum()) == n\n"
        "from graphtap_tpu_torch.ingest.io import write_binary\n"
        "from graphtap_tpu_torch.tools import kernel_lab\n"
        "write_binary('rmat8.bin', r, c)\n"
        "lab = kernel_lab.run_variant(8, 'rmat8.bin', 257, 3, device='cpu')\n"
        "assert lab['variant'] == 'scan/dcsc'\n"
        "assert lab['operations'] == 3 * r.size, lab\n"
        "bad = [k for k in sys.modules if k == 'graphtap_tpu'\n"
        "       or k.startswith('graphtap_tpu.')\n"
        "       or (k.startswith('jax') and sys.modules[k] is not None)]\n"
        "assert not bad, bad\n"
        "print('OK')\n")
    env = dict(os.environ, PYTHONPATH=str(tmp_path))
    res = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().endswith("OK")
    if shutil.which(os.environ.get("CXX", "g++")):      # built its own
        assert list((tmp_path / "graphtap_tpu_torch" / "build").glob(
            "libgraphtap_host_*.so"))


def test_artifact_cache_roundtrip_and_key(tmp_path):
    r, c, _ = rmat_edges(8, 16, seed=1)
    cfg = GraphConfig(num_vertices=256, transpose=True)
    g = Graph.from_edges(r, c, None, cfg)
    ts = g.tiled()
    m1 = artifact_cache.cached_spmv3_meta(ts, 8, 16, 1, cfg, Ordering.ROW,
                                          np.float32, cache_dir=tmp_path)
    files = list(tmp_path.iterdir())
    assert len(files) == 1
    m2 = artifact_cache.cached_spmv3_meta(ts, 8, 16, 1, cfg, Ordering.ROW,
                                          np.float32, cache_dir=tmp_path)
    for k in META_SCALARS:
        assert getattr(m1, k) == getattr(m2, k), k
    for k in m1.arrays:
        _same_array(m1.arrays[k], m2.arrays[k], k)

    def key(scale=8, ef=16, seed=1, config=cfg, ordering=Ordering.ROW,
            dtype=np.float32, weighted=False):
        return artifact_cache.meta_key(scale, ef, seed, config, ordering,
                                       dtype, weighted)

    keys = {key(), key(seed=2), key(ordering=Ordering.COL),
            key(dtype=np.float64), key(scale=9), key(ef=8),
            key(weighted=True),
            key(config=GraphConfig(num_vertices=256, transpose=True,
                                   self_loops=False))}
    assert len(keys) == 8
    assert artifact_cache.source_hash() in files[0].name


def test_artifact_cache_keys_on_graph_config(tmp_path):
    """One RMAT edge list read through BFS's config (self-loops dropped)
    and CC's (kept) gives two plans: each gets its own key, and the cache
    serves each its own meta, byte-equal to a fresh build."""
    from graphtap_tpu_torch.apps import bfs_config, cc_config
    r, c, _ = rmat_edges(8, 16, seed=1)
    n = 256
    got = {}
    for cfg_fn in (bfs_config, cc_config):
        cfg = cfg_fn(n)
        ts = Graph.from_edges(r, c, None, cfg).tiled()
        got[cfg_fn.__name__] = (
            ts, artifact_cache.meta_key(8, 16, 1, cfg, Ordering.ROW,
                                        np.int32, False))
        artifact_cache.cached_spmv3_meta(ts, 8, 16, 1, cfg, Ordering.ROW,
                                         np.int32, cache_dir=tmp_path)
    assert got["bfs_config"][1] != got["cc_config"][1]
    assert len(list(tmp_path.iterdir())) == 2
    assert got["bfs_config"][0].nnz_total != got["cc_config"][0].nnz_total
    for cfg_fn in (bfs_config, cc_config):
        ts = got[cfg_fn.__name__][0]
        served = artifact_cache.cached_spmv3_meta(
            ts, 8, 16, 1, cfg_fn(n), Ordering.ROW, np.int32,
            cache_dir=tmp_path)
        fresh = build_spmv3_meta(ts, value_dtype=np.int32)
        for k in META_SCALARS:
            assert getattr(served, k) == getattr(fresh, k), k
        assert served.arrays.keys() == fresh.arrays.keys()
        for k in fresh.arrays:
            _same_array(served.arrays[k], fresh.arrays[k], k)


def test_state_from_numpy_layout():
    st = state_from_numpy({"rank": np.arange(6.0).reshape(1, 6),
                           "deg": np.ones((1, 6), np.int32)})
    assert st["rank"].shape == (6,) and st["rank"].dtype == torch.float64
    assert st["deg"].dtype == torch.int32
    with pytest.raises(ValueError):
        state_from_numpy({"rank": np.zeros((2, 6))})
