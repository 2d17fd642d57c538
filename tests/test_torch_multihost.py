"""The port's multi-process runtime (``parallel/multihost.py``,
``parallel/launch.py``): the ports of ``tests/test_multihost.py`` on
generated graphs (``rmat_edges(12, 16, seed=1)`` and its weighted twin;
``rmat_edges(10, 16, seed=1)`` for the byte ranges), with four real gloo
ranks where the JAX tests simulate the processes:

  * byte ranges partition a written binary file, as the JAX reader's do;
  * ``host_edge_share`` partitions the edges among the shards, as the JAX
    package's does with one process a device;
  * ``exchange_edges`` on four ranks (a 2x2 mesh, through
    ``Graph.load``) conserves the edge count, and each rank holds exactly
    the edges of its tiles in either ordering;
  * the distributed TCSC (ROW and COL) and TCSC_CF tiles (all four
    sets) of each rank equal row b of the JAX package's single-process
    (D, ...) tiles, byte for byte, with the same Ep, NR, edge total and
    per-device counts;
  * the host reductions and ``allgather_state`` across four ranks, and
    ``allgather_state`` is the identity (the rank's row, stacked) at
    world size 1;
  * the launcher fails fast on a failed rank and at its timeout.
"""

import dataclasses
import json
import os
import sys
import time

import numpy as np
import pytest
import torch

import jax

from graphtap_tpu.apps.sssp import sssp_config as j_sssp_config
from graphtap_tpu.config import Compression as JCompression
from graphtap_tpu.config import GraphConfig as JGraphConfig
from graphtap_tpu.config import Ordering as JOrdering
from graphtap_tpu.ingest.graph import Graph as JGraph
from graphtap_tpu.ingest.io import read_edge_list as j_read_edge_list
from graphtap_tpu.parallel import multihost as jmh
from graphtap_tpu.parallel.layout import Partition as JPartition
from graphtap_tpu.parallel.layout import make_mesh as j_make_mesh

from graphtap_tpu_torch import Graph, GraphConfig, Ordering
from graphtap_tpu_torch.ingest import rmat_edges
from graphtap_tpu_torch.ingest.io import read_edge_list, write_binary
from graphtap_tpu_torch.parallel import multihost as mh
from graphtap_tpu_torch.parallel.launch import LaunchError, launch
from graphtap_tpu_torch.parallel.layout import Partition
from graphtap_tpu_torch.tools import artifact_cache as ac

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCALE, EDGE_FACTOR, SEED = 12, 16, 1
N = 1 << SCALE
ALIGN = 128
LAUNCH_TIMEOUT = 180
TILE_FIELDS = ("rows", "cols", "weights", "nnz", "ja", "ir", "iv_dense",
               "nnzrows", "i_own", "j_own", "regular_own", "source_own",
               "sink_own", "nnzcols")


def _env():
    return dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")


@pytest.mark.parametrize("pcnt", [2, 3, 5])
@pytest.mark.parametrize("weighted", [False, True])
def test_byte_range_reads_partition_the_file(tmp_path, weighted, pcnt):
    r, c, w = rmat_edges(10, EDGE_FACTOR, seed=SEED, weighted=weighted)
    path = str(tmp_path / "g.bin")
    write_binary(path, r, c, w)
    full = read_edge_list(path, has_weight=weighted)
    parts = [read_edge_list(path, has_weight=weighted, process_index=p,
                            process_count=pcnt) for p in range(pcnt)]
    for k in range(3 if weighted else 2):
        np.testing.assert_array_equal(
            np.concatenate([p[k] for p in parts]), full[k])
    for p in range(pcnt):
        jp = j_read_edge_list(path, has_weight=weighted, process_index=p,
                              process_count=pcnt)
        for k in range(3 if weighted else 2):
            np.testing.assert_array_equal(parts[p][k], jp[k])


def test_host_edge_share_partitions_edges():
    part = Partition.build(1025, 2, 4, segment_align=ALIGN)
    jpart = JPartition.build(1025, 2, 4, segment_align=ALIGN)
    jmesh = j_make_mesh(jax.devices()[:8], shape=(2, 4))
    rng = np.random.default_rng(0)
    r = rng.integers(0, 1025, size=5000)
    c = rng.integers(0, 1025, size=5000)
    masks = [mh.host_edge_share(r, c, part, b) for b in range(8)]
    np.testing.assert_array_equal(np.sum(masks, axis=0), 1)  # a partition
    for b, m in enumerate(masks):
        np.testing.assert_array_equal(m, jmh.host_edge_share(
            r, c, jpart, jmesh, process_index=b, proc_map=np.arange(8)))


@pytest.fixture(scope="module")
def edges():
    r, c, _ = rmat_edges(SCALE, EDGE_FACTOR, seed=SEED)
    rw, cw, w = rmat_edges(SCALE, EDGE_FACTOR, seed=SEED, weighted=True)
    return {"pr": (r, c, None), "sssp": (rw, cw, w)}


@pytest.fixture(scope="module")
def ranks_out(edges, tmp_path_factory):
    """One launch of four gloo ranks on a 2x2 mesh: each loads its byte
    range of both files and writes its edges and its tiles."""
    root = tmp_path_factory.mktemp("multihost")
    graphs = {}
    for nm, cfg in (("pr", "pr"), ("prcf", "pr"), ("sssp", "sssp")):
        r, c, w = edges["sssp" if nm == "sssp" else "pr"]
        path = root / f"{nm}.bin"
        write_binary(str(path), r, c, w)
        graphs[nm] = {"path": str(path), "nv": N, "config": cfg,
                      "overrides": {"segment_align": ALIGN}}
    graphs["prcf"]["overrides"]["compression"] = "tcsc_cf"
    spec = {"shape": [2, 2], "backend": "gloo", "device": "cpu",
            "out": str(root / "out"), "graphs": graphs,
            "edges": ["pr", "sssp"],
            "tiles": [{"graph": "pr", "ordering": "ROW"},
                      {"graph": "pr", "ordering": "COL"},
                      {"graph": "sssp", "ordering": "ROW"},
                      {"graph": "prcf", "ordering": "ROW", "cf": True}]}
    path = root / "spec.json"
    path.write_text(json.dumps(spec))
    launch([sys.executable, "-m", "graphtap_tpu_torch.tools.mesh_run",
            str(path)], 4, LAUNCH_TIMEOUT, env=_env(), cwd=REPO)
    return root / "out"


def _jgraph(edges, nm):
    r, c, w = edges["sssp" if nm == "sssp" else "pr"]
    if nm == "sssp":
        cfg = j_sssp_config(N)
    else:
        cfg = JGraphConfig(num_vertices=N, directed=True, transpose=True,
                           compression=JCompression.TCSC_CF if nm == "prcf"
                           else JCompression.TCSC)
    cfg = dataclasses.replace(cfg, segment_align=ALIGN)
    return JGraph.from_edges(r, c, w, cfg, mesh=j_make_mesh(
        jax.devices()[:4], shape=(2, 2)))


@pytest.mark.parametrize("nm", ["pr", "sssp"])
def test_exchange_edges_conserves_edges(ranks_out, edges, nm):
    jg = _jgraph(edges, nm)       # the transformed edges, as every rank's
    part = Partition.build(N + 1, 2, 2, segment_align=ALIGN)
    own = 0
    for b in range(4):
        with np.load(ranks_out / f"edges_{nm}_b{b}.npz") as z:
            got = {k: z[k] for k in z.files}
        mine = mh.host_edge_share(jg.r, jg.c, part, b)
        own += int(mh.host_edge_share(got["r"], got["c"], part, b).sum())
        keep = mine | mh.host_edge_share(jg.c, jg.r, part, b)
        want = [jg.r[keep], jg.c[keep]] + ([np.asarray(jg.w)[keep]]
                                           if nm == "sssp" else [])
        have = [got["r"], got["c"]] + ([got["w"]] if nm == "sssp" else [])
        # the same multiset of edges (the exchange reorders them)
        o1, o2 = np.lexsort(want[::-1]), np.lexsort(have[::-1])
        for a, b_ in zip(want, have):
            np.testing.assert_array_equal(np.asarray(a)[o1], b_[o2])
    assert own == jg.r.size       # each edge has one ROW owner


@pytest.mark.parametrize("case", ["pr-ROW", "pr-COL", "sssp-ROW",
                                  "prcf-ROW"])
def test_distributed_tiles_equal_global(ranks_out, edges, case):
    nm, ordering = case.split("-")
    jg = _jgraph(edges, nm)
    jord = JOrdering[ordering]
    sets = jg.tiled_cf(jord) if nm == "prcf" else {"main": jg.tiled(jord)}
    tag = "_cf" if nm == "prcf" else ""
    for b in range(4):
        with np.load(ranks_out / f"tiles_{nm}_{ordering}{tag}_b{b}.npz") \
                as z:
            got = {k: z[k] for k in z.files}
        for sname, ts in sets.items():
            Ep, NR, total = got[f"{sname}_scalars"]
            assert (Ep, NR, total) == (ts.Ep, ts.NR, ts.nnz_total), sname
            np.testing.assert_array_equal(got[f"{sname}_dev_nnz"],
                                          ts.nnz[:, 0])
            for f in TILE_FIELDS:
                a = getattr(ts, f)
                assert (a is None) == (f"{sname}_{f}" not in got), (sname, f)
                if a is None:
                    continue
                g = got[f"{sname}_{f}"]
                assert g.dtype == a.dtype and g.shape == a[b].shape, \
                    (case, sname, f, b)
                assert g.tobytes() == np.ascontiguousarray(a[b]).tobytes(), \
                    (case, sname, f, b)


_REDUCE = r"""
import json, sys
import numpy as np, torch
from graphtap_tpu_torch.parallel import multihost as mh
from graphtap_tpu_torch.parallel.layout import make_mesh
rank, world = mh.initialize()
mesh = make_mesh()
out = {"shape": list(mesh.shape),
       "or": mh.global_or(np.array([rank == 1, False, rank >= 2]),
                          mesh).tolist(),
       "max": mh.global_max(np.array([rank, 7 - rank], np.int32),
                            mesh).tolist(),
       "sum": int(mh.global_sum(np.int64(rank + 1), mesh)),
       "state": mh.allgather_state(torch.arange(3) + 10 * rank,
                                   mesh).tolist(),
       "bools": mh.allgather_state(torch.tensor([rank % 2 == 0]),
                                   mesh).tolist()}
# a checkpoint of a 2x2 PageRank resumes bit for bit; a rank's tile set
# round-trips with its mesh partition
from graphtap_tpu_torch import Executor, Graph, GraphConfig, Ordering
from graphtap_tpu_torch.apps import PageRankProgram, run_degree
from graphtap_tpu_torch.ingest import rmat_edges
from graphtap_tpu_torch.tools import artifact_cache as ac
from graphtap_tpu_torch.tools.checkpoint import load_state, save_state
r, c, _ = rmat_edges(8, 16, seed=1)
g = Graph.from_edges(r, c, None, GraphConfig(
    num_vertices=256, transpose=True, segment_align=128), mesh=mesh)
deg = run_degree(g, torch.float64, Ordering.COL, "scan", "cpu")

def pr():
    ex = Executor(g, PageRankProgram(torch.float64), kernel="scan",
                  device="cpu")
    ex.initialize(other=deg)
    return ex
whole, half = pr(), pr()
whole.execute(6)
half.execute(3)
save_state(half, sys.argv[2])
resumed = pr()
out["resumed_at"] = load_state(resumed, sys.argv[2])
resumed.execute(3)
out["resumed_equal"] = bool(np.array_equal(
    resumed.state_vector()["rank"], whole.state_vector()["rank"]))
path = f"{sys.argv[2]}.tiles{rank}.npz"
ts = g.tiled(Ordering.ROW)
ac.save_tileset(ts, path)
back = ac.load_tileset(path, mesh)
out["tiles_equal"] = bool(back.part == ts.part and np.array_equal(
    back.rows, ts.rows) and np.array_equal(back.dev_nnz, ts.dev_nnz))
if rank == 0:
    json.dump(out, open(sys.argv[1], "w"))
"""


def test_host_reductions_and_allgather_across_ranks(tmp_path):
    """... and, on the same four ranks, a checkpoint of a 2x2 run
    (``tools/checkpoint.py``) and a rank's tile set
    (``artifact_cache.save_tileset``/``load_tileset``)."""
    path = tmp_path / "reduce.json"
    ckpt = tmp_path / "ckpt.npz"
    launch([sys.executable, "-c", _REDUCE, str(path), str(ckpt)], 4,
           LAUNCH_TIMEOUT, env=_env(), cwd=REPO)
    out = json.loads(path.read_text())
    assert out["shape"] == [2, 2]
    assert out["or"] == [True, False, True]
    assert out["max"] == [3, 7]
    assert out["sum"] == 10
    assert out["state"] == [[10 * b + k for k in range(3)] for b in range(4)]
    assert out["bools"] == [[True], [False], [True], [False]]
    assert out["resumed_at"] == 3 and out["resumed_equal"]
    assert out["tiles_equal"]
    with np.load(ckpt) as z:                 # the gathered (D, L) state
        assert z["rank"].shape[0] == 4
        assert json.loads(bytes(z["__meta__"]).decode())["mesh"] == [2, 2]


def test_plan_cache_keys_name_the_mesh(tmp_path):
    """A plan key names the mesh shape and the shard, so a 1x1 plan is
    never served to a mesh rank; a mesh rank's tile set needs its mesh."""
    from graphtap_tpu_torch import GraphConfig, Ordering
    from graphtap_tpu_torch.tools import artifact_cache as ac
    cfg = GraphConfig(num_vertices=N)
    keys = {ac.meta_key(8, 16, 1, cfg, Ordering.ROW, np.float32, False,
                        "spmv3", "main", shape, b)
            for shape, b in (((1, 1), 0), ((2, 2), 0), ((2, 2), 1),
                             ((1, 4), 1))}
    assert len(keys) == 4
    r, c, _ = rmat_edges(8, 16, seed=1)
    ts = Graph.from_edges(r, c, None, GraphConfig(num_vertices=256)).tiled()
    path = tmp_path / "t.npz"
    ac.save_tileset(ts, path)
    assert ac.load_tileset(path).part == ts.part
    ts.part = Partition.build(257, 2, 2)
    ac.save_tileset(ts, path)
    with pytest.raises(ValueError, match="needs a mesh"):
        ac.load_tileset(path)


def test_allgather_state_identity():
    x = torch.arange(32.0)
    np.testing.assert_array_equal(mh.allgather_state(x), x.numpy()[None])
    m = np.array([True, False])
    assert mh.global_or(m) is m
    np.testing.assert_array_equal(mh.global_max([3, 4]), [3, 4])
    np.testing.assert_array_equal(mh.global_sum([3, 4]), [3, 4])
    r = np.array([1, 2, 3])
    r2, c2, w2 = mh.exchange_edges(r, r + 1, None, Partition.build(1025),
                                   None)
    assert r2 is r and w2 is None
    assert mh.shard_of(Partition.build(1025), None) == 0
    with pytest.raises(ValueError, match="needs a mesh"):
        mh.shard_of(Partition.build(1025, 2, 2), None)


def test_launch_fails_fast():
    t0 = time.monotonic()
    code = "import os, sys, time; r = int(os.environ['RANK']); " \
        "sys.exit(3) if r == 2 else time.sleep(60)"
    with pytest.raises(LaunchError) as e:
        launch([sys.executable, "-c", code], 4, 50)
    assert e.value.failed == 2 and e.value.results[2].returncode == 3
    assert time.monotonic() - t0 < 30
    with pytest.raises(LaunchError) as e:
        launch([sys.executable, "-c", "import time; time.sleep(60)"], 2, 2)
    assert e.value.failed is None
    assert all(r.returncode != 0 for r in e.value.results)
    out = launch([sys.executable, "-c", "import os; print(os.environ["
                  "'RANK'], os.environ['WORLD_SIZE'], os.environ["
                  "'OMP_NUM_THREADS'])"], 3, 30, env=dict(
                      os.environ, OMP_NUM_THREADS="1"))
    assert [r.stdout.split() for r in out] == [[str(b), "3", "1"]
                                               for b in range(3)]
