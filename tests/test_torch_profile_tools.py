"""The port's BFS gate A/B, its sparse-exchange sweep and
``scatter_to_dense``, against the JAX package and the golden model.

``tools/bfs_profile.py`` on RMAT-10 (``--device cpu``): the gate forced,
off and auto agree with each other, with the JAX BFS on the same graph
and with ``tests/golden.py::bfs``, and the profiled breakdown has the
scatter_gather, combine and apply phases. ``tools/sparse_exchange_bench.
py`` on RMAT-10 at 2x4 (eight gloo ranks): every K equals K = 0 and the
JAX BFS, the JSON line has the reference's keys, and no file is written
but ``--out``. ``kernels/spmv.py::scatter_to_dense`` against the JAX
function on the cases of ``tests/test_kernels.py:82-114``.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from graphtap_tpu.apps import bfs as jbfs
from graphtap_tpu.ingest.graph import Graph as JGraph
from graphtap_tpu.kernels import semiring as jsr
from graphtap_tpu.kernels.spmv import expand_compact as j_expand_compact
from graphtap_tpu.kernels.spmv import scatter_to_dense as j_scatter
from graphtap_tpu.parallel.layout import make_mesh as j_make_mesh

from graphtap_tpu_torch.ingest import rmat_edges
from graphtap_tpu_torch.kernels import semiring as tsr
from graphtap_tpu_torch.kernels.spmv import expand_compact, scatter_to_dense
from graphtap_tpu_torch.tools import bfs_profile, sparse_exchange_bench

sys.path.insert(0, os.path.dirname(__file__))
import golden  # noqa: E402

SCALE = 10
NV = (1 << SCALE) + 1        # the tools' default bfs_config vertex count
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jax_bfs():
    """The JAX package's BFS from root 0 on RMAT-10 through
    ``bfs_config(NV)``, 1x1 -> (state, checksum, reachable, iteration)."""
    r, c, _ = rmat_edges(SCALE, 16, seed=1)
    mesh = j_make_mesh(jax.devices()[:1], shape=(1, 1))
    ex = jbfs.run_bfs(JGraph.from_edges(r, c, None, jbfs.bfs_config(NV),
                                        mesh=mesh), 0)
    cs, reach = ex.checksum()
    return ({k: np.asarray(v) for k, v in ex.state_vector().items()},
            float(cs), int(reach), int(ex.iteration))


def test_bfs_profile_gates_agree_with_jax_and_golden(tmp_path, jax_bfs):
    res = bfs_profile.profile(SCALE, "cpu", cache=str(tmp_path))
    jstate, jcs, jreach, jiters = jax_bfs
    assert set(res["gates"]) == {"1", "0", "auto"}
    for gate, r in res["gates"].items():
        assert (r["checksum"], r["reachable"], r["iters"]) == (
            jcs, jreach, jiters), gate
        assert r["seconds"] > 0
    assert all(res["gates"]["1"]["gated"])
    assert not any(res["gates"]["0"]["gated"])
    for k, v in jstate.items():
        np.testing.assert_array_equal(res["state"][k], v, err_msg=k)
    r, c, _ = rmat_edges(SCALE, 16, seed=1)
    parent, hops = golden.bfs(r, c, res["state"]["hops"].shape[0], 0)
    np.testing.assert_array_equal(res["state"]["hops"], hops)
    np.testing.assert_array_equal(res["state"]["parent"], parent)
    phases = res["phases"]
    assert {"scatter_gather", "combine", "apply"} <= set(phases)
    assert len(phases["combine"]) == jiters + 1      # and the flush
    # the artifacts came back from the cache the second time
    names = sorted(os.listdir(tmp_path))
    assert any(n.startswith("tiles_") for n in names)
    assert any(n.startswith("spmv3_") for n in names)
    g, tiles, plans = bfs_profile.artifacts(SCALE, str(tmp_path))
    assert sorted(os.listdir(tmp_path)) == names


def test_bfs_profile_main_prints_the_ab(tmp_path, capsys):
    assert bfs_profile.main([str(SCALE), "--device", "cpu", "--cache",
                             str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "[prof] gate forced/off/auto:" in out
    assert "combine" in out and "scatter_gather" in out


def test_sparse_exchange_sweep_2x4(tmp_path, capsys, jax_bfs):
    out = tmp_path / "rows.jsonl"
    with open(os.path.join(ROOT, "BENCH_SUITE.json"), "rb") as f:
        suite_before = f.read()
    assert sparse_exchange_bench.main([str(SCALE), "--device", "cpu",
                                       "--out", str(out)]) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    rec = json.loads(line)
    assert json.loads(out.read_text()) == rec
    assert os.listdir(tmp_path) == ["rows.jsonl"]
    with open(os.path.join(ROOT, "BENCH_SUITE.json"), "rb") as f:
        assert f.read() == suite_before
    assert set(rec) == {"metric", "value", "unit", "detail"}
    assert rec["metric"] == f"sparse_exchange_crossover_rmat{SCALE}"
    assert {"rows", "mesh", "app", "note"} <= set(rec["detail"])
    rows = rec["detail"]["rows"]
    assert [r["K"] for r in rows] == list(sparse_exchange_bench.CAPACITIES)
    _, jcs, jreach, jiters = jax_bfs
    assert (rec["detail"]["checksum"], rec["detail"]["reachable"]) == (
        jcs, jreach)
    assert all(r["iters"] == jiters and r["seconds"] > 0 for r in rows)
    dense = rows[0]["seconds"]
    assert rec["value"] == min(r["seconds"] for r in rows[1:]) / dense
    assert "gloo" in rec["detail"]["mesh"]
    # K = 0 never takes the sparse branch; a K past every count always
    sparse = rec["detail"]["sparse"]
    assert not any(sparse["0"]) and all(sparse["16384"])


def test_scatter_to_dense_matches_jax():
    """``test_expand_compact_matches_scatter`` and
    ``test_scatter_to_dense_drops_padding`` (tests/test_kernels.py:82-114),
    and a negative index, on the port against the JAX function."""
    y_comp = np.array([1.0, 2.0, 3.0])
    ir = np.array([4, 7, 10], np.int32)       # 10 == dense_len: dropped
    iv = np.full(10, -1, np.int32)
    iv[4], iv[7] = 0, 1
    got = scatter_to_dense(torch.from_numpy(y_comp), torch.from_numpy(ir),
                           10, tsr.plus_times())
    want = np.asarray(j_scatter(jnp.asarray(y_comp), jnp.asarray(ir), 10,
                                jsr.plus_times()))
    assert got.dtype == torch.float64
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[4] == 1.0 and got[7] == 2.0 and float(got.sum()) == 3.0
    np.testing.assert_array_equal(
        got.numpy(), expand_compact(torch.from_numpy(y_comp),
                                    torch.from_numpy(iv),
                                    tsr.plus_times()).numpy())
    np.testing.assert_array_equal(
        want, np.asarray(j_expand_compact(jnp.asarray(y_comp),
                                          jnp.asarray(iv),
                                          jsr.plus_times())))
    # min semiring: untouched rows hold INF; a negative index counts from
    # the end, as numpy's (and the JAX scatter's)
    yi = np.array([5, 6, 7], np.int32)
    ir2 = np.array([-1, 2, 12], np.int32)
    got = scatter_to_dense(torch.from_numpy(yi), torch.from_numpy(ir2), 8,
                           tsr.min_select())
    want = np.asarray(j_scatter(jnp.asarray(yi), jnp.asarray(ir2), 8,
                                jsr.min_select()))
    np.testing.assert_array_equal(got.numpy(), want)
