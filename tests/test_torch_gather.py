"""The port's v2 windowed-gather path on the CPU: its v2 plans
byte-identical to the JAX package's; the plain K9 and K10 against the
Pallas kernels in interpret mode; ``spmv2_local`` against the JAX
package's; and PageRank, BFS, CC and SSSP through
``Executor(kernel="shuffle2")`` against ``tests/golden.py`` and the JAX
shuffle2 executor. Inputs come from numpy seeds and ``rmat_edges(10, 16,
seed=1)``.

Tolerances: K9 and K10 move values and apply at most one ⊗, the same
operation as the Pallas kernel's, so they match bit for bit
(``assert_array_equal``, which, like ``torch.equal``, takes -0.0 and 0.0
as equal: under ``mul`` a never-written slot holds fill * w, which is
-0.0 for a negative w). The whole SpMV matches bit for bit in int32 min
and max and within rtol 1e-12 in f64 sums: K8's order of addition differs
from the Pallas kernel's chunk-by-chunk order."""

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
from graphtap_tpu.config import Ordering as JOrdering
from graphtap_tpu.apps import bfs as jbfs
from graphtap_tpu.apps import sssp as jsssp
from graphtap_tpu.ingest.graph import Graph as JGraph
from graphtap_tpu.kernels import gather_kernels as jgk
from graphtap_tpu.kernels import semiring as jsr
from graphtap_tpu.kernels.gather_engine import \
    build_spmv2_meta as j_build_spmv2_meta
from graphtap_tpu.kernels.gather_engine import spmv2_local as j_spmv2_local
from graphtap_tpu.kernels.gather_plan import build_gather_plan
from graphtap_tpu.parallel.layout import make_mesh

from graphtap_tpu_torch import Graph, GraphConfig, Ordering
from graphtap_tpu_torch.apps import (PageRankProgram, bfs_config, cc_config,
                                     run_bfs, run_cc, run_pagerank, run_sssp,
                                     sssp_config)
from graphtap_tpu_torch.engine.executor import Executor
from graphtap_tpu_torch.ingest import rmat_edges
from graphtap_tpu_torch.kernels import gather_kernels as gk
from graphtap_tpu_torch.kernels import semiring as tsr
from graphtap_tpu_torch.kernels.gather_engine import (
    STAGES, Spmv2Meta, build_spmv2_meta, spmv2_local, spmv2_stages,
    validate_spmv2_meta)
from graphtap_tpu_torch.kernels.gather_plan import LANES, SUB
from graphtap_tpu_torch.kernels.shuffle_engine import build_shuffle_plans
from graphtap_tpu_torch.tools import artifact_cache
from graphtap_tpu_torch.tools.convert import meta_from_numpy

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import golden  # noqa: E402

INF = tsr.INF_I32
NEG_INF = -INF - 1
N = 1024
ITERS = 20
JAX_ITERS = 3


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _same_array(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, what
    assert a.tobytes() == b.tobytes(), what


def _jmesh():
    return make_mesh(jax.devices()[:1], shape=(1, 1))


def _max_semirings():
    """(port, JAX) max-select semirings: the ⊕ kinds both pipelines take
    beyond the apps' sum and min."""
    port = tsr.Semiring(name="max_select", add=torch.maximum,
                        mul=lambda x, w: x, identity=NEG_INF,
                        reduce_kind="max")
    jax_side = jsr.Semiring(name="max_select", add=jnp.maximum,
                            mul=lambda x, w: x, identity=NEG_INF,
                            reduce_kind="max")
    return port, jax_side


# --------------------------------------------------------- (a) the plans
@pytest.mark.parametrize("case", ["unweighted_f32", "weighted_int32"])
def test_spmv2_meta_matches_jax(case):
    if case == "weighted_int32":
        r, c, w = rmat_edges(10, 16, seed=1, weighted=True)
        cfg, jcfg, dtype = sssp_config(N), jsssp.sssp_config(N), np.int32
    else:
        r, c, w = rmat_edges(10, 16, seed=1)
        cfg = GraphConfig(num_vertices=N, transpose=True)
        jcfg = JGraphConfig(num_vertices=N, transpose=True)
        dtype = np.float32
    meta = build_spmv2_meta(Graph.from_edges(r, c, w, cfg).tiled(),
                            value_dtype=dtype)
    jmeta = j_build_spmv2_meta(
        JGraph.from_edges(r, c, w, jcfg, mesh=_jmesh()).tiled(JOrdering.ROW),
        value_dtype=dtype)
    for k in artifact_cache._SPMV2_SCALARS:
        assert getattr(meta, k) == getattr(jmeta, k), k
    assert sorted(meta.arrays) == sorted(jmeta.arrays)
    for k in meta.arrays:
        _same_array(meta.arrays[k], jmeta.arrays[k], k)
    assert meta.has_w == (w is not None)


# --------------------------------------- (b) K9 and K10 against Pallas
def _gather_case(pattern, rng, block_rows=SUB):
    """(source rows, src_of) of a random static gather, after
    tests/test_gather.py's cases."""
    if pattern == "identity":
        rows = 4 * block_rows
        return rows, np.arange(rows * LANES, dtype=np.int64)
    if pattern == "permutation":
        rows = 8 * SUB if block_rows == SUB else 2 * block_rows
        n = rows * LANES
        src_of = rng.permutation(n).astype(np.int64)
        src_of[rng.random(n) < 0.1] = -1          # holes
        if block_rows != SUB:                     # keep each step within
            src_of = np.where(                    # few source windows
                src_of >= 0, src_of % (2 * SUB * LANES), -1)
        return rows, src_of
    # duplicates and conflicts: every output reads one of two source rows
    if block_rows == SUB:
        n = 4 * SUB * LANES
        return SUB, rng.integers(0, 2 * LANES, size=n).astype(np.int64)
    # (a 64-row step shares one conflict key per (row, lane) over 64
    # rows: 8 source lanes keep it within 30 subops)
    n = block_rows * LANES
    return SUB, (rng.integers(0, 2, n) * LANES
                 + rng.integers(0, 8, n) * 16).astype(np.int64)


def _stray(plan):
    """Point one slot of the first step with nact < 30 at subop 30: the
    Pallas grid never writes it, so it keeps the fill (then ⊗ w)."""
    meta = plan.meta.copy()
    i = int(np.flatnonzero(plan.nact < 30)[0])
    meta[i, 0, 0] = (30 << 3) | 1
    return meta


@pytest.mark.parametrize("pattern", ["identity", "permutation", "dup"])
@pytest.mark.parametrize("kind", ["f32_none", "f32_mul", "i32_add_sat"])
def test_plain_windowed_gather_matches_pallas(pattern, kind):
    rng = np.random.default_rng({"identity": 0, "permutation": 1,
                                 "dup": 2}[pattern])
    src_rows, src_of = _gather_case(pattern, rng)
    out_rows = src_of.size // LANES
    plan = build_gather_plan(src_rows, out_rows, src_of)
    if pattern == "dup":
        assert plan.nsub >= 2                      # conflict layers exist
    meta = _stray(plan)
    nsteps = out_rows // SUB
    if kind.startswith("f32"):
        fill = 0.0
        src = rng.random((src_rows, LANES)).astype(np.float32)
        w = (rng.random((nsteps, SUB, LANES)) - 0.5).astype(np.float32)
    else:
        fill = INF
        src = rng.integers(0, 1 << 20, (src_rows, LANES)).astype(np.int32)
        src[rng.random(src.shape) < 0.3] = INF
        w = rng.integers(1, 100, (nsteps, SUB, LANES)).astype(np.int32)
    mul = kind.split("_", 1)[1]
    if mul == "none":
        w = None
    want = np.asarray(jgk.windowed_gather(
        jnp.asarray(src), jnp.asarray(plan.wsel), jnp.asarray(plan.base),
        jnp.asarray(plan.nact), jnp.asarray(plan.cidx), jnp.asarray(meta),
        None if w is None else jnp.asarray(w), fill, out_rows, plan.nsub,
        mul_kind=mul, interpret=True))
    got = gk.windowed_gather(_t(src), _t(plan.wsel), _t(plan.base),
                             _t(plan.nact), _t(plan.cidx), _t(meta),
                             None if w is None else _t(w), fill, plan.nsub,
                             mul)
    assert got.dtype == torch.from_numpy(src).dtype
    np.testing.assert_array_equal(got.numpy(), want)
    # the stray slot holds the fill (⊗ w under mul): nothing was gathered
    i = int(np.flatnonzero(plan.nact < 30)[0])
    if mul == "none":
        assert got[i * SUB, 0] == fill
    # and the gather index is the plan's own src_of where the meta is
    idx = gk.gather_index(_t(plan.wsel), _t(plan.base), _t(plan.nact),
                          _t(plan.cidx), _t(plan.meta), plan.nsub)
    np.testing.assert_array_equal(idx.numpy().reshape(-1), plan.src_of)


@pytest.mark.parametrize("pattern", ["identity", "permutation", "dup"])
def test_plain_windowed_gather64_matches_pallas(pattern):
    rng = np.random.default_rng({"identity": 3, "permutation": 4,
                                 "dup": 5}[pattern])
    src_rows, src_of = _gather_case(pattern, rng, block_rows=gk.BLK64)
    out_rows = gk.seg_round_rows64(src_of.size // LANES)
    src_of = np.concatenate(
        [src_of, np.full(out_rows * LANES - src_of.size, -1, np.int64)])
    plan = build_gather_plan(src_rows, out_rows, src_of,
                             block_rows=gk.BLK64)
    src = rng.random((src_rows, LANES))
    want = np.asarray(jgk.windowed_gather64(
        jnp.asarray(src), jnp.asarray(plan.wsel), jnp.asarray(plan.base),
        jnp.asarray(plan.nact), jnp.asarray(plan.cidx),
        jnp.asarray(plan.meta), -1.0, out_rows, plan.nsub, interpret=True))
    got = gk.windowed_gather64(_t(src), _t(plan.wsel), _t(plan.base),
                               _t(plan.nact), _t(plan.cidx), _t(plan.meta),
                               -1.0, plan.nsub)
    np.testing.assert_array_equal(got.numpy(), want)
    valid = src_of >= 0
    np.testing.assert_array_equal(got.numpy().reshape(-1)[valid],
                                  src.reshape(-1)[src_of[valid]])


def test_seg_round_rows_match_jax():
    for rows in (0, 8, 16376, 16384, 16392, 40000 * 8):
        assert gk.seg_round_rows(rows) == jgk.seg_round_rows(rows)
    for rows in (1, 64, 65, 65536, 65600, 10 ** 6):
        assert gk.seg_round_rows64(rows) == jgk.seg_round_rows64(rows)


# ------------------------------------------ (c) spmv2_local against JAX
def _pr_config(jax_side=False):
    cls = JGraphConfig if jax_side else GraphConfig
    return cls(num_vertices=N, transpose=True)


# case -> (weighted edges, (port config, JAX config), dtype, semiring)
_SPMV_CASES = {
    "sum_f64": (False, (_pr_config, lambda: _pr_config(True)), np.float64,
                "plus_times"),
    "min_int32_weighted": (True, (lambda: sssp_config(N),
                                  lambda: jsssp.sssp_config(N)),
                           np.int32, "min_plus"),
    "min_int32": (False, (lambda: bfs_config(N), lambda: jbfs.bfs_config(N)),
                  np.int32, "min_select"),
    "max_int32": (False, (lambda: bfs_config(N), lambda: jbfs.bfs_config(N)),
                  np.int32, "max"),
}


@pytest.mark.parametrize("case", sorted(_SPMV_CASES))
def test_spmv2_local_matches_jax(case):
    weighted, (cfg, jcfg), dtype, sem_name = _SPMV_CASES[case]
    r, c, w = rmat_edges(10, 16, seed=1, weighted=weighted)
    g = Graph.from_edges(r, c, w, cfg())
    jg = JGraph.from_edges(r, c, w, jcfg(), mesh=_jmesh())
    meta = build_spmv2_meta(g.tiled(), value_dtype=dtype)
    jmeta = j_build_spmv2_meta(jg.tiled(JOrdering.ROW), value_dtype=dtype)
    rng = np.random.default_rng(7)
    nc = g.part.tile_cols
    if sem_name == "max":
        sem, jsem = _max_semirings()
        x = rng.integers(-1000, 1000, nc).astype(np.int32)
        x[rng.random(nc) < 0.3] = NEG_INF
    elif dtype == np.int32:
        sem, jsem = getattr(tsr, sem_name)(), getattr(jsr, sem_name)()
        x = rng.integers(0, 1000, nc).astype(np.int32)
        x[rng.random(nc) < 0.3] = INF
    else:
        sem, jsem = getattr(tsr, sem_name)(), getattr(jsr, sem_name)()
        x = rng.random(nc)
    st = spmv2_stages(_t(x), meta_from_numpy(meta.arrays, "cpu"), meta, sem,
                      g.part.tile_rows)
    assert [k for k in STAGES if k in st] == list(STAGES)
    got = st["y"].numpy()
    want = np.asarray(j_spmv2_local(
        jnp.asarray(x), {k: jnp.asarray(v[0]) for k, v in
                         jmeta.arrays.items()},
        jmeta, jsem, g.part.tile_rows, interpret=True))
    if dtype == np.int32:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)


# ---------------------------------------- (d) the apps through shuffle2
@pytest.fixture(scope="module")
def pr_graph():
    r, c, _ = rmat_edges(10, 16, seed=1)
    return r, c, Graph.from_edges(r, c, None, GraphConfig(num_vertices=N,
                                                          transpose=True))


def test_pagerank_shuffle2_matches_golden_and_jax(pr_graph):
    r, c, g = pr_graph
    ex = run_pagerank(g, ITERS, torch.float64, kernel="shuffle2",
                      device="cpu")
    assert isinstance(ex.meta, Spmv2Meta) and ex.device_bytes > 0
    assert ex.degree_phase.kernel == "shuffle"
    np.testing.assert_allclose(ex.state_vector()["rank"],
                               golden.pagerank(r, c, N + 1, ITERS),
                               rtol=1e-10, atol=0)
    jg = JGraph.from_edges(r, c, None, _pr_config(True), mesh=_jmesh())
    # the JAX shuffle2 executor (interpret mode) over fewer iterations, to
    # keep its CPU time down
    jex = j_run_pagerank(jg, JAX_ITERS, jnp.float64, kernel="shuffle2")
    mine = run_pagerank(g, JAX_ITERS, torch.float64, kernel="shuffle2",
                        device="cpu")
    np.testing.assert_allclose(mine.state_vector()["rank"],
                               np.asarray(jex.state_vector()["rank"]),
                               rtol=1e-10, atol=0)


@pytest.mark.parametrize("kernel", ["shuffle2", "segment"])
@pytest.mark.parametrize("app", ["bfs", "cc", "sssp"])
def test_apps_match_golden(app, kernel):
    if app == "sssp":
        r, c, w = rmat_edges(10, 16, seed=1, weighted=True)
        ex = run_sssp(Graph.from_edges(r, c, w, sssp_config(N)), 0,
                      kernel=kernel, device="cpu")
        want = {"distance": golden.sssp(r, c, w.astype(np.int64), N + 1, 0)}
    else:
        r, c, _ = rmat_edges(10, 16, seed=1)
        if app == "bfs":
            ex = run_bfs(Graph.from_edges(r, c, None, bfs_config(N)), 0,
                         kernel=kernel, device="cpu")
            parent, hops = golden.bfs(r, c, N + 1, 0)
            want = {"parent": parent, "hops": hops}
        else:
            ex = run_cc(Graph.from_edges(r, c, None, cc_config(N)),
                        kernel=kernel, device="cpu")
            want = {"label": golden.cc(r, c, N + 1)}
    sv = ex.state_vector()
    for k, v in want.items():
        np.testing.assert_array_equal(sv[k], v, err_msg=k)
    assert ex.iteration == len(ex.supersteps) > 1
    assert all(s["gated"] is None for s in ex.supersteps)
    if app == "bfs":
        assert ex.checksum() == (1304.0, 886)


def test_pagerank_segment_matches_golden(pr_graph):
    r, c, g = pr_graph
    ex = run_pagerank(g, ITERS, torch.float64, kernel="segment",
                      degree_kernel="segment", device="cpu")
    np.testing.assert_array_equal(ex.degree_phase.state_vector()["degree"],
                                  golden.degree(r, c, N + 1).astype(
                                      np.float64))
    np.testing.assert_allclose(ex.state_vector()["rank"],
                               golden.pagerank(r, c, N + 1, ITERS),
                               rtol=1e-10, atol=0)


# ------------------------------------------------ (e) input checks
@pytest.fixture(scope="module")
def small():
    r, c, _ = rmat_edges(8, 16, seed=1)
    g = Graph.from_edges(r, c, None, GraphConfig(num_vertices=256,
                                                 transpose=True))
    meta = build_spmv2_meta(g.tiled(), np.float32)
    t = meta_from_numpy(meta.arrays, "cpu")
    st = spmv2_stages(torch.rand(g.part.tile_cols), t, meta,
                      tsr.plus_times(), g.part.tile_rows)
    return g, meta, t, st


def test_wrappers_reject_bad_inputs(small):
    _, meta, t, st = small
    x2d = st["x2d"]
    wsel, base, nact, cidx, m = (t[f"exp_{a}"] for a in
                                 ("wsel", "base", "nact", "cidx", "meta"))
    nsub = meta.nsub["exp"]
    ok = (wsel, base, nact, cidx, m)
    with pytest.raises(ValueError, match="src"):
        gk.windowed_gather(x2d.view(-1), *ok, None, 0.0, nsub)
    with pytest.raises(ValueError, match="src"):
        gk.windowed_gather(x2d[:-1], *ok, None, 0.0, nsub)
    with pytest.raises(TypeError, match="dtype"):
        gk.windowed_gather(x2d.half(), *ok, None, 0.0, nsub)
    with pytest.raises(TypeError, match="cidx"):
        gk.windowed_gather(x2d, wsel, base, nact, cidx.to(torch.uint8), m,
                           None, 0.0, nsub)
    with pytest.raises(TypeError, match="meta"):
        gk.windowed_gather(x2d, wsel, base, nact, cidx, m.to(torch.int8),
                           None, 0.0, nsub)
    with pytest.raises(ValueError, match="wsel"):
        gk.windowed_gather(x2d, *ok, None, 0.0, nsub + 1)
    with pytest.raises(ValueError, match="nsub"):
        gk.windowed_gather(x2d, wsel, base, nact, cidx, m, None, 0.0, 0)
    with pytest.raises(ValueError, match="mul_kind"):
        gk.windowed_gather(x2d, *ok, None, 0.0, nsub, "mul")
    with pytest.raises(ValueError, match="mul_kind"):
        gk.windowed_gather(x2d, *ok, torch.ones(m.shape), 0.0, nsub, "none")
    with pytest.raises(ValueError, match="contiguous"):
        gk.windowed_gather(x2d, wsel, base, nact, cidx,
                           m.transpose(1, 2).contiguous().transpose(1, 2),
                           None, 0.0, nsub)
    with pytest.raises(ValueError, match="meta"):
        gk.windowed_gather64(x2d, *ok, 0.0, nsub)          # 8-row meta
    with pytest.raises(ValueError, match="meta"):          # 16-row steps
        gk.windowed_gather(x2d, wsel, base, nact, cidx,
                           m[:m.shape[0] // 2 * 2].reshape(-1, 16, 128),
                           None, 0.0, nsub)
    # no launch was counted: the CPU runs the plain versions
    before = dict(gk.LAUNCHES)
    gk.windowed_gather(x2d, *ok, None, 0.0, nsub)
    assert gk.LAUNCHES == before


def _bad(meta, key, edit):
    arrays = dict(meta.arrays)
    arrays[key] = arrays[key].copy()
    edit(arrays[key][0])
    return types.SimpleNamespace(**{**meta.__dict__, "arrays": arrays})


def _first_active(meta, k):
    return int(np.flatnonzero(meta.arrays[f"{k}_nact"][0] > 0)[0])


@pytest.mark.parametrize("key,edit,match", [
    ("exp_wsel", lambda a: a.__setitem__(0, 10 ** 6), "exp_wsel"),
    ("p0_wsel", lambda a: a.__setitem__(0, -1), "p0_wsel"),
    ("mx_base", lambda a: a.__setitem__(-1, 10 ** 6), "mx_base"),
    ("p1_nact", lambda a: a.__setitem__(0, 99), "p1_nact"),
    ("p2_cidx", lambda a: a.__setitem__((0, 0, 0), -3), "p2_cidx"),
    ("chunk_block", lambda a: a.__setitem__(0, 10 ** 6), "chunk_block"),
    ("lr", lambda a: a.__setitem__((0, 0), -1), "lr"),
])
def test_validate_rejects_out_of_range(small, key, edit, match):
    meta = small[1]
    validate_spmv2_meta(meta)
    if key.endswith("_wsel"):               # an active subop's window
        k = key[:-5]
        i = _first_active(meta, k)
        v = edit
        edit = lambda a: v(a[i * meta.nsub[k]:])   # noqa: E731
    if key == "mx_base":                    # an active step's blocks
        i = _first_active(meta, "mx")
        edit = lambda a: a.__setitem__(i, 10 ** 6)  # noqa: E731
    with pytest.raises(ValueError, match=match):
        validate_spmv2_meta(_bad(meta, key, edit))


def test_pad_steps_validate_and_compute_nothing(small, monkeypatch):
    """With the segment rounding forced to 4 steps, every stage gains pad
    steps (nact 0, all-invalid meta, base at the total): the plans
    validate and the SpMV is unchanged."""
    g, meta, t, _ = small
    monkeypatch.setattr(gk, "SEG_STEPS", 4)
    padded = build_spmv2_meta(g.tiled(), np.float32)      # validates
    grew = [k for k in STAGES if padded.out_rows[k] > meta.out_rows[k]]
    assert grew
    for k in grew:
        assert (padded.arrays[f"{k}_nact"][0] == 0).any()
    x = torch.rand(g.part.tile_cols)
    sem = tsr.plus_times()
    want = spmv2_local(x, t, meta, sem, g.part.tile_rows)
    got = spmv2_local(x, meta_from_numpy(padded.arrays, "cpu"), padded, sem,
                      g.part.tile_rows)
    assert torch.equal(got, want)


def test_executor_shuffle2_plans_type_and_reuse(small):
    g, meta, _, _ = small
    with pytest.raises(TypeError, match="Spmv2Meta"):
        Executor(g, PageRankProgram(torch.float32), kernel="shuffle2",
                 plans=build_shuffle_plans(g.tiled(), np.float32),
                 device="cpu")
    ex = Executor(g, PageRankProgram(torch.float32), kernel="shuffle2",
                  plans=meta, device="cpu")
    assert ex.meta is meta
    with pytest.raises(ValueError, match="unknown kernel"):
        Executor(g, PageRankProgram(torch.float32), kernel="shuffle3",
                 device="cpu")


def test_artifact_cache_spmv2_roundtrip_and_key(tmp_path, small):
    g, _, _, _ = small
    cfg, ts = g.config, g.tiled()
    m1 = artifact_cache.cached_spmv2_meta(ts, 8, 16, 1, cfg, Ordering.ROW,
                                          np.float32, cache_dir=tmp_path)
    files = list(tmp_path.iterdir())
    assert len(files) == 1
    assert artifact_cache.source_hash("spmv2") in files[0].name
    m2 = artifact_cache.cached_spmv2_meta(ts, 8, 16, 1, cfg, Ordering.ROW,
                                          np.float32, cache_dir=tmp_path)
    for k in artifact_cache._SPMV2_SCALARS:
        assert getattr(m1, k) == getattr(m2, k), k
    assert m2.nsub == m1.nsub and set(m2.out_rows) == set(STAGES)
    for k in m1.arrays:
        _same_array(m1.arrays[k], m2.arrays[k], k)
    key = artifact_cache.meta_key(8, 16, 1, cfg, Ordering.ROW, np.float32,
                                  False, kind="spmv2")
    assert key not in {artifact_cache.meta_key(
        8, 16, 1, cfg, Ordering.ROW, np.float32, False, kind=kind)
        for kind in ("spmv3", "shuffle")}
    assert files[0].name == key + ".npz"
