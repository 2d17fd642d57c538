"""The port's v1 shuffle path on the CPU: its shuffle plans byte-identical
to the JAX package's; the plain K6-K8 against the Pallas kernels in
interpret mode; ``spmv_local`` against the JAX package's; and degree,
PageRank, BFS, CC and SSSP through ``Executor(kernel="shuffle")`` against
``tests/golden.py`` and the JAX shuffle executor. Inputs come from numpy
seeds and ``rmat_edges(10, 16, seed=1)``.

Tolerances: K6 and K7 move values without arithmetic (K6's ⊗ is the same
one operation) and match bit for bit; K8 and the whole SpMV match bit for
bit in int32 min and within rtol 1e-12 in f64 sums (1e-5 in f32), whose
order of addition differs from the Pallas kernel's chunk-by-chunk order.
K7 is compared at the lanes the plan writes: the Pallas output block is
never initialised, the port fills it with the ⊕-identity. K7's composed
index (``group_index``) equals the planner's own simulation
(``final_src``), and the one gather through it (``group_gather_plain``)
equals the pass-by-pass plain version bit for bit."""

import os
import sys
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from graphtap_tpu.apps import bfs as jbfs
from graphtap_tpu.apps import sssp as jsssp
from graphtap_tpu.apps.pagerank import run_pagerank as j_run_pagerank
from graphtap_tpu.config import GraphConfig as JGraphConfig
from graphtap_tpu.config import Ordering as JOrdering
from graphtap_tpu.ingest.graph import Graph as JGraph
from graphtap_tpu.kernels import semiring as jsr
from graphtap_tpu.kernels import shuffle_kernels as jk
from graphtap_tpu.kernels.shuffle_engine import \
    build_shuffle_plans as j_build_shuffle_plans
from graphtap_tpu.kernels.shuffle_engine import spmv_local as j_spmv_local
from graphtap_tpu.kernels.shuffle_plan import build_spmv_plan
from graphtap_tpu.parallel.layout import make_mesh

from graphtap_tpu_torch import EngineConfig, Graph, GraphConfig, Ordering
from graphtap_tpu_torch.apps import (DegreeProgram, PageRankProgram,
                                     bfs_config, cc_config, run_bfs, run_cc,
                                     run_pagerank, run_sssp, sssp_config)
from graphtap_tpu_torch.engine.executor import Executor
from graphtap_tpu_torch.ingest import rmat_edges
from graphtap_tpu_torch.kernels import semiring as tsr
from graphtap_tpu_torch.kernels import shuffle_kernels as sk
from graphtap_tpu_torch.kernels.panel_meta import build_spmv3_meta
from graphtap_tpu_torch.kernels.shuffle_engine import (
    ShufflePlans, build_shuffle_plans, spmv_local, spmv_stages,
    validate_shuffle_plans)
from graphtap_tpu_torch.kernels.shuffle_plan import LANES, WROWS
from graphtap_tpu_torch.tools import artifact_cache
from graphtap_tpu_torch.tools.convert import meta_from_numpy

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import golden  # noqa: E402

INF = tsr.INF_I32
N = 1024
ITERS = 20
JAX_ITERS = 5
SUM_RTOL = {np.float32: 1e-5, np.float64: 1e-12}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _same_array(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, what
    assert a.tobytes() == b.tobytes(), what


# --------------------------------------------------------- (a) the plans
def _random_weighted(n=2048, e=30000, seed=4):
    rng = np.random.default_rng(seed)
    r = rng.integers(0, n, size=e).astype(np.int64)
    c = rng.integers(0, n, size=e).astype(np.int64)
    hub = rng.random(e) < 0.2
    c[hub] = rng.integers(0, 16, size=int(hub.sum()))
    w = rng.integers(1, 129, size=e).astype(np.int32)
    return r, c, w, n


@pytest.mark.parametrize("case", ["weighted_int32", "unweighted_f32"])
def test_shuffle_plans_match_jax(case):
    if case == "weighted_int32":
        r, c, w, n = _random_weighted()
        cfg = dict(num_vertices=n, directed=True, transpose=False,
                   parallel_edges=False)
        dtype = np.int32
    else:
        r, c, w = rmat_edges(10, 16, seed=1)
        n, cfg, dtype = N, dict(num_vertices=N, transpose=True), np.float32
    ts = Graph.from_edges(r, c, w, GraphConfig(**cfg)).tiled()
    jg = JGraph.from_edges(r, c, w, JGraphConfig(**cfg),
                           mesh=make_mesh(jax.devices()[:1], shape=(1, 1)))
    jts = jg.tiled(JOrdering.ROW)
    plans = build_shuffle_plans(ts, value_dtype=dtype)
    jplans = j_build_shuffle_plans(jts, value_dtype=dtype)
    for k in artifact_cache._SHUFFLE_SCALARS:
        assert getattr(plans, k) == getattr(jplans, k), k
    assert sorted(plans.arrays) == sorted(jplans.arrays)
    for k in plans.arrays:
        _same_array(plans.arrays[k], jplans.arrays[k], k)
    assert plans.has_w == (w is not None)


# ------------------------------------------------ (b) K6-K8 against Pallas
def _case(name):
    """(rows, cols, w, x, NR, NC, reduce kind, identity, mul kind, plan
    kwargs), after tests/test_shuffle.py's cases."""
    rng = np.random.default_rng({"sum_w": 1, "sum": 1, "min": 2, "hub": 3,
                                 "add_sat": 5, "passes": 6}[name])
    if name in ("sum_w", "sum"):
        NR, NC, E = 1000, 2000, 60000
        dtype = np.float64 if name == "sum_w" else np.float32
        rows = rng.integers(0, NR, E)
        cols = rng.integers(0, NC, E)
        w = rng.integers(1, 100, E).astype(dtype) if name == "sum_w" \
            else None
        x = rng.random(NC).astype(dtype)
        kw = dict(nwin=4, rows_per_super=128, value_dtype=dtype)
        return rows, cols, w, x, NR, NC, "sum", 0.0, \
            "mul" if w is not None else "none", kw
    if name in ("min", "add_sat"):
        NR, NC, E = 600, 900, 4000
        rows = rng.integers(0, NR, E)
        cols = rng.integers(0, NC, E)
        x = rng.integers(0, 10000, NC).astype(np.int32)
        x[rng.random(NC) < 0.3] = INF
        w = rng.integers(1, 100, E).astype(np.int32) \
            if name == "add_sat" else None
        kw = dict(nwin=4, rows_per_super=256, value_dtype=np.int32)
        return rows, cols, w, x, NR, NC, "min", INF, \
            "add_sat" if w is not None else "none", kw
    if name == "hub":
        NR, NC = 2000, 500
        rows = np.concatenate([rng.integers(0, 50, 3000),
                               rng.integers(1900, 2000, 500)])
        cols = np.concatenate([np.full(3000, 7), rng.integers(0, NC, 500)])
        x = rng.random(NC).astype(np.float32)
        kw = dict(nwin=4, rows_per_super=256)
        return rows, cols, None, x, NR, NC, "sum", 0.0, "none", kw
    # many row blocks per super: two radix passes
    NR, NC, E = 8000, 3000, 30000
    rows = rng.integers(0, NR, E)
    cols = rng.integers(0, NC, E)
    x = rng.random(NC)
    kw = dict(nwin=4, rows_per_super=512, value_dtype=np.float64)
    return rows, cols, None, x, NR, NC, "sum", 0.0, "none", kw


@pytest.mark.parametrize("name", ["sum_w", "sum", "min", "hub", "add_sat",
                                  "passes"])
def test_plain_kernels_match_pallas(name):
    rows, cols, w, x, NR, NC, kind, ident, mul, kw = _case(name)
    plan = build_spmv_plan(rows.astype(np.int64), cols.astype(np.int64), w,
                           NR, NC, **kw)
    if name == "passes":
        assert plan.npasses >= 2
    win = WROWS * LANES
    sx3 = -(-NC // win)
    x3d = np.full(sx3 * win, ident, dtype=x.dtype)
    x3d[:NC] = x
    x3d = x3d.reshape(sx3, WROWS, LANES)
    ws = plan.w_stream
    # K6
    jc = jk.expand_stream(jnp.asarray(x3d), jnp.asarray(plan.grp),
                          jnp.asarray(plan.slot), jnp.asarray(plan.lane),
                          jnp.asarray(plan.ev_x),
                          None if ws is None else jnp.asarray(ws), ident,
                          mul_kind=mul, interpret=True)
    tc = sk.expand_stream(_t(x3d), _t(plan.grp), _t(plan.slot),
                          _t(plan.lane), _t(plan.ev_x),
                          None if ws is None else _t(ws), ident, mul)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    # K7, at the lanes the last pass writes (the reduce plan's ev_r)
    jg = jk.group_stream(jc, jnp.asarray(plan.frag_dst),
                         jnp.asarray(plan.frag_idx), plan.rows_per_super,
                         plan.npasses, interpret=True)
    tg = sk.group_stream(tc, _t(plan.frag_dst), _t(plan.frag_idx),
                         plan.rows_per_super, plan.npasses, ident)
    written = plan.ev_r != 0
    np.testing.assert_array_equal(tg.numpy()[written],
                                  np.asarray(jg)[written])
    # the port's holes hold the identity
    assert np.all(tg.numpy()[~written] == ident)
    # the passes as one gather through their composed index
    src = sk.group_index(_t(plan.frag_dst), _t(plan.frag_idx),
                         plan.rows_per_super, plan.npasses)
    _same_array(sk.group_gather_plain(tc, src, ident).numpy(), tg.numpy(),
                "group_gather_plain")
    # K8
    jy = np.asarray(jk.grouped_reduce(
        jg, jnp.asarray(plan.lr), jnp.asarray(plan.ev_r),
        jnp.asarray(plan.chunk_block), plan.nblocks, kind, ident,
        interpret=True))
    ty = sk.grouped_reduce(tg, _t(plan.lr), _t(plan.ev_r),
                           _t(plan.chunk_block), plan.nblocks, kind,
                           ident).numpy()
    if kind == "sum":
        np.testing.assert_allclose(ty, jy, rtol=SUM_RTOL[x.dtype.type],
                                   atol=0)
    else:
        np.testing.assert_array_equal(ty, jy)
    # and the chain against a numpy SpMV
    if kind == "sum":
        want = np.zeros(NR)
        np.add.at(want, rows, x[cols] * (1 if w is None else w))
        np.testing.assert_allclose(ty.reshape(-1)[:NR], want,
                                   rtol=SUM_RTOL[x.dtype.type] * 10)


# ------------------------------------- (b2) K7 as one composed gather
def _group_plan(name):
    """A seeded plan of ``_case(name)``; "passes3": the "passes" graph
    with three radix passes forced, as many as the RMAT-20 degree plan
    has."""
    rows, cols, w, _, NR, NC, _, _, _, kw = _case(
        "passes" if name == "passes3" else name)
    if name == "passes3":
        kw = dict(kw, force_npasses=3)
    return build_spmv_plan(rows.astype(np.int64), cols.astype(np.int64), w,
                           NR, NC, **kw)


# dtype -> a contribution stream of that dtype and its fill
_GROUP_STREAMS = {
    "f32": lambda rng, n: (rng.random(n).astype(np.float32), 0.0),
    "f64": lambda rng, n: (rng.random(n), 0.0),
    "i32": lambda rng, n: (rng.integers(0, 10000, n).astype(np.int32), INF),
}


@pytest.mark.parametrize("name", ["sum_w", "sum", "min", "hub", "add_sat",
                                  "passes", "passes3"])
def test_group_index_matches_final_src(name):
    """group_index equals the planner's final_src (int32, -1 at holes);
    the gather through it equals the pass-by-pass plain version bit for
    bit in f32, f64 and i32, and the CPU wrapper gives the same with and
    without ``src``."""
    plan = _group_plan(name)
    if name == "passes3":
        assert plan.npasses == 3
    fd, fi = _t(plan.frag_dst), _t(plan.frag_idx)
    src = sk.group_index(fd, fi, plan.rows_per_super, plan.npasses)
    assert src.dtype == torch.int32
    assert tuple(src.shape) == (plan.nsupers * plan.rows_per_super, LANES)
    np.testing.assert_array_equal(src.view(-1).numpy(), plan.final_src)
    assert bool((src.view(-1)[torch.from_numpy(plan.final_src < 0)]
                 == -1).all())
    rng = np.random.default_rng(11)
    for dt, make in _GROUP_STREAMS.items():
        vals, fill = make(rng, src.numel())
        c = _t(vals).view(src.shape)
        want = sk.group_stream_plain(c, fd, fi, plan.rows_per_super,
                                     plan.npasses, fill)
        _same_array(sk.group_gather_plain(c, src, fill).numpy(),
                    want.numpy(), dt)
        for kw in ({}, {"src": src}):
            _same_array(sk.group_stream(c, fd, fi, plan.rows_per_super,
                                        plan.npasses, fill, **kw).numpy(),
                        want.numpy(), f"{dt} wrapper {sorted(kw)}")


def test_group_gather_matches_pallas_three_passes():
    """The composed gather against the Pallas group_stream (interpret
    mode) over three radix passes, at the lanes the plan writes."""
    plan = _group_plan("passes3")
    rng = np.random.default_rng(12)
    c = rng.random((plan.nsupers * plan.rows_per_super, LANES))
    jg = np.asarray(jk.group_stream(
        jnp.asarray(c), jnp.asarray(plan.frag_dst),
        jnp.asarray(plan.frag_idx), plan.rows_per_super, plan.npasses,
        interpret=True))
    src = sk.group_index(_t(plan.frag_dst), _t(plan.frag_idx),
                         plan.rows_per_super, plan.npasses)
    got = sk.group_gather_plain(_t(c), src, 0.0).numpy()
    written = plan.ev_r != 0
    assert written.any()
    np.testing.assert_array_equal(got[written], jg[written])
    assert np.all(got[~written] == 0.0)


def test_group_index_raises_past_int32(monkeypatch):
    """A stream of INDEX_LIMIT slots or more raises instead of wrapping
    (the limit lowered here to this plan's stream)."""
    plan = _group_plan("sum")
    n = plan.nsupers * plan.rows_per_super * LANES
    args = (_t(plan.frag_dst), _t(plan.frag_idx), plan.rows_per_super,
            plan.npasses)
    monkeypatch.setattr(sk, "INDEX_LIMIT", n + 1)
    assert sk.group_index(*args).numel() == n
    monkeypatch.setattr(sk, "INDEX_LIMIT", n)
    with pytest.raises(ValueError, match="int32"):
        sk.group_index(*args)


# ------------------------------------------- (c) spmv_local against JAX
def _pr_config(jax_side=False):
    cls = JGraphConfig if jax_side else GraphConfig
    return cls(num_vertices=N, transpose=True)


# case -> (weighted edges, (port config, JAX config), dtype, semiring)
_SPMV_CASES = {
    "pagerank_f64": (False, (_pr_config, lambda: _pr_config(True)),
                     np.float64, "plus_times"),
    "sssp_int32": (True, (lambda: sssp_config(N),
                          lambda: jsssp.sssp_config(N)),
                   np.int32, "min_plus"),
    "bfs_int32": (False, (lambda: bfs_config(N), lambda: jbfs.bfs_config(N)),
                  np.int32, "min_select"),
}


@pytest.mark.parametrize("case", sorted(_SPMV_CASES))
def test_spmv_local_matches_jax(case):
    weighted, (cfg, jcfg), dtype, sem_name = _SPMV_CASES[case]
    r, c, w = rmat_edges(10, 16, seed=1, weighted=weighted)
    g = Graph.from_edges(r, c, w, cfg())
    jg = JGraph.from_edges(r, c, w, jcfg(),
                           mesh=make_mesh(jax.devices()[:1], shape=(1, 1)))
    plans = build_shuffle_plans(g.tiled(), value_dtype=dtype)
    jplans = j_build_shuffle_plans(jg.tiled(JOrdering.ROW),
                                   value_dtype=dtype)
    rng = np.random.default_rng(7)
    nc = g.part.tile_cols
    if dtype == np.int32:
        x = rng.integers(0, 1000, nc).astype(np.int32)
        x[rng.random(nc) < 0.3] = INF
    else:
        x = rng.random(nc)
    sem = getattr(tsr, sem_name)()
    got = spmv_local(_t(x), meta_from_numpy(plans.arrays, "cpu"), plans, sem,
                     g.part.tile_rows).numpy()
    want = np.asarray(j_spmv_local(
        jnp.asarray(x), {k: jnp.asarray(v[0]) for k, v in
                         jplans.arrays.items()},
        jplans, getattr(jsr, sem_name)(), g.part.tile_rows, interpret=True))
    if dtype == np.int32:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)


# ----------------------------------------- (d) the apps through shuffle
@pytest.fixture(scope="module")
def pr_graph():
    r, c, _ = rmat_edges(10, 16, seed=1)
    return r, c, Graph.from_edges(r, c, None, GraphConfig(num_vertices=N,
                                                          transpose=True))


def test_degree_shuffle_matches_golden(pr_graph):
    r, c, g = pr_graph
    ex = Executor(g, DegreeProgram(torch.float32),
                  EngineConfig(stationary=True, ordering=Ordering.COL),
                  kernel="shuffle", device="cpu")
    ex.execute(1)
    assert isinstance(ex.meta, ShufflePlans) and ex.device_bytes > 0
    assert [s["gated"] for s in ex.supersteps] == [None]
    np.testing.assert_array_equal(ex.state_vector()["degree"],
                                  golden.degree(r, c, N + 1).astype(
                                      np.float32))


def test_pagerank_shuffle_matches_golden_and_jax(pr_graph):
    r, c, g = pr_graph
    ex = run_pagerank(g, ITERS, torch.float64, kernel="shuffle",
                      device="cpu")
    assert ex.degree_phase.kernel == "shuffle"
    np.testing.assert_array_equal(
        ex.degree_phase.state_vector()["degree"],
        golden.degree(r, c, N + 1).astype(np.float64))
    rank = ex.state_vector()["rank"]
    np.testing.assert_allclose(rank, golden.pagerank(r, c, N + 1, ITERS),
                               rtol=1e-10, atol=0)
    jg = JGraph.from_edges(r, c, None,
                           JGraphConfig(num_vertices=N, transpose=True),
                           mesh=make_mesh(jax.devices()[:1], shape=(1, 1)))
    # the JAX shuffle executor (interpret mode) over fewer iterations, to
    # keep its CPU time down
    jex = j_run_pagerank(jg, JAX_ITERS, jnp.float64, kernel="shuffle")
    mine = run_pagerank(g, JAX_ITERS, torch.float64, kernel="shuffle",
                        device="cpu")
    np.testing.assert_allclose(mine.state_vector()["rank"],
                               np.asarray(jex.state_vector()["rank"]),
                               rtol=1e-12, atol=0)


@pytest.mark.parametrize("app", ["bfs", "cc", "sssp"])
def test_apps_shuffle_match_golden(app):
    if app == "sssp":
        r, c, w = rmat_edges(10, 16, seed=1, weighted=True)
        ex = run_sssp(Graph.from_edges(r, c, w, sssp_config(N)), 0,
                      kernel="shuffle", device="cpu")
        want = {"distance": golden.sssp(r, c, w.astype(np.int64), N + 1, 0)}
    else:
        r, c, _ = rmat_edges(10, 16, seed=1)
        if app == "bfs":
            ex = run_bfs(Graph.from_edges(r, c, None, bfs_config(N)), 0,
                         kernel="shuffle", device="cpu")
            parent, hops = golden.bfs(r, c, N + 1, 0)
            want = {"parent": parent, "hops": hops}
        else:
            ex = run_cc(Graph.from_edges(r, c, None, cc_config(N)),
                        kernel="shuffle", device="cpu")
            want = {"label": golden.cc(r, c, N + 1)}
    sv = ex.state_vector()
    for k, v in want.items():
        np.testing.assert_array_equal(sv[k], v, err_msg=k)
    assert ex.iteration == len(ex.supersteps) > 1
    assert all(s["gated"] is None for s in ex.supersteps)
    if app == "bfs":
        assert ex.checksum() == (1304.0, 886)


# ------------------------------------------------ (e) input checks
@pytest.fixture(scope="module")
def small():
    r, c, _ = rmat_edges(8, 16, seed=1)
    g = Graph.from_edges(r, c, None, GraphConfig(num_vertices=256,
                                                 transpose=True))
    plans = build_shuffle_plans(g.tiled(), np.float32)
    t = meta_from_numpy(plans.arrays, "cpu")
    st = spmv_stages(torch.rand(g.part.tile_cols), t, plans,
                     tsr.plus_times(), g.part.tile_rows)
    return g, plans, t, st


def test_wrappers_reject_bad_inputs(small):
    _, plans, t, st = small
    x3d, c = st["x3d"], st["contrib"]
    args = (t["grp"], t["slot"], t["lane"], t["ev_x"])
    with pytest.raises(ValueError, match="x3d"):
        sk.expand_stream(x3d.view(-1, LANES), *args, None, 0.0)
    with pytest.raises(TypeError, match="slot"):
        sk.expand_stream(x3d, t["grp"], t["slot"].int(), t["lane"],
                         t["ev_x"], None, 0.0)
    with pytest.raises(TypeError, match="grp"):
        sk.expand_stream(x3d, t["grp"].long(), *args[1:], None, 0.0)
    with pytest.raises(ValueError, match="mul_kind"):
        sk.expand_stream(x3d, *args, None, 0.0, "mul")
    with pytest.raises(ValueError, match="mul_kind"):
        sk.expand_stream(x3d, *args, torch.ones_like(c), 0.0, "none")
    with pytest.raises(TypeError, match="dtype"):
        sk.expand_stream(x3d.half(), *args, None, 0.0)
    with pytest.raises(ValueError, match="contiguous"):
        sk.expand_stream(x3d, t["grp"], t["slot"].t().contiguous().t(),
                         t["lane"], t["ev_x"], None, 0.0)
    with pytest.raises(ValueError, match="contrib"):
        sk.group_stream(c[:-8], t["frag_dst"], t["frag_idx"],
                        plans.rows_per_super, plans.npasses, 0.0)
    with pytest.raises(ValueError, match="rps"):
        sk.group_stream(c, t["frag_dst"], t["frag_idx"],
                        plans.rows_per_super * 2, plans.npasses, 0.0)
    with pytest.raises(TypeError, match="src"):
        sk.group_stream(c, t["frag_dst"], t["frag_idx"],
                        plans.rows_per_super, plans.npasses, 0.0,
                        src=torch.zeros(c.shape, dtype=torch.long))
    with pytest.raises(ValueError, match="grouped_reduce"):
        sk.grouped_reduce(c, t["lr"], t["ev_r"], t["chunk_block"],
                          plans.nblocks, "min", 0.0)
    with pytest.raises(TypeError, match="lr"):
        sk.grouped_reduce(c, t["lr"].int(), t["ev_r"], t["chunk_block"],
                          plans.nblocks, "sum", 0.0)
    # no launch was counted: the CPU runs the plain versions
    before = dict(sk.LAUNCHES)
    sk.grouped_reduce(c, t["lr"], t["ev_r"], t["chunk_block"],
                      plans.nblocks, "sum", 0.0)
    assert sk.LAUNCHES == before


def _bad(plans, key, edit):
    arrays = dict(plans.arrays)
    arrays[key] = arrays[key].copy()
    edit(arrays[key][0])
    return types.SimpleNamespace(**{**plans.__dict__, "arrays": arrays})


def test_grouped_reduce_rejects_lists_of_another_evalid(small):
    """K8's kept chunk list names the evalid it was built from
    (``reduce_tables``): a call with another evalid raises, on any
    device, rather than fold the other one's chunks."""
    _, plans, t, st = small
    t, c = dict(t), st["grouped"]
    folds = sk.reduce_tables(t, plans.nblocks, c.dtype)
    args = (t["lr"], t["ev_r"], t["chunk_block"], plans.nblocks, "sum", 0.0)
    sk.grouped_reduce(c, *args, **folds)
    other = t["ev_r"].clone()
    with pytest.raises(ValueError, match="another evalid"):
        sk.grouped_reduce(c, t["lr"], other, *args[2:], **folds)
    lists = sk.reduce_lists(t["chunk_block"], plans.nblocks, other)
    assert all(torch.equal(a, b) for a, b in zip(lists[:3], folds["lists"]))
    sk.grouped_reduce(c, t["lr"], other, *args[2:], lists=lists)
    with pytest.raises(ValueError, match="another evalid"):
        sk.grouped_reduce(c, *args, lists=lists[:3])


@pytest.mark.parametrize("key,edit,match", [
    ("grp", lambda a: a.__setitem__(0, 99), "grp"),
    ("mexp_grp_b", lambda a: a.__setitem__(-1, 99), "mexp_grp_b"),
    ("slot", lambda a: a.__setitem__((0, 0), 64), "slot"),
    ("lane", lambda a: a.__setitem__((0, 0), -3), "lane"),
    ("chunk_block", lambda a: a.__setitem__(0, 10 ** 6), "chunk_block"),
    ("frag_dst", lambda a: a.__setitem__((0, 0, 0, 0), 10 ** 6),
     "frag_dst"),
])
def test_validate_rejects_out_of_range(small, key, edit, match):
    plans = small[1]
    validate_shuffle_plans(plans)
    with pytest.raises(ValueError, match=match):
        validate_shuffle_plans(_bad(plans, key, edit))


def test_validate_rejects_double_write(small):
    """Two fragments of one super and pass landing on one (row, lane)
    would make K7's parallel scatter order-dependent."""
    plans = small[1]
    fd, fi = plans.arrays["frag_dst"][0], plans.arrays["frag_idx"][0]
    r0, j0 = map(int, np.argwhere(fd[0, 0] >= 0)[0])
    lanes = np.flatnonzero(fi[0, 0, r0, j0 * LANES:(j0 + 1) * LANES] >= 0)
    # find another fragment slot of the super's first pass, point it at the
    # same destination row and lane
    smax = fd.shape[-1]
    r1, j1 = next((r, j) for r in range(fd.shape[2]) for j in range(smax)
                  if (r, j) != (r0, j0))

    def edit(a_dst):
        a_dst[0, 0, r1, j1] = fd[0, 0, r0, j0]

    bad = _bad(plans, "frag_dst", edit)
    fi2 = fi.copy()
    fi2[0, 0, r1, j1 * LANES + lanes[0]] = 0
    bad.arrays["frag_idx"] = fi2[None]
    with pytest.raises(ValueError, match="twice"):
        validate_shuffle_plans(bad)


def test_executor_shuffle_plans_type_and_reuse(small):
    g, plans, _, _ = small
    with pytest.raises(TypeError, match="ShufflePlans"):
        Executor(g, PageRankProgram(torch.float32), kernel="shuffle",
                 plans=build_spmv3_meta(g.tiled(), np.float32),
                 device="cpu")
    ex = Executor(g, PageRankProgram(torch.float32), kernel="shuffle",
                  plans=plans, device="cpu")
    assert ex.meta is plans


def test_group_tables_kept_once_per_upload(small, monkeypatch):
    """group_tables builds K7's index once into the plan tensors, as the
    executor's upload keeps it (and counts it in device_bytes); an entry
    outside [-1, slots) raises."""
    g, plans, _, _ = small
    t = meta_from_numpy(plans.arrays, "cpu")
    a = sk.group_tables(t, plans)
    b = sk.group_tables(t, plans)
    assert a["src"] is b["src"] is t["group_src"]
    assert torch.equal(a["src"], sk.group_index(
        t["frag_dst"], t["frag_idx"], plans.rows_per_super, plans.npasses))
    ex = Executor(g, PageRankProgram(torch.float32), kernel="shuffle",
                  plans=plans, device="cpu")
    assert torch.equal(ex._dev["group_src"], a["src"])
    assert ex.device_bytes >= a["src"].numel() * 4
    bad = a["src"].clone()
    bad.view(-1)[0] = bad.numel()
    monkeypatch.setattr(sk, "group_index", lambda *args: bad)
    with pytest.raises(ValueError, match="outside"):
        sk.group_tables(meta_from_numpy(plans.arrays, "cpu"), plans)


def test_artifact_cache_shuffle_roundtrip_and_key(tmp_path, small):
    g, _, _, _ = small
    cfg, ts = g.config, g.tiled()
    m1 = artifact_cache.cached_shuffle_plans(ts, 8, 16, 1, cfg, Ordering.ROW,
                                             np.float32, cache_dir=tmp_path)
    files = list(tmp_path.iterdir())
    assert len(files) == 1
    assert artifact_cache.source_hash("shuffle") in files[0].name
    m2 = artifact_cache.cached_shuffle_plans(ts, 8, 16, 1, cfg, Ordering.ROW,
                                             np.float32, cache_dir=tmp_path)
    for k in artifact_cache._SHUFFLE_SCALARS:
        assert getattr(m1, k) == getattr(m2, k), k
    for k in m1.arrays:
        _same_array(m1.arrays[k], m2.arrays[k], k)
    key = artifact_cache.meta_key(8, 16, 1, cfg, Ordering.ROW, np.float32,
                                  False, kind="shuffle")
    assert key != artifact_cache.meta_key(8, 16, 1, cfg, Ordering.ROW,
                                          np.float32, False)
    assert files[0].name == key + ".npz"


def test_expand_figures_match_numpy(small):
    """``expand_figures`` (nothing but this test calls it; ROADMAP Queue E
    item 8) counts the RMAT-8 plan as numpy does: steps, slots, valid
    slots, windows, runs of one window and the share of all-invalid 4-slot
    groups."""
    _, plans, t, _ = small
    grp, ev = plans.arrays["grp"][0], plans.arrays["ev_x"][0]
    fig = sk.expand_figures(t["grp"], t["ev_x"])
    starts = np.flatnonzero(np.r_[True, grp[1:] != grp[:-1]])
    runs = np.diff(np.r_[starts, grp.size])
    assert fig["steps"] == grp.size and fig["slots"] == ev.size
    assert fig["valid"] == int(np.count_nonzero(ev))
    assert fig["windows"] == np.unique(grp).size
    assert fig["runs"] == runs.size
    assert fig["mean_run"] == pytest.approx(runs.mean())
    assert fig["median_run"] == float(np.sort(runs)[(runs.size - 1) // 2])
    assert fig["empty4"] == pytest.approx(
        float(np.mean(~(ev.reshape(-1, 4) != 0).any(1))))
