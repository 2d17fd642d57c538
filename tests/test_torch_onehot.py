"""The port's one-hot path on the CPU: its one-hot plan byte-identical to
the JAX package's; the plain K5 against the Pallas kernel in interpret
mode; the one-hot SpMV against the JAX executor's; and PageRank, BFS, CC
and SSSP through ``Executor(kernel="onehot")`` against ``tests/golden.py``
and the JAX onehot executor; K5 from the plan (the gather, ⊗ and padding
mask made in the fold) against the contributions built in torch and the
plain K5, bit for bit, in every value type, ⊕ and ⊗ (a last chunk of
padding among the cases), and its checks of its inputs. Inputs come from
numpy seeds and ``rmat_edges(10, 16, seed=1)``.

Tolerances: K5 matches bit for bit in int32 min and max; in float sums
within rtol 1e-5 (f32) elementwise, 1e-12 (f64), since only the order of
the additions differs (the Pallas kernel sums each 2048-slot chunk, then
adds the chunks in grid order)."""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from graphtap_tpu.apps import sssp as jsssp
from graphtap_tpu.apps.pagerank import run_pagerank as j_run_pagerank
from graphtap_tpu.config import GraphConfig as JGraphConfig
from graphtap_tpu.config import Ordering as JOrdering
from graphtap_tpu.format.tiles import build_tileset as j_build_tileset
from graphtap_tpu.ingest.graph import Graph as JGraph
from graphtap_tpu.kernels import pallas_spmv as jps
from graphtap_tpu.kernels import semiring as jsr
from graphtap_tpu.kernels.spmv import expand_compact as j_expand_compact
from graphtap_tpu.parallel.layout import make_mesh

from graphtap_tpu_torch import Graph, GraphConfig
from graphtap_tpu_torch.apps import (PageRankProgram, bfs_config, cc_config,
                                     run_bfs, run_cc, run_pagerank, run_sssp,
                                     sssp_config)
from graphtap_tpu_torch.engine.executor import Executor
from graphtap_tpu_torch.ingest import rmat_edges
from graphtap_tpu_torch.kernels import onehot_spmv as oh
from graphtap_tpu_torch.kernels import semiring as tsr
from graphtap_tpu_torch.kernels.shuffle_engine import mul_kind
from graphtap_tpu_torch.kernels.spmv import expand_compact
from graphtap_tpu_torch.tools import timing
from graphtap_tpu_torch.tools.convert import meta_from_numpy

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import golden  # noqa: E402
from onehot_cases import GATHER_CASES, gather_case  # noqa: E402

INF = tsr.INF_I32
NEG_INF = -INF - 1
N = 1024
ITERS = 20
JAX_ITERS = 3
SUM_RTOL = {np.float32: 1e-5, np.float64: 1e-12}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _jmesh():
    return make_mesh(jax.devices()[:1], shape=(1, 1))


def _semirings(name):
    """(port, JAX) semirings by name; 'max' is a max-select pair and
    'maxplus' a max-plus pair, neither naming its ⊗ (``mul_kind``)."""
    if name not in ("max", "maxplus"):
        return getattr(tsr, name)(), getattr(jsr, name)()
    if name == "max":
        def mul(x, w):
            return x
    else:
        def mul(x, w):
            return x if w is None else x + w
    return (tsr.Semiring(name=name, add=torch.maximum, mul=mul,
                         identity=NEG_INF, reduce_kind="max"),
            jsr.Semiring(name=name, add=jnp.maximum, mul=mul,
                         identity=NEG_INF, reduce_kind="max"))


def _graphs(weighted):
    r, c, w = rmat_edges(10, 16, seed=1, weighted=weighted)
    if weighted:
        cfg, jcfg = sssp_config(N), jsssp.sssp_config(N)
    else:
        cfg = GraphConfig(num_vertices=N, transpose=True)
        jcfg = JGraphConfig(num_vertices=N, transpose=True)
    return (Graph.from_edges(r, c, w, cfg),
            JGraph.from_edges(r, c, w, jcfg, mesh=_jmesh()))


# --------------------------------------------------------- (a) the plan
@pytest.mark.parametrize("weighted", [False, True])
def test_pallas_plan_matches_jax(weighted):
    g, jg = _graphs(weighted)
    ts, jts = g.tiled(), jg.tiled(JOrdering.ROW)
    plan = oh.build_onehot_plan(ts)
    jplan = jps.build_pallas_plan(jts.rows, jts.cols, jts.weights, jts.nnz,
                                  jts.NR)
    for k in ("Ep", "nblocks", "nchunks"):
        assert getattr(plan, k) == getattr(jplan, k), k
    for k in ("lrows", "cols", "weights", "evalid", "chunk_block"):
        a, b = getattr(plan, k), getattr(jplan, k)
        if b is None:
            assert a is None, k
            continue
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert a.tobytes() == b.tobytes(), k
    assert ("oh_w" in plan.arrays) == weighted
    assert plan.arrays["oh_evalid"].dtype == np.int8


# --------------------------------------------- (b) K5 against Pallas
@pytest.mark.parametrize("kind", ["sum", "min", "max"])
def test_plain_segment_reduce_matches_pallas(kind):
    rng = np.random.default_rng({"sum": 1, "min": 2, "max": 3}[kind])
    NR, E = 1000, 30000
    rows = np.sort(rng.integers(0, NR, E)).astype(np.int32)
    plan = oh.build_pallas_plan(rows[None], np.zeros((1, E), np.int32), None,
                                np.array([[E]], np.int32), NR)
    sem, jsem = _semirings({"sum": "plus_times", "min": "min_select",
                            "max": "max"}[kind])
    dtype = np.float32 if kind == "sum" else np.int32
    contrib = np.full(plan.Ep, sem.identity, dtype=dtype)
    ev = plan.evalid[0]
    contrib[ev] = (rng.random(E) if kind == "sum"
                   else rng.integers(-1000, 1000, E)).astype(dtype)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jps.pallas_segment_reduce(
            jnp.asarray(contrib), jnp.asarray(plan.lrows[0]),
            jnp.asarray(plan.chunk_block[0]), plan.nblocks, NR, jsem))
    got = oh.segment_reduce(_t(contrib), _t(plan.lrows[0]),
                            _t(plan.chunk_block[0]), plan.nblocks, NR, kind,
                            sem.identity).numpy()
    assert got.dtype == want.dtype and got.shape == (NR,)
    if kind == "sum":
        np.testing.assert_allclose(got, want, rtol=SUM_RTOL[np.float32],
                                   atol=0)
    else:
        np.testing.assert_array_equal(got, want)


# ------------------------------------- (c) the one-hot SpMV against JAX
@pytest.mark.parametrize("case", ["sum_f64", "sum_f64_weighted",
                                  "min_int32_weighted", "max_int32",
                                  "max_int32_weighted",
                                  "maxplus_int32_weighted"])
def test_spmv_onehot_matches_jax(case):
    """The port's one-hot SpMV (gather, ⊗, mask, K5, expand) against the
    JAX onehot executor's combine (executor.py:203-221) on the same plan
    arrays; on weighted plans too where the semiring's ⊗ is its own
    (max-select and max-plus, which K5 from the plan does not apply)."""
    weighted = "weighted" in case
    g, jg = _graphs(weighted and not case.startswith("sum"))
    if case == "sum_f64_weighted":        # PR config with float weights
        r, c, _ = rmat_edges(10, 16, seed=1)
        w = np.random.default_rng(9).random(r.size)
        cfg = GraphConfig(num_vertices=N, transpose=True)
        g = Graph.from_edges(r, c, w, cfg)
        jg = JGraph.from_edges(r, c, w, JGraphConfig(num_vertices=N,
                                                     transpose=True),
                               mesh=_jmesh())
    ts, jts = g.tiled(), jg.tiled(JOrdering.ROW)
    if case == "sum_f64_weighted":
        # the port's tiles keep float weights in their own type; the JAX
        # build does so when asked (its Graph.tiled asks for int32)
        assert ts.weights.dtype == np.float64
        jts = j_build_tileset(jg.r, jg.c, jg.w, jg.part,
                              parallel_edges=jg.config.parallel_edges,
                              edge_align=jg.config.edge_align,
                              weight_dtype=np.float64)
    sem, jsem = _semirings({"sum_f64": "plus_times",
                            "sum_f64_weighted": "plus_times",
                            "min_int32_weighted": "min_plus",
                            "max_int32": "max",
                            "max_int32_weighted": "max",
                            "maxplus_int32_weighted": "maxplus"}[case])
    rng = np.random.default_rng(7)
    nc = g.part.tile_cols
    if case.startswith("sum"):
        x = rng.random(nc)
    else:
        x = rng.integers(-1000 if case.startswith("max") else 0, 1000,
                         nc).astype(np.int32)
        x[rng.random(nc) < 0.3] = sem.identity
    plan = oh.build_onehot_plan(ts)
    t = meta_from_numpy(plan.arrays, "cpu")
    y = oh.spmv_onehot(_t(x), t, plan, sem, ts.NR)
    got = expand_compact(y, _t(ts.iv_dense[0]), sem).numpy()
    jplan = jps.build_pallas_plan(jts.rows, jts.cols, jts.weights, jts.nnz,
                                  jts.NR)
    xv = jnp.take(jnp.asarray(x), jnp.asarray(jplan.cols[0]), axis=0)
    wv = jnp.asarray(jplan.weights[0]) if jplan.weights is not None \
        else None
    contrib = jsem.mul(xv, wv)
    contrib = jnp.where(jnp.asarray(jplan.evalid[0]), contrib,
                        jsem.identity_like(contrib.dtype))
    yc = jps.pallas_segment_reduce(
        contrib, jnp.asarray(jplan.lrows[0]),
        jnp.asarray(jplan.chunk_block[0]), jplan.nblocks, jts.NR, jsem,
        interpret=True)
    want = np.asarray(j_expand_compact(yc, jnp.asarray(jts.iv_dense[0]),
                                       jsem))
    assert got.dtype == want.dtype and got.shape == want.shape
    if case.startswith("sum"):
        np.testing.assert_allclose(got, want, rtol=SUM_RTOL[np.float64],
                                   atol=0)
    else:
        np.testing.assert_array_equal(got, want)


# ------------------------------------------ (d) the apps through onehot
@pytest.fixture(scope="module")
def pr_graph():
    r, c, _ = rmat_edges(10, 16, seed=1)
    return r, c, Graph.from_edges(r, c, None, GraphConfig(num_vertices=N,
                                                          transpose=True))


def test_pagerank_onehot_matches_golden_and_jax(pr_graph):
    r, c, g = pr_graph
    ex = run_pagerank(g, ITERS, torch.float64, kernel="onehot",
                      degree_kernel="onehot", device="cpu")
    assert isinstance(ex.meta, oh.PallasPlan) and ex.device_bytes > 0
    assert ex.degree_phase.kernel == "onehot"
    np.testing.assert_array_equal(ex.degree_phase.state_vector()["degree"],
                                  golden.degree(r, c, N + 1).astype(
                                      np.float64))
    np.testing.assert_allclose(ex.state_vector()["rank"],
                               golden.pagerank(r, c, N + 1, ITERS),
                               rtol=1e-10, atol=0)
    jg = JGraph.from_edges(r, c, None, JGraphConfig(num_vertices=N,
                                                    transpose=True),
                           mesh=_jmesh())
    jex = j_run_pagerank(jg, JAX_ITERS, jnp.float64, kernel="onehot")
    mine = run_pagerank(g, JAX_ITERS, torch.float64, kernel="onehot",
                        degree_kernel="onehot", device="cpu")
    np.testing.assert_allclose(mine.state_vector()["rank"],
                               np.asarray(jex.state_vector()["rank"]),
                               rtol=1e-10, atol=0)


@pytest.mark.parametrize("app", ["bfs", "cc", "sssp"])
def test_apps_onehot_match_golden(app):
    if app == "sssp":
        r, c, w = rmat_edges(10, 16, seed=1, weighted=True)
        ex = run_sssp(Graph.from_edges(r, c, w, sssp_config(N)), 0,
                      kernel="onehot", device="cpu")
        want = {"distance": golden.sssp(r, c, w.astype(np.int64), N + 1, 0)}
    else:
        r, c, _ = rmat_edges(10, 16, seed=1)
        if app == "bfs":
            ex = run_bfs(Graph.from_edges(r, c, None, bfs_config(N)), 0,
                         kernel="onehot", device="cpu")
            parent, hops = golden.bfs(r, c, N + 1, 0)
            want = {"parent": parent, "hops": hops}
        else:
            ex = run_cc(Graph.from_edges(r, c, None, cc_config(N)),
                        kernel="onehot", device="cpu")
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
    plan = oh.build_onehot_plan(g.tiled())
    t = meta_from_numpy(plan.arrays, "cpu")
    contrib = oh.onehot_contrib(torch.rand(g.part.tile_cols), t,
                                tsr.plus_times())
    return g, plan, t, contrib


def test_segment_reduce_rejects_bad_inputs(small):
    g, plan, t, c = small
    lr, cb = t["oh_lrows"], t["oh_chunk_block"]
    nr = g.tiled().NR
    with pytest.raises(ValueError, match="contrib"):
        oh.segment_reduce(c[:-1], lr, cb, plan.nblocks, nr, "sum", 0.0)
    with pytest.raises(TypeError, match="dtype"):
        oh.segment_reduce(c.half(), lr, cb, plan.nblocks, nr, "sum", 0.0)
    with pytest.raises(TypeError, match="lrows"):
        oh.segment_reduce(c, lr.long(), cb, plan.nblocks, nr, "sum", 0.0)
    with pytest.raises(TypeError, match="chunk_block"):
        oh.segment_reduce(c, lr, cb.long(), plan.nblocks, nr, "sum", 0.0)
    with pytest.raises(ValueError, match="contiguous"):
        oh.segment_reduce(torch.stack([c, c], 1)[:, 0], lr, cb,
                          plan.nblocks, nr, "sum", 0.0)
    with pytest.raises(ValueError, match="segment_reduce"):
        oh.segment_reduce(c.double(), lr, cb, plan.nblocks, nr, "min", 0.0)
    with pytest.raises(ValueError, match="NR"):
        oh.segment_reduce(c, lr, cb, plan.nblocks, plan.nblocks * 128 + 1,
                          "sum", 0.0)
    # no launch was counted: the CPU runs the plain version
    before = dict(oh.LAUNCHES)
    oh.segment_reduce(c, lr, cb, plan.nblocks, nr, "sum", 0.0)
    assert oh.LAUNCHES == before


def _bad(plan, key, edit):
    a = getattr(plan, key).copy()
    edit(a[0])
    return dataclasses.replace(plan, **{key: a})


@pytest.mark.parametrize("key,edit,match", [
    ("lrows", lambda a: a.__setitem__(0, 128), "lrows"),
    ("lrows", lambda a: a.__setitem__(-1, -1), "lrows"),
    ("chunk_block", lambda a: a.__setitem__(0, 10 ** 6), "chunk_block"),
    ("cols", lambda a: a.__setitem__(3, 10 ** 6), "cols"),
])
def test_validate_rejects_out_of_range(small, key, edit, match):
    g, plan, _, _ = small
    nc = g.part.tile_cols
    oh.validate_pallas_plan(plan, nc)
    with pytest.raises(ValueError, match=match):
        oh.validate_pallas_plan(_bad(plan, key, edit), nc)


def test_executor_onehot_plans_type_and_reuse(small):
    g, plan, _, _ = small
    with pytest.raises(TypeError, match="PallasPlan"):
        Executor(g, PageRankProgram(torch.float32), kernel="onehot",
                 plans=object(), device="cpu")
    ex = Executor(g, PageRankProgram(torch.float32), kernel="onehot",
                  plans=plan, device="cpu")
    assert ex.meta is plan and "iv_dense" in ex._dev
    bad = _bad(plan, "lrows", lambda a: a.__setitem__(0, 200))
    with pytest.raises(ValueError, match="lrows"):
        Executor(g, PageRankProgram(torch.float32), kernel="onehot",
                 plans=bad, device="cpu")


# ------------------------------------------ (f) K5 from the plan (fused)
@pytest.mark.parametrize("case", GATHER_CASES)
def test_segment_reduce_gather_matches_composition(case):
    """K5 from the plan, on the CPU, equals the one-hot contributions by
    the semiring's ⊗ (``onehot_contrib``) folded by ``segment_reduce_plain``
    bit for bit, and so does ``spmv_onehot``; the CPU launches nothing and
    gathers no slot into the tracer's counter."""
    x, plan, nr, sem = gather_case(case)
    if case == "f32_sum_pad_chunk":
        assert not plan.evalid[0, -oh.CHUNK:].any()
    t = meta_from_numpy(plan.arrays, "cpu")
    w = t.get("oh_w")
    assert (w is not None) == ("_w" in case)
    assert w is None or w.dtype == x.dtype
    args = (t["oh_lrows"], t["oh_chunk_block"], plan.nblocks, nr,
            sem.reduce_kind)
    want = oh.segment_reduce_plain(oh.onehot_contrib(x, t, sem), *args,
                                   sem.identity)
    before = dict(oh.LAUNCHES)
    with timing.tracing() as tr:
        got = oh.segment_reduce_gather(
            x, t["oh_cols"], t["oh_evalid"], w, *args[:4], plan.col_bound,
            sem.reduce_kind, mul_kind(plan, sem), sem.identity)
        y = oh.spmv_onehot(x, t, plan, sem, nr)
    assert got.dtype == x.dtype and got.shape == (nr,)
    assert torch.equal(got, want) and torch.equal(y, want)
    if case == "f32_minplus_w_inf":
        assert torch.isinf(want).any() and not torch.isinf(want).all()
    assert oh.LAUNCHES == before
    assert tr.counters["onehot_gathered_slots"] == 0


@pytest.mark.parametrize("case", GATHER_CASES)
def test_gather_tables_fold_as_the_plan(case):
    """K5 from the plan's gather tables hold each chunk's edges by col,
    each at its slot's place in the chunk's fold order (by lane, then
    slot), with each chunk's lane counts; folded as the card's kernel folds
    them (``gather_tables_plain``), they give ``segment_reduce_gather_plain``
    of the plan bit for bit."""
    x, plan, nr, sem = gather_case(case)
    t = meta_from_numpy(plan.arrays, "cpu")
    w = oh.plan_weights(t, x.dtype)
    tables = oh.gather_tables(t["oh_cols"], t["oh_evalid"], t["oh_lrows"],
                              w, plan.col_bound)
    ecol, edest, ew, eptr, lcount = tables
    nch, ev = plan.nchunks, t["oh_evalid"] != 0
    assert (ecol.dtype, edest.dtype, eptr.dtype, lcount.dtype) == (
        torch.int32, torch.int16, torch.int32, torch.int16)
    assert (ew is None) == (w is None)
    assert lcount.shape == (nch, oh.RB)
    assert bool((lcount.sum(1) == oh.CHUNK).all())
    assert int(eptr[0]) == 0 and int(eptr[-1]) == int(ev.sum())
    slots = torch.nonzero(ev).squeeze(1)
    per = torch.bincount(slots // oh.CHUNK, minlength=nch)
    assert torch.equal(eptr[1:] - eptr[:-1], per.to(torch.int32))
    lanes = t["oh_lrows"].long()
    for c in sorted({0, nch // 2, nch - 1}):
        e = slice(int(eptr[c]), int(eptr[c + 1]))
        cc, dd = ecol[e].long(), edest[e].long()
        assert bool((cc[1:] >= cc[:-1]).all())
        own = slots[slots // oh.CHUNK == c]
        assert torch.equal(torch.sort(cc).values,
                           torch.sort(t["oh_cols"][own].long()).values)
        chunk_lanes = lanes[c * oh.CHUNK:(c + 1) * oh.CHUNK]
        order = torch.sort(chunk_lanes, stable=True).indices
        place = torch.empty_like(order)
        place[order] = torch.arange(oh.CHUNK)
        assert torch.equal(torch.sort(dd).values,
                           torch.sort(place[own - c * oh.CHUNK]).values)
    args = (t["oh_chunk_block"], plan.nblocks, nr, sem.reduce_kind,
            mul_kind(plan, sem), sem.identity)
    want = oh.segment_reduce_gather_plain(
        x, t["oh_cols"], t["oh_evalid"], w, t["oh_lrows"], *args[:3],
        plan.col_bound, *args[3:])
    assert torch.equal(oh.gather_tables_plain(x, tables, *args), want)


def test_plan_weights_in_the_value_type():
    """Int32 weights by f32 values are converted once (``oh_wv``, kept in
    the device dict by ``fold_tables``) and give torch's promoted ⊗ bit
    for bit; f64 weights by f32 values raise."""
    x, plan, nr, sem = gather_case("f32_sum")
    w = np.random.default_rng(3).integers(0, 9, (1, plan.Ep)).astype(np.int32)
    plan = dataclasses.replace(plan, weights=w)
    t = meta_from_numpy(plan.arrays, "cpu")
    oh.fold_tables(t, plan, torch.float32)
    wv = t["oh_wv"]
    assert wv.dtype == torch.float32
    want = oh.segment_reduce_plain(
        oh.onehot_contrib(x, t, sem), t["oh_lrows"], t["oh_chunk_block"],
        plan.nblocks, nr, "sum", 0)
    assert torch.equal(oh.spmv_onehot(x, t, plan, sem, nr), want)
    assert t["oh_wv"] is wv
    plan = dataclasses.replace(plan, weights=w.astype(np.float64))
    t = meta_from_numpy(plan.arrays, "cpu")
    with pytest.raises(TypeError, match="weights"):
        oh.spmv_onehot(x, t, plan, sem, nr)


_GATHER_BAD = {
    "x_dtype": (lambda a: {**a, "x": a["x"].half()}, TypeError, "dtype"),
    "x_2d": (lambda a: {**a, "x": a["x"][None]}, ValueError, "1-D"),
    "x_strided": (lambda a: {**a, "x": torch.stack([a["x"]] * 2, 1)[:, 0]},
                  ValueError, "contiguous"),
    "x_short": (lambda a: {**a, "x": a["x"][:a["NC"] - 1]}, ValueError,
                "columns below"),
    "cols_dtype": (lambda a: {**a, "cols": a["cols"].long()}, TypeError,
                   "cols"),
    "cols_shape": (lambda a: {**a, "cols": a["cols"][:-1]}, ValueError,
                   "cols"),
    "cols_device": (lambda a: {**a, "cols": a["cols"].to("meta")},
                    ValueError, "cols on meta"),
    "evalid_dtype": (lambda a: {**a, "evalid": a["evalid"] != 0},
                     TypeError, "evalid"),
    "lrows_shape": (lambda a: {**a, "lrows": a["lrows"][1:]}, ValueError,
                    "lrows"),
    "weights_dtype": (lambda a: {**a, "weights": a["weights"].double()},
                      TypeError, "weights"),
    "weights_without_mul": (lambda a: {**a, "mul_kind": "none"},
                            ValueError, "mul_kind"),
    "mul_without_weights": (lambda a: {**a, "weights": None}, ValueError,
                            "mul_kind"),
    "mul_kind_unknown": (lambda a: {**a, "mul_kind": "pow"}, ValueError,
                         "mul_kind"),
    "reduce_kind": (lambda a: {**a, "x": a["x"].double(),
                               "weights": a["weights"].double(),
                               "reduce_kind": "min"}, ValueError,
                    "segment_reduce_gather"),
    "nr": (lambda a: {**a, "NR": a["nblocks"] * oh.RB + 1}, ValueError,
           "NR"),
}


@pytest.mark.parametrize("bad", sorted(_GATHER_BAD))
def test_segment_reduce_gather_rejects_bad_inputs(bad):
    x, plan, nr, sem = gather_case("f32_sum_w", scale=8)
    t = meta_from_numpy(plan.arrays, "cpu")
    good = {"x": x, "cols": t["oh_cols"], "evalid": t["oh_evalid"],
            "weights": t["oh_w"], "lrows": t["oh_lrows"],
            "chunk_block": t["oh_chunk_block"], "nblocks": plan.nblocks,
            "NR": nr, "NC": plan.col_bound, "reduce_kind": "sum",
            "mul_kind": "mul", "identity": 0.0}
    oh.segment_reduce_gather(**good)
    edit, err, match = _GATHER_BAD[bad]
    with pytest.raises(err, match=match):
        oh.segment_reduce_gather(**edit(good))
