"""The port's frontier-gated panel pipeline against the JAX package's.

The graph and frontier of ``tests/test_panel.py``'s gating test: n = 4096,
E = 50,000 (seed 21), int32 ``min_plus`` with weights 1-59, ~2% of the x
columns active. One JAX ``spmv3_local(gate=True, interpret=True)`` call
runs the gated Pallas kernels in interpret mode, each call recorded with
its inputs. Then, bit for bit:

  * the port's gating maps (window bases and plan indices of K1, K2, K3)
    equal the ones the JAX kernels were given, so both ran on the same maps;
  * each gated plain kernel of the port, on its twin's recorded inputs,
    equals the gated Pallas kernel's output;
  * the port's ``spmv3_local`` with gate True, "auto" and False equals the
    JAX gated result;
  * an empty frontier gives an all-identity y through the gated path.

The "auto" vote counts x-expand panels with an active x block. On this
uniform random graph every panel reads every x block, so even the 2%
frontier votes static; on an RMAT-12 graph read through ``bfs_config``,
a 2% frontier clustered in one part of the vertex range votes gated, and
a dense x votes static.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from graphtap_tpu.kernels import panel_engine as jpe
from graphtap_tpu.kernels import semiring as jsr

from graphtap_tpu_torch.config import Compression
from graphtap_tpu_torch.format.tiles import build_tileset
from graphtap_tpu_torch.kernels import panel_engine as tpe
from graphtap_tpu_torch.kernels import panel_kernels as pk
from graphtap_tpu_torch.kernels import semiring as tsr
from graphtap_tpu_torch.kernels.panel_meta import (Spmv3Meta,
                                                   build_spmv3_meta,
                                                   fill_blocks,
                                                   validate_meta)
from graphtap_tpu_torch.parallel.layout import Partition
from graphtap_tpu_torch.tools.convert import meta_from_numpy

INF = tsr.INF_I32
KERNELS = ("route_xr_exp", "route_passa", "route_fold", "hub_fold")


@pytest.fixture(scope="module")
def gated_case():
    rng = np.random.default_rng(21)
    n, E = 4096, 50000
    r = rng.integers(0, n, size=E).astype(np.int64)
    c = rng.integers(0, n, size=E).astype(np.int64)
    w = rng.integers(1, 60, size=E).astype(np.int32)
    part = Partition.build(nv=n, R=1, C=1, segment_align=1024)
    ts = build_tileset(r, c, w, part, compression=Compression.TCSC)
    meta = build_spmv3_meta(ts, value_dtype=np.int32)
    x = np.full(part.tile_cols, INF, np.int32)
    act = rng.random(part.tile_cols) < 0.02
    x[act] = rng.integers(0, 1000, size=int(act.sum())).astype(np.int32)
    xd = rng.integers(0, 1000, size=part.tile_cols).astype(np.int32)
    return part, meta, x, xd


@pytest.fixture(scope="module")
def jax_gated(gated_case):
    """JAX spmv3_local(gate=True) in interpret mode; every kernel call
    recorded as (name, args, kwargs, output)."""
    part, meta, x, _ = gated_case
    t = {k: jnp.asarray(v[0]) for k, v in meta.arrays.items()}
    calls = []
    mp = pytest.MonkeyPatch()

    def recorder(name, fn):
        def wrapped(*args, **kwargs):
            out = fn(*args, **kwargs)
            calls.append((name, args, kwargs, np.asarray(out)))
            return out
        return wrapped

    try:
        for name in KERNELS:
            mp.setattr(jpe, name, recorder(name, getattr(jpe, name)))
        y = jpe.spmv3_local(jnp.asarray(x), t, meta, jsr.min_plus(),
                            dense_len=part.tile_rows, interpret=True,
                            gate=True)
    finally:
        mp.undo()
    return np.asarray(y), calls


def _t(a):
    return torch.from_numpy(np.array(a))


def test_gating_maps_and_stages_match_jax(gated_case, jax_gated):
    part, meta, x, _ = gated_case
    y_jax, calls = jax_gated
    assert [cl[0] for cl in calls] == ["route_xr_exp", "route_passa",
                                       "route_fold", "hub_fold",
                                       "route_fold"]
    t = meta_from_numpy(meta.arrays, "cpu")
    sem = tsr.min_plus()
    st = tpe.spmv3_stages(_t(x), t, meta, sem, part.tile_rows, gate=True)
    assert st["gated"]
    xe_b, xe_q, pa_b, pa_q, fx_b, fx_q = st["maps"]
    (_, a1, k1, out1), (_, a2, k2, out2), (_, a3, k3, out3) = calls[:3]
    # the same maps went into the Pallas kernels
    for mine, theirs in ((xe_b, a1[1]), (xe_q, k1["plan_idx"]),
                         (pa_b, a2[1]), (pa_q, k2["plan_idx"]),
                         (fx_b, a3[1]), (fx_q, k3["plan_idx"])):
        assert mine.dtype == torch.int32
        np.testing.assert_array_equal(mine.numpy(), np.asarray(theirs))
    np.testing.assert_array_equal(st["x2d"].numpy(), np.asarray(a1[0]))
    fill = sem.identity
    s0 = pk.route_xr_exp_plain(_t(a1[0]), xe_b, t["xe_plan"],
                               t["w_stream"], fill, meta.exp_panels + 1,
                               meta.xr_nwin, "add_sat", plan_idx=xe_q)
    np.testing.assert_array_equal(s0.numpy(), out1)
    s1 = pk.route_passa_plain(_t(a2[0]), pa_b, t["pa_plan"], fill,
                              meta.pa_panels + 1, meta.pa_nwin,
                              plan_idx=pa_q)
    np.testing.assert_array_equal(s1.numpy(), out2)
    y_mid = pk.route_fold_plain(_t(a3[0]), fx_b, t["fixr_plan"],
                                t["fix_dst"], t["fixr_seg"], meta.nrb,
                                "min", fill, meta.fix_panels,
                                meta.fixr_nwin, plan_idx=fx_q)
    np.testing.assert_array_equal(y_mid.numpy(), out3)
    # the port's own gated chain, stage by stage
    for name, out in (("s0", out1), ("s1", out2), ("y_mid", out3),
                      ("y_hub", calls[3][3]), ("y", y_jax)):
        np.testing.assert_array_equal(st[name].numpy(), out, err_msg=name)


def test_gated_kernels_match_pallas_redirected():
    """Gated K1-K3 with panels really redirected, each fed the same maps
    as its Pallas twin (interpret mode): RMAT-12 through ``sssp_config``
    (weighted, add_sat), a 2% frontier clustered mid-range. K1 takes the
    port's gating maps, which gate x-expand panels off; K2 and K3 take
    plan indices with about half the panels pointed at the fill block
    (the JAX maps keep nearly every pa and fixr panel active)."""
    from graphtap_tpu.kernels import panel_kernels as jpk
    from graphtap_tpu_torch import Graph
    from graphtap_tpu_torch.apps import sssp_config
    from graphtap_tpu_torch.ingest import rmat_edges
    r, c, w = rmat_edges(12, 16, seed=1, weighted=True)
    g = Graph.from_edges(r, c, w, sssp_config(1 << 12))
    meta = build_spmv3_meta(g.tiled(), value_dtype=np.int32)
    assert meta.has_w
    t = meta_from_numpy(meta.arrays, "cpu")
    jt = {k: jnp.asarray(v[0]) for k, v in meta.arrays.items()}
    nc = g.part.tile_cols
    rng = np.random.default_rng(8)
    x = np.full(nc, INF, np.int32)
    x[nc // 2:nc // 2 + nc // 50] = rng.integers(0, 1000, nc // 50)
    x2d = tpe.pad_x(_t(x), meta, INF)
    xe_b, xe_q = tpe.gating_maps(
        tpe.window_activity(x2d, t, meta, INF), t, meta)[:2]
    assert (xe_q[:meta.exp_panels] == meta.exp_panels).sum() >= 2
    fb = fill_blocks(meta)

    def half_off(n, fill):
        q = np.arange(n, dtype=np.int32)
        q[rng.random(n) < 0.5] = fill
        return _t(q)

    npa = meta.pa_panels + 1
    pa_q = half_off(npa, fb["pa_plan"])
    fx_q = half_off(meta.fix_panels, fb["fixr_plan"])
    s0 = pk.route_xr_exp_plain(x2d, xe_b, t["xe_plan"], t["w_stream"], INF,
                               meta.exp_panels + 1, meta.xr_nwin, "add_sat",
                               plan_idx=xe_q)
    j0 = jpk.route_xr_exp(jnp.asarray(x2d.numpy()), jnp.asarray(xe_b),
                          jt["xe_plan"], jt["w_stream"], np.int32(INF),
                          meta.exp_panels + 1, meta.xr_nwin,
                          mul_kind="add_sat", interpret=True,
                          plan_idx=jnp.asarray(xe_q))
    np.testing.assert_array_equal(s0.numpy(), np.asarray(j0))
    s1 = pk.route_passa_plain(s0, t["pa_bases"], t["pa_plan"], INF, npa,
                              meta.pa_nwin, plan_idx=pa_q)
    j1 = jpk.route_passa(j0, jt["pa_bases"], jt["pa_plan"], np.int32(INF),
                         npa, meta.pa_nwin, interpret=True,
                         plan_idx=jnp.asarray(pa_q))
    np.testing.assert_array_equal(s1.numpy(), np.asarray(j1))
    y = pk.route_fold_plain(s1, t["fixr_bases"], t["fixr_plan"],
                            t["fix_dst"], t["fixr_seg"], meta.nrb, "min",
                            INF, meta.fix_panels, meta.fixr_nwin,
                            plan_idx=fx_q)
    jy = jpk.route_fold(j1, jt["fixr_bases"], jt["fixr_plan"], jt["fix_dst"],
                        meta.nrb, "min", np.int32(INF), meta.fix_panels,
                        meta.fixr_nwin, seg=jt["fixr_seg"],
                        ini=jt["fixr_ini"], interpret=True,
                        plan_idx=jnp.asarray(fx_q))
    np.testing.assert_array_equal(y.numpy(), np.asarray(jy))


@pytest.mark.parametrize("gate", [True, "auto", False])
def test_spmv3_gate_modes_match_jax_gated(gated_case, jax_gated, gate):
    part, meta, x, _ = gated_case
    t = meta_from_numpy(meta.arrays, "cpu")
    before = dict(pk.LAUNCHES)
    st = tpe.spmv3_stages(_t(x), t, meta, tsr.min_plus(), part.tile_rows,
                          gate=gate)
    assert pk.LAUNCHES == before            # CPU tensors launch nothing
    np.testing.assert_array_equal(st["y"].numpy(), jax_gated[0])
    # every x-expand panel of the uniform graph sees an active block
    assert st["gated"] == (gate is True)
    assert _share(_t(x), t, meta) == 1.0


def _share(x, t, meta):
    """Active x-expand panels / exp_panels, what "auto" compares with
    GATE_RATIO."""
    w_act = tpe.window_activity(tpe.pad_x(x, meta, INF), t, meta, INF)
    return w_act[:meta.exp_panels].any(1).float().mean().item()


@pytest.fixture(scope="module")
def rmat12_bfs():
    from graphtap_tpu_torch import Graph
    from graphtap_tpu_torch.apps import bfs_config
    from graphtap_tpu_torch.ingest import rmat_edges
    r, c, _ = rmat_edges(12, 16, seed=1)
    g = Graph.from_edges(r, c, None, bfs_config(1 << 12))
    meta = build_spmv3_meta(g.tiled(), value_dtype=np.int32)
    return g, meta, meta_from_numpy(meta.arrays, "cpu")


@pytest.mark.parametrize("frontier", ["clustered_2pct", "dense", "empty"])
def test_auto_vote_on_rmat(rmat12_bfs, frontier):
    g, meta, t = rmat12_bfs
    nc = g.part.tile_cols
    rng = np.random.default_rng(3)
    x = np.full(nc, INF, np.int32)
    if frontier == "clustered_2pct":
        lo = nc // 2
        x[lo:lo + nc // 50] = rng.integers(0, 1000, nc // 50)
    elif frontier == "dense":
        x[:] = rng.integers(0, 1000, nc)
    sem = tsr.min_select()
    ys = {}
    for gate in (False, True, "auto"):
        st = tpe.spmv3_stages(_t(x), t, meta, sem, g.part.tile_rows,
                              gate=gate)
        ys[gate] = st["y"]
        if gate == "auto":
            assert st["gated"] == (frontier != "dense")
            assert (_share(_t(x), t, meta) <= tpe.GATE_RATIO) == \
                st["gated"]
    assert torch.equal(ys[True], ys[False])
    assert torch.equal(ys["auto"], ys[False])
    if frontier == "empty":
        assert bool((ys[True] == INF).all())


def test_gated_empty_frontier_is_identity(gated_case):
    part, meta, _, _ = gated_case
    t = meta_from_numpy(meta.arrays, "cpu")
    x = torch.full((part.tile_cols,), INF, dtype=torch.int32)
    for gate in (True, "auto"):
        st = tpe.spmv3_stages(x, t, meta, tsr.min_plus(), part.tile_rows,
                              gate=gate)
        assert st["gated"]                   # no active panel at all
        assert bool((st["y"] == INF).all())
        xe_q = st["maps"][1].numpy()
        # only the forced-active fill panel keeps its own plan block
        assert (xe_q == meta.exp_panels).all()


def test_gated_wrappers_validate(gated_case):
    part, meta, x, _ = gated_case
    t = meta_from_numpy(meta.arrays, "cpu")
    s0 = torch.zeros(((meta.exp_panels + 1) * 64, 128), dtype=torch.int32)
    npa = meta.pa_panels + 1
    args = (s0, t["pa_bases"], t["pa_plan"], INF, npa, meta.pa_nwin)
    q = torch.arange(npa, dtype=torch.int32)
    fill = meta.pa_panels
    with pytest.raises(TypeError):                       # index dtype
        pk.route_passa(*args, plan_idx=q.long(), fill_block=fill)
    with pytest.raises(ValueError):                      # too short
        pk.route_passa(*args, plan_idx=q[:-1], fill_block=fill)
    with pytest.raises(ValueError):                      # fill block
        pk.route_passa(*args, plan_idx=q, fill_block=npa)
    with pytest.raises(ValueError):                      # none given
        pk.route_passa(*args, plan_idx=q)
    with pytest.raises(ValueError):
        tpe.spmv3_local(_t(x), t, meta, tsr.min_plus(), part.tile_rows,
                        gate="yes")
    # every panel pointed at its own block is the static route
    assert torch.equal(pk.route_passa(*args, plan_idx=q,
                                      fill_block=meta.pa_panels),
                       pk.route_passa(*args))


@pytest.mark.parametrize("route", ["xe_plan", "pa_plan", "fixr_plan"])
def test_validate_meta_checks_fill_blocks(gated_case, route):
    """The CUDA kernels skip a gated-off panel's gathers, which is exact
    only if the fill block routes no source: validate_meta enforces it."""
    _, meta, _, _ = gated_case
    arrays = dict(meta.arrays)
    plan = arrays[route].copy()
    nblk = {"xe_plan": meta.exp_panels + 1, "pa_plan": meta.pa_panels + 1,
            "fixr_plan": meta.fix_panels + 1}[route]
    prows = plan.shape[1] // nblk
    blk = fill_blocks(meta)[route]
    plan[0, (blk + 1) * prows - 1] = 0          # an idx3 row: harmless
    arrays[route] = plan
    bad = Spmv3Meta(**{**meta.__dict__, "arrays": arrays})
    validate_meta(bad)
    plan = plan.copy()
    sel_a = prows - 3 * 64                      # first landing row
    plan[0, blk * prows + sel_a] = 0            # lands band 0: a source
    arrays[route] = plan
    with pytest.raises(ValueError, match="fill block"):
        validate_meta(Spmv3Meta(**{**meta.__dict__, "arrays": arrays}))
