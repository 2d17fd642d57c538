"""The staged panel SpMV against the JAX package's Pallas kernels.

The staged (unfused) v3 pipeline is the composition of
tests/test_panel.py:145-210: x -> x_ext (K2 ``route_passa``, single
layer) -> s0 (K11 ``route_expand``) -> s1 (K2) -> stack1 (K2, fixr) ->
y_mid (K13 ``colsum_chunks``); K12 ``fold_stripes`` folds stack1 per
panel. Here that composition runs on the Pallas kernels (interpret mode)
and records each call; each plain torch kernel (what a CPU tensor
dispatches to) then runs on the recorded inputs of its twin:

  * K2 single-layer and K11 bit for bit in f32, f64 and int32;
  * K12 bit for bit in int32, within rtol 1e-6 in f32 and f64 (an 8-term
    sum may add in another order);
  * K13 bit for bit in int32, within rtol 1e-5 in f32 and 1e-12 in f64.

Then the port's ``spmv3_staged`` on a panel meta: each stage against the
same composition of the Pallas kernels on the JAX package's meta, and its
y against the port's fused ``spmv3_local``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from graphtap_tpu.config import GraphConfig as JGraphConfig
from graphtap_tpu.ingest.graph import Graph as JGraph
from graphtap_tpu.kernels import panel_engine as jpe
from graphtap_tpu.kernels import panel_kernels as jk
from graphtap_tpu.kernels import semiring as jsr
from graphtap_tpu.kernels.panel_plan import NWIN_X, build_spmv3_plan
from graphtap_tpu.parallel.layout import make_mesh

from graphtap_tpu_torch import Graph, GraphConfig
from graphtap_tpu_torch.ingest import rmat_edges
from graphtap_tpu_torch.kernels import panel_kernels as pk
from graphtap_tpu_torch.kernels import semiring as tsr
from graphtap_tpu_torch.kernels.fold_order import row_lists
from graphtap_tpu_torch.kernels.panel_engine import (spmv3_local,
                                                     spmv3_staged,
                                                     spmv3_staged_stages,
                                                     staged_tables)
from graphtap_tpu_torch.kernels.panel_meta import build_spmv3_meta
from graphtap_tpu_torch.tools.convert import meta_from_numpy

import jax

XROWS, STRIPE = pk.XROWS, pk.STRIPE
FOLD_RTOL = {np.dtype(np.float32): 1e-5, np.dtype(np.float64): 1e-12}
# (dtype, ⊕, weighted): the ⊗ is mul for weighted sums, add_sat for min
CASES = {"f32_sum": (np.float32, "sum", False),
         "f64_sum_weighted": (np.float64, "sum", True),
         "i32_min_weighted": (np.int32, "min", True)}


def _fill(dtype, kind):
    return dtype(0) if kind == "sum" else np.int32(jsr.INF_I32)


def _mul_kind(kind, weighted):
    return ("mul" if kind == "sum" else "add_sat") if weighted else "none"


def _t(a):
    return torch.from_numpy(np.array(a))


def _exact(got, want):
    want = np.asarray(want)
    assert got.dtype == torch.from_numpy(np.zeros(0, want.dtype)).dtype
    np.testing.assert_array_equal(got.numpy(), want)


def _close(got, want, rtol):
    if got.dtype.is_floating_point:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol,
                                   atol=0)
    else:
        _exact(got, want)


@pytest.fixture(scope="module", params=list(CASES))
def composition(request):
    """tests/test_panel.py:145-210's composition on its kind of random
    graph (at a smaller size), every kernel call's inputs and output."""
    dtype, kind, weighted = CASES[request.param]
    rng = np.random.default_rng(7)
    NR, NC, E = 256, 512, 6000
    r = rng.integers(0, NR, size=E).astype(np.int64)
    c = rng.integers(0, NC, size=E).astype(np.int64)
    w = rng.integers(1, 50, size=E).astype(np.int32) if weighted else None
    fill = _fill(dtype, kind)
    mk = _mul_kind(kind, weighted)
    plan = build_spmv3_plan(r, c, w, NR, NC, dense_len=NR, iv_dense=None,
                            value_dtype=dtype)

    def pack(rt, npanels, out_rows=64, two_layer=True):
        return jk.pack_route_plan(rt.idx1, rt.sel_a, rt.sel_b, rt.idx3,
                                  npanels, rt.src_rows, out_rows=out_rows,
                                  two_layer=two_layer)
    if kind == "sum":
        x = rng.random(NC).astype(dtype)
    else:
        x = rng.integers(0, 500, size=NC).astype(dtype)
    x2d = np.full((plan.sx_rows, pk.LANES), fill, dtype)
    x2d.reshape(-1)[:NC] = x
    xr = pack(plan.xr_route, plan.exp_panels, out_rows=XROWS,
              two_layer=False)
    x_ext = np.asarray(jk.route_passa(
        jnp.asarray(x2d), jnp.asarray(plan.xr_bases), jnp.asarray(xr), fill,
        plan.exp_panels, NWIN_X, interpret=True, out_rows=XROWS,
        two_layer=False))
    ex = pack(plan.exp_route, plan.exp_panels)
    w_stream = plan.w_stream if weighted else None
    s0 = np.asarray(jk.route_expand(
        jnp.asarray(x_ext), jnp.asarray(ex),
        None if w_stream is None else jnp.asarray(w_stream), fill,
        plan.exp_panels, mul_kind=mk, interpret=True))
    s0p = np.concatenate([s0, np.full((STRIPE, pk.LANES), fill, dtype)])
    s1 = np.asarray(jk.route_passa(
        jnp.asarray(s0p), jnp.asarray(plan.pa_bases),
        jnp.asarray(pack(plan.pa_route, plan.pa_panels)), fill,
        plan.pa_panels, plan.pa_nwin, interpret=True))
    s1f = np.concatenate([s1, np.full((STRIPE, pk.LANES), fill, dtype)])
    stack1 = np.asarray(jk.route_passa(
        jnp.asarray(s1f), jnp.asarray(plan.fixr_bases),
        jnp.asarray(pack(plan.fixr_route, plan.fix_panels)), fill,
        plan.fix_panels, plan.fixr_nwin, interpret=True))
    nrb = int(plan.fix_dst.max()) + 1 if plan.fix_dst.size else 1
    nblocks = -(-nrb // STRIPE) * STRIPE
    y_mid = np.asarray(jk.colsum_chunks(
        jnp.asarray(stack1), jnp.asarray(plan.fix_dst), nblocks, kind, fill,
        interpret=True))
    folded = np.asarray(jk.fold_stripes(jnp.asarray(stack1), kind,
                                        plan.fix_panels, interpret=True))
    return dict(dtype=dtype, kind=kind, fill=fill, mk=mk, plan=plan,
                x2d=x2d, xr=xr, x_ext=x_ext, ex=ex, w_stream=w_stream, s0=s0,
                stack1=stack1, fix_dst=plan.fix_dst.astype(np.int32),
                nblocks=nblocks, y_mid=y_mid, folded=folded)


def test_route_passa_single_layer_matches_pallas(composition):
    """K2's single-layer form (the x -> x_ext route): 32-row panels, no
    sel_b, the pick bit ignored — bit for bit, plain and CPU wrapper."""
    k = composition
    plan = k["plan"]
    args = (_t(k["x2d"]), _t(plan.xr_bases.astype(np.int32)), _t(k["xr"]),
            k["fill"], plan.exp_panels, NWIN_X)
    got = pk.route_passa_plain(*args, out_rows=XROWS, two_layer=False)
    _exact(got, k["x_ext"])
    assert torch.equal(pk.route_passa(*args, out_rows=XROWS,
                                      two_layer=False), got)
    with pytest.raises(ValueError):        # a two-layer plan is longer
        pk.route_passa(*args, out_rows=XROWS, two_layer=True)


def test_route_expand_matches_pallas(composition):
    """K11: x_ext -> contribution panels, ⊗ by the weights — bit for
    bit."""
    k = composition
    w = None if k["w_stream"] is None else _t(k["w_stream"])
    args = (_t(k["x_ext"]), _t(k["ex"]), w, k["fill"],
            k["plan"].exp_panels, k["mk"])
    got = pk.route_expand_plain(*args)
    _exact(got, k["s0"])
    assert torch.equal(pk.route_expand(*args), got)


def test_fold_stripes_matches_pallas(composition):
    """K12 on stack1: int32 bit for bit, floats within rtol 1e-6."""
    k = composition
    args = (_t(k["stack1"]), k["kind"], k["plan"].fix_panels)
    got = pk.fold_stripes_plain(*args)
    _close(got, k["folded"], 1e-6)
    assert torch.equal(pk.fold_stripes(*args), got)
    if k["dtype"] == np.int32:      # an int32 sum wraps, as the kernels' do
        want = jk.fold_stripes(jnp.asarray(k["stack1"]), "sum",
                               k["plan"].fix_panels, interpret=True)
        _exact(pk.fold_stripes_plain(_t(k["stack1"]), "sum",
                                     k["plan"].fix_panels), want)


def test_colsum_chunks_matches_pallas(composition):
    """K13 into the compact y_mid: int32 bit for bit, f32 within rtol
    1e-5 (f64 1e-12); K12's rows scattered by chunk_dst with ⊕ give the
    same table."""
    k = composition
    args = (_t(k["stack1"]), _t(k["fix_dst"]), k["nblocks"], k["kind"],
            k["fill"])
    got = pk.colsum_chunks_plain(*args)
    _close(got, k["y_mid"], FOLD_RTOL.get(np.dtype(k["dtype"]), 0))
    assert torch.equal(pk.colsum_chunks(*args), got)
    op = {"sum": "sum", "min": "amin"}[k["kind"]]
    rows = _t(k["fix_dst"]).long()[:, None].expand(-1, pk.LANES)
    scattered = torch.full((k["nblocks"], pk.LANES), k["fill"]).to(
        got.dtype).scatter_reduce_(0, rows, _t(k["folded"]), op)
    _close(scattered, k["y_mid"], FOLD_RTOL.get(np.dtype(k["dtype"]), 0))


def _chunk_loop(stack, chunk_dst, nblocks, kind, fill):
    """K13's stated order as an explicit numpy loop: each chunk's 8 rows
    in row order into a part, then each row from ``fill``, its chunks in
    the order given."""
    op = {"sum": np.add, "min": np.minimum, "max": np.maximum}[kind]
    y = np.full((nblocks, pk.LANES), fill, stack.dtype)
    for i, d in enumerate(chunk_dst):
        part = stack[8 * i]
        for q in range(1, STRIPE):
            part = op(part, stack[8 * i + q])
        y[d] = op(y[d], part)
    return y


@pytest.mark.parametrize("dtype,kind", [(np.float32, "sum"),
                                        (np.float64, "sum"),
                                        (np.int32, "min"), (np.int32, "max")])
def test_colsum_chunks_plain_folds_in_ascending_chunk_order(dtype, kind):
    """K13's plain version equals the ascending-chunk numpy loop bit for
    bit: 400 chunks on 3 rows (more than one ``fold_order.GROUP`` run a
    row), on values whose f32 sum the order changes; ``row_lists`` lists
    each row's chunks in that order."""
    rng = np.random.default_rng(13)
    nchunks, nblocks = 400, 3
    dst = rng.integers(0, nblocks, nchunks).astype(np.int32)
    if dtype == np.int32:
        stack = rng.integers(-10**6, 10**6, (nchunks * 8, pk.LANES),
                             dtype=np.int32)
        fill = {"min": np.int32(jsr.INF_I32), "max": np.int32(-2**31)}[kind]
    else:
        stack = (rng.standard_normal((nchunks * 8, pk.LANES))
                 * 10.0 ** rng.uniform(-4, 4, (nchunks * 8, 1))).astype(dtype)
        fill = dtype(0)
    want = _chunk_loop(stack, dst, nblocks, kind, fill)
    got = pk.colsum_chunks_plain(_t(stack), _t(dst), nblocks, kind, fill)
    assert got.numpy().tobytes() == want.tobytes()
    if dtype == np.float32:     # the order shows in the bits
        back = _chunk_loop(stack[::-1].reshape(nchunks, 8, -1)[:, ::-1]
                           .reshape(nchunks * 8, -1), dst[::-1], nblocks,
                           kind, fill)
        assert back.tobytes() != want.tobytes()
    ptr, idx = row_lists(_t(dst), nblocks)
    for d in range(nblocks):
        assert idx[ptr[d]:ptr[d + 1]].tolist() == \
            np.flatnonzero(dst == d).tolist()
    # K13's lists on the card: every row here is past COLSUM_LONG, so all
    # its list positions, in row order, are the long rows' parts
    lptr, lidx, longs, pos = pk.colsum_lists(_t(dst), nblocks)
    assert torch.equal(lptr, ptr) and torch.equal(lidx, idx)
    assert longs.tolist() == [d for d in range(nblocks)
                              if (dst == d).sum() > pk.COLSUM_LONG]
    assert pos.tolist() == list(range(nchunks))
    few = np.repeat(np.arange(nblocks, dtype=np.int32), [1, 40, 2])
    _, _, longs, pos = pk.colsum_lists(_t(few), nblocks)
    assert longs.tolist() == [1] and pos.tolist() == list(range(1, 41))


def _jax_staged(jmeta, x, jsem, dense_len):
    """The staged composition of the Pallas kernels (interpret mode) on the
    JAX package's meta: the same steps as ``spmv3_staged``."""
    a = {k: np.asarray(v[0]) for k, v in jmeta.arrays.items()}
    fill, kind = jsem.identity, jsem.reduce_kind
    nxe = jmeta.exp_panels + 1
    xr_rows = jk.plan_rows(jmeta.xr_nwin * STRIPE, XROWS, False)
    blocks = a["xe_plan"].reshape(nxe, -1, pk.LANES)
    mk = _mul_kind(kind, jmeta.has_w)
    sx = jmeta.sx_rows
    x2d = jnp.full(((sx + STRIPE) * pk.LANES,), fill, jnp.asarray(x).dtype)
    x2d = x2d.at[:x.shape[0]].set(jnp.asarray(x)).reshape(-1, pk.LANES)
    J = jnp.asarray
    x_ext = jk.route_passa(x2d, J(a["xr_bases"]),
                           J(blocks[:, :xr_rows].reshape(-1, pk.LANES)),
                           fill, nxe, jmeta.xr_nwin, interpret=True,
                           out_rows=XROWS, two_layer=False)
    s0 = jk.route_expand(x_ext, J(blocks[:, xr_rows:].reshape(-1, pk.LANES)),
                         J(a["w_stream"]) if jmeta.has_w else None, fill,
                         nxe, mul_kind=mk, interpret=True)
    s1 = jk.route_passa(s0, J(a["pa_bases"]), J(a["pa_plan"]), fill,
                        jmeta.pa_panels + 1, jmeta.pa_nwin, interpret=True)
    stack1 = jk.route_passa(s1, J(a["fixr_bases"]), J(a["fixr_plan"]), fill,
                            jmeta.fix_panels, jmeta.fixr_nwin,
                            interpret=True)
    seg_rows = min(jmeta.nrb, jk.FOLD_SEG_ROWS)
    chunk_dst = (np.repeat(a["fixr_seg"][:jmeta.fix_panels], STRIPE)
                 * seg_rows + a["fix_dst"][:jmeta.fix_panels * STRIPE])
    y_mid = jk.colsum_chunks(stack1, J(chunk_dst.astype(np.int32)),
                             jmeta.nrb, kind, fill, interpret=True)
    y_hub = jk.hub_fold(y_mid, J(a["hub_mask"]), kind, interpret=True)
    y = jk.route_fold(y_hub, J(a["f2_bases"]), J(a["f2_plan"]),
                      J(a["fix2_dst"]), jmeta.f2_rows, kind, fill,
                      jmeta.f2_panels, jmeta.f2_nwin, seg=J(a["f2_seg"]),
                      ini=J(a["f2_ini"]), interpret=True)
    return {"x_ext": x_ext, "s0": s0, "s1": s1, "stack1": stack1,
            "y_mid": y_mid, "y": np.asarray(y).reshape(-1)[:dense_len]}


@pytest.mark.parametrize("case", ["f32_sum", "i32_min_weighted"])
def test_spmv3_staged_matches_jax_staged_and_fused(case):
    dtype, kind, weighted = CASES[case]
    r, c, w = rmat_edges(8, 16, seed=4, weighted=weighted)
    cfg = dict(num_vertices=256, transpose=True)
    jsem = jsr.plus_times() if kind == "sum" else jsr.min_plus()
    tsem = tsr.plus_times() if kind == "sum" else tsr.min_plus()
    g = Graph.from_edges(r, c, w, GraphConfig(**cfg))
    jg = JGraph.from_edges(r, c, w, JGraphConfig(**cfg),
                           mesh=make_mesh(jax.devices()[:1], shape=(1, 1)))
    meta = build_spmv3_meta(g.tiled(), value_dtype=dtype)
    jmeta = jpe.build_spmv3_meta(jg.tiled(), value_dtype=dtype)
    rng = np.random.default_rng(3)
    if kind == "sum":
        x = rng.random(g.part.tile_cols).astype(dtype)
    else:
        x = rng.integers(0, 900, size=g.part.tile_cols).astype(dtype)
        x[rng.random(x.size) < 0.3] = jsem.identity
    n = g.part.tile_rows
    want = _jax_staged(jmeta, x, jsem, n)
    t = staged_tables(meta_from_numpy(meta.arrays, "cpu"), meta)
    st = spmv3_staged_stages(torch.from_numpy(x), t, meta, tsem, n)
    rtol = FOLD_RTOL.get(np.dtype(dtype), 0)
    for k in ("x_ext", "s0", "s1", "stack1"):
        _exact(st[k], want[k])
    for k in ("y_mid", "y"):
        _close(st[k], want[k], rtol)
    fused = spmv3_local(torch.from_numpy(x), t, meta, tsem, n)
    _close(st["y"], fused.numpy(), rtol)
    assert torch.equal(spmv3_staged(torch.from_numpy(x), t, meta, tsem, n),
                       st["y"])
    with pytest.raises(KeyError):          # the tables come from the upload
        spmv3_staged(torch.from_numpy(x), meta_from_numpy(meta.arrays, "cpu"),
                     meta, tsem, n)


def test_ring_times_k13_row_agrees_on_cpu(tmp_path):
    """The device timer's K13 row on the CPU at RMAT-10: the call equals
    its plain version bit for bit and its scatter_reduce within 1e-5 of
    the largest |y|; its list figures count every fixr chunk."""
    from graphtap_tpu_torch.tools import ring_times
    meta = ring_times.load_meta(ring_times.meta_path(str(tmp_path),
                                                     scale=10), scale=10)
    name, kern, plain, lib, nbytes, figs = ring_times.staged_row(meta,
                                                                 "cpu")
    assert name == "colsum_chunks" and nbytes > 0
    ring_times.check(name, kern, plain, lib, ring_times.LIB_RTOL[name])
    assert figs["rows"] == meta.nrb
    assert figs["chunks"] == meta.fix_panels * STRIPE
    assert 1 <= figs["longest_list"] <= figs["chunks"]
