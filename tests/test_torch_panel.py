"""The port's panel pipeline against the JAX package's, on the same plans.

One JAX ``spmv3_local(interpret=True)`` call per case runs the four Pallas
kernels (in interpret mode, as tests/test_panel.py does); each kernel call
is recorded with its inputs. Then

  * each plain torch kernel (what a CPU tensor dispatches to) runs on the
    recorded inputs of its Pallas twin: K1, K2 and K4 bit for bit in f32,
    f64 and int32; K3 bit for bit in int32, within rtol 1e-5 (f32) and
    1e-12 (f64), since a float fold may add in another order;
  * the port's ``spmv3_local`` stages (s0, s1, y_mid, y_hub, y) match the
    JAX stages at the same tolerances (f32 and int32; in f64, with
    weights, K1, K2 and K4 are held to Pallas on the port's own stages);
  * meta carried over from the JAX package (``tools/convert``) gives the
    same y as the port's own meta.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from graphtap_tpu.config import GraphConfig as JGraphConfig
from graphtap_tpu.ingest.graph import Graph as JGraph
from graphtap_tpu.kernels import panel_engine as jpe
from graphtap_tpu.kernels import semiring as jsr
from graphtap_tpu.parallel.layout import make_mesh

from graphtap_tpu_torch import Graph, GraphConfig
from graphtap_tpu_torch.ingest import rmat_edges
from graphtap_tpu_torch.kernels import panel_kernels as pk
from graphtap_tpu_torch.kernels import semiring as tsr
from graphtap_tpu_torch.kernels.panel_engine import (spmv3_local,
                                                     spmv3_stages)
from graphtap_tpu_torch.kernels.panel_meta import build_spmv3_meta
from graphtap_tpu_torch.tools.convert import meta_from_numpy

FOLD_RTOL = {np.dtype(np.float32): 1e-5, np.dtype(np.float64): 1e-12}


def _graph(case):
    """(edges r, c, w, config kwargs, dtype, jax semiring, torch semiring)"""
    if case == "f32_sum_pagerank":
        r, c, w = rmat_edges(10, 16, seed=1)
        return (r, c, None, dict(num_vertices=1024, transpose=True),
                np.float32, jsr.plus_times(), tsr.plus_times())
    # RMAT-12 with weights: skewed rows give hub rows of every code
    r, c, w = rmat_edges(12, 16, seed=2, weighted=True)
    n = 1 << 12
    if case == "f64_sum_weighted":
        return (r, c, w, dict(num_vertices=n, transpose=True), np.float64,
                jsr.plus_times(), tsr.plus_times())
    return (r, c, w, dict(num_vertices=n, transpose=False,
                          parallel_edges=False),
            np.int32, jsr.min_plus(), tsr.min_plus())


def _x(rng, n, dtype, identity):
    if np.issubdtype(dtype, np.floating):
        return rng.random(n).astype(dtype)
    x = rng.integers(0, 3000, size=n).astype(dtype)
    x[rng.random(n) < 0.3] = identity
    return x


def _exact(got, want):
    want = np.asarray(want)
    got = got.numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _fold_close(got, want, dtype):
    if np.issubdtype(dtype, np.floating):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=FOLD_RTOL[np.dtype(dtype)], atol=0)
    else:
        _exact(got, want)


def _run_jax_recording(monkeypatch, x, t, meta, sem, dense_len):
    """JAX spmv3_local in interpret mode, recording every kernel call."""
    calls = []

    def recorder(name, fn):
        def wrapped(*args, **kwargs):
            out = fn(*args, **kwargs)
            calls.append((name, args, kwargs, np.asarray(out)))
            return out
        return wrapped

    for name in ("route_xr_exp", "route_passa", "route_fold", "hub_fold"):
        monkeypatch.setattr(jpe, name, recorder(name, getattr(jpe, name)))
    y = jpe.spmv3_local(jnp.asarray(x), t, meta, sem, dense_len=dense_len,
                        interpret=True, gate=False)
    return np.asarray(y), calls


def _torch(a):
    return torch.from_numpy(np.array(a))


def _setup(case):
    r, c, w, cfg, dtype, jsem, tsem = _graph(case)
    g = Graph.from_edges(r, c, w, GraphConfig(**cfg))
    jg = JGraph.from_edges(r, c, w, JGraphConfig(**cfg),
                           mesh=make_mesh(jax.devices()[:1], shape=(1, 1)))
    jmeta = jpe.build_spmv3_meta(jg.tiled(), value_dtype=dtype)
    meta = build_spmv3_meta(g.tiled(), value_dtype=dtype)
    x = _x(np.random.default_rng(5), g.part.tile_cols, dtype, jsem.identity)
    return g, jmeta, meta, x, dtype, jsem, tsem


@pytest.mark.parametrize("case", ["f32_sum_pagerank", "i32_min_weighted"])
def test_panel_pipeline_matches_pallas(monkeypatch, case):
    g, jmeta, meta, x, dtype, jsem, tsem = _setup(case)
    dense_len = g.part.tile_rows
    jt = {k: jnp.asarray(v[0]) for k, v in jmeta.arrays.items()}
    y_jax, calls = _run_jax_recording(monkeypatch, x, jt, jmeta, jsem,
                                      dense_len)
    names = [cl[0] for cl in calls]
    assert names == ["route_xr_exp", "route_passa", "route_fold",
                     "hub_fold", "route_fold"]
    jstage = dict(zip(["s0", "s1", "y_mid", "y_hub", "y_f2"],
                      [cl[3] for cl in calls]))

    # each plain kernel on its Pallas twin's recorded inputs
    t = meta_from_numpy(meta.arrays, "cpu")
    fill, kind = tsem.identity, tsem.reduce_kind
    (_, a1, k1, out1), (_, a2, _, out2), (_, a3, _, out3), \
        (_, a4, _, out4), (_, a5, _, out5) = calls
    _exact(pk.route_xr_exp_plain(_torch(a1[0]), t["xr_bases"], t["xe_plan"],
                                 t.get("w_stream"), fill,
                                 meta.exp_panels + 1, meta.xr_nwin,
                                 k1["mul_kind"]), out1)
    _exact(pk.route_passa_plain(_torch(a2[0]), t["pa_bases"], t["pa_plan"],
                                fill, meta.pa_panels + 1, meta.pa_nwin),
           out2)
    _fold_close(pk.route_fold_plain(
        _torch(a3[0]), t["fixr_bases"], t["fixr_plan"], t["fix_dst"],
        t["fixr_seg"], meta.nrb, kind, fill, meta.fix_panels,
        meta.fixr_nwin), out3, dtype)
    hub_in = _torch(a4[0])
    _exact(pk.hub_fold_plain(hub_in, t["hub_mask"], kind), out4)
    _fold_close(pk.route_fold_plain(
        _torch(a5[0]), t["f2_bases"], t["f2_plan"], t["fix2_dst"],
        t["f2_seg"], meta.f2_rows, kind, fill, meta.f2_panels,
        meta.f2_nwin), out5, dtype)
    # the wrappers take the plain versions for CPU tensors and launch
    # nothing (LAUNCHES counts CUDA launches only)
    before = dict(pk.LAUNCHES)
    _exact(pk.hub_fold(hub_in, t["hub_mask"], kind), out4)

    # the port's own chain, stage by stage
    st = spmv3_stages(_torch(x), t, meta, tsem, dense_len)
    assert pk.LAUNCHES == before
    _exact(st["s0"], jstage["s0"])
    _exact(st["s1"], jstage["s1"])
    _fold_close(st["y_mid"], jstage["y_mid"], dtype)
    _fold_close(st["y_hub"], jstage["y_hub"], dtype)
    _fold_close(st["y"], y_jax, dtype)

    # meta carried over from the JAX package gives the same y
    y_conv = spmv3_local(_torch(x), meta_from_numpy(jmeta.arrays, "cpu"),
                         meta, tsem, dense_len)
    assert torch.equal(y_conv, st["y"])


def test_panel_kernels_f64_match_pallas():
    """f64 with weights (the ⊗ = mul path): K1, K2 and K4 bit for bit
    against their Pallas twins on the port's own stage inputs."""
    from graphtap_tpu.kernels import panel_kernels as jpk
    g, jmeta, meta, x, dtype, jsem, tsem = _setup("f64_sum_weighted")
    assert meta.has_w
    t = meta_from_numpy(meta.arrays, "cpu")
    jt = {k: jnp.asarray(v[0]) for k, v in jmeta.arrays.items()}
    st = spmv3_stages(_torch(x), t, meta, tsem, g.part.tile_rows)
    s0 = jpk.route_xr_exp(jnp.asarray(st["x2d"].numpy()), jt["xr_bases"],
                          jt["xe_plan"], jt["w_stream"], np.float64(0),
                          meta.exp_panels + 1, meta.xr_nwin,
                          mul_kind="mul", interpret=True)
    _exact(st["s0"], s0)
    s1 = jpk.route_passa(s0, jt["pa_bases"], jt["pa_plan"], np.float64(0),
                         meta.pa_panels + 1, meta.pa_nwin, interpret=True)
    _exact(st["s1"], s1)
    hub = jpk.hub_fold(jnp.asarray(st["y_mid"].numpy()), jt["hub_mask"],
                       "sum", interpret=True)
    assert len(np.unique(meta.arrays["hub_mask"])) >= 3     # hub rows
    _exact(st["y_hub"], hub)


@pytest.mark.parametrize("dtype,kind", [(np.float32, "sum"),
                                        (np.float64, "sum"),
                                        (np.int32, "min"), (np.int32, "max")])
def test_hub_fold_plain_matches_pallas(dtype, kind):
    """K4 on random rows of every hub code, bit for bit."""
    from graphtap_tpu.kernels import panel_kernels as jpk
    rng = np.random.default_rng(9)
    nrows = 64
    if np.issubdtype(dtype, np.floating):
        v = rng.standard_normal((nrows, 128)).astype(dtype)
    else:
        v = rng.integers(-1000, 1000, size=(nrows, 128)).astype(dtype)
    hm = np.repeat(rng.choice(np.array([0, 32, 64, 128], np.uint8), nrows),
                   128).reshape(nrows, 128)
    want = jpk.hub_fold(jnp.asarray(v), jnp.asarray(hm), kind,
                        interpret=True)
    _exact(pk.hub_fold(torch.from_numpy(v), torch.from_numpy(hm), kind),
           want)


def test_wrappers_validate_inputs():
    r, c, _ = rmat_edges(8, 16, seed=1)
    g = Graph.from_edges(r, c, None, GraphConfig(num_vertices=256,
                                                 transpose=True))
    meta = build_spmv3_meta(g.tiled(), np.float32)
    t = meta_from_numpy(meta.arrays, "cpu")
    s0 = torch.zeros(((meta.exp_panels + 1) * 64, 128))
    args = (t["pa_bases"], t["pa_plan"], 0.0, meta.pa_panels + 1,
            meta.pa_nwin)
    with pytest.raises(TypeError):                       # dtype
        pk.route_passa(s0.to(torch.float16), *args)
    with pytest.raises(ValueError):                      # contiguity
        pk.route_passa(s0.t().contiguous().t(), *args)
    with pytest.raises(TypeError):                       # index dtype
        pk.route_passa(s0, t["pa_bases"].long(), *args[1:])
    with pytest.raises(ValueError):                      # short plan
        pk.route_passa(s0, t["pa_bases"], t["pa_plan"][:64], *args[2:])
    # two plan blocks of nwin 90 exceed a block's shared memory on the card
    with pytest.raises(ValueError, match="232448 bytes of shared memory"):
        pk.route_passa(s0, torch.zeros(90, dtype=torch.int32),
                       torch.zeros((pk.plan_rows(720), 128),
                                   dtype=torch.uint8), 0.0, 1, 90)
    with pytest.raises(ValueError):                      # ⊕ kind
        pk.hub_fold(torch.zeros((meta.nrb, 128)), t["hub_mask"], "min")
    # K1: two plan blocks of nwin 70 and the f32 x_ext panel, and K3: one
    # plan block of nwin 203, exceed a block's shared memory on the card
    with pytest.raises(ValueError, match="232448 bytes of shared memory"):
        pk.route_xr_exp(torch.zeros((8, 128)),
                        torch.zeros(70, dtype=torch.int32),
                        torch.zeros((pk.xe_plan_rows(70), 128),
                                    dtype=torch.uint8), None, 0.0, 1, 70)
    with pytest.raises(ValueError, match="232448 bytes of shared memory"):
        pk.route_fold(s0, torch.zeros(203, dtype=torch.int32),
                      torch.zeros((pk.plan_rows(203 * 8), 128),
                                  dtype=torch.uint8),
                      torch.zeros(8, dtype=torch.int32),
                      torch.zeros(1, dtype=torch.int32), 64, "sum", 0.0, 1,
                      203)


@pytest.mark.parametrize("two_layer,itemsize", [(True, 4), (True, 8),
                                                (False, 4), (False, 8)])
def test_passa_form_follows_its_rule(two_layer, itemsize):
    """K2's form on the card: 'staged' while two stages of plan block +
    nwin source windows (+ an 8-byte mbarrier each) fit the 232,448 bytes
    a block may have, 'unstaged' while two plan blocks do, else a raise;
    and where the repo's routes land."""
    out_rows = pk.PROWS if two_layer else pk.XROWS
    forms = {}
    for nwin in range(1, 120):
        plan = pk.plan_rows(nwin * 8, out_rows, two_layer) * 128
        win = nwin * 8 * 128 * itemsize
        want = ("staged" if nwin <= 32 and 2 * (plan + win + 8) <= 232448
                else "unstaged" if 2 * (plan + 8) <= 232448 else None)
        if want is None:
            with pytest.raises(ValueError, match="nwin"):
                pk.passa_form(nwin, out_rows, two_layer, itemsize)
        else:
            assert pk.passa_form(nwin, out_rows, two_layer, itemsize) == want
        forms[nwin] = want
    last = {f: max(n for n, g in forms.items() if g == f)
            for f in ("staged", "unstaged")}
    assert last == {(True, 4): {"staged": 17, "unstaged": 89},
                    (True, 8): {"staged": 9, "unstaged": 89},
                    (False, 4): {"staged": 21, "unstaged": 105},
                    (False, 8): {"staged": 11, "unstaged": 105}}[
        (two_layer, itemsize)]
    # the corner turn (nwin 12) stages its windows in f32 and int32; the
    # x -> x_ext route at nwin 24 reads them from device memory
    assert forms[12] == ("staged" if two_layer and itemsize == 4 else
                         "unstaged" if two_layer else
                         "staged" if itemsize == 4 else "unstaged")
    assert forms[24] == "unstaged"


@pytest.mark.parametrize("kernel,itemsize", [("route_xr_exp", 4),
                                             ("route_xr_exp", 8),
                                             ("route_fold", 4),
                                             ("route_expand", 4),
                                             ("route_expand", 8)])
def test_ring_footprint_follows_its_rule(kernel, itemsize):
    """K1's, K3's and K11's plan rings on the card: K1 holds two plan
    blocks (an 8-byte mbarrier each) and its 32x128 x_ext panel, K3 two
    plan blocks while they fit the 232,448 bytes a block may have and one
    after, and asks for at least 116 KB; past that each raises. K11 holds
    two stages of an expand plan block (224 rows) and the panel's x_ext
    block, whatever the meta's nwin (the blocks an SM that gives are
    checked on the card). And where the repo's routes land."""
    if kernel == "route_expand":
        stage = pk.plan_rows(32) * 128 + 32 * 128 * itemsize
        assert stage == {4: 45056, 8: 61440}[itemsize]
        assert pk.expand_smem(itemsize) == 2 * (stage + 8) == {
            4: 90128, 8: 122896}[itemsize]
        return
    fits = {}
    for nwin in range(1, 260):
        if kernel == "route_xr_exp":
            want = (2 * (pk.xe_plan_rows(nwin) * 128 + 8)
                    + 32 * 128 * itemsize)
            want = want if want <= 232448 else None
            got = lambda: pk.xr_exp_smem(nwin, itemsize)  # noqa: E731
        else:
            plan = pk.plan_rows(nwin * 8) * 128 + 8
            want = 2 if 2 * plan <= 232448 else 1 if plan <= 232448 else None
            got = lambda: pk.fold_stages(nwin)  # noqa: E731
        if want is None:
            with pytest.raises(ValueError, match="nwin"):
                got()
        else:
            assert got() == want
        fits[nwin] = want
    last = max(n for n, v in fits.items() if v is not None)
    assert all(fits[n] is not None for n in range(1, last + 1))
    if kernel == "route_xr_exp":
        assert last == {4: 69, 8: 61}[itemsize]
        assert fits[24] == {4: 139280, 8: 155664}[itemsize]   # every meta
    else:
        assert last == 202
        assert max(n for n, v in fits.items() if v == 2) == 89
        assert fits[31] == fits[28] == 2         # RMAT-20's fixr and fix2
        # at least 116 KB, so one block runs an SM
        assert pk.fold_smem(31) == 118784
        assert pk.fold_smem(89) == 2 * (pk.plan_rows(712) * 128 + 8)
        assert pk.fold_smem(202) == pk.plan_rows(1616) * 128 + 8
