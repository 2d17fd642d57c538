"""The port's semirings and portable SpMV against the JAX package's, on
random tiles, for sum, min and max. Int results are exact; f64 sums agree
within rtol 1e-12 (the port reduces in another order than the scan)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from graphtap_tpu.kernels import semiring as jsr
from graphtap_tpu.kernels import spmv as jspmv

from graphtap_tpu_torch.format.tiles import build_tileset
from graphtap_tpu_torch.kernels import semiring as tsr
from graphtap_tpu_torch.kernels import spmv as tspmv
from graphtap_tpu_torch.parallel.layout import Partition

INT_MIN = -2147483648


def _max_semirings():
    """A (max, +w, INT_MIN) semiring in both packages (no app uses one;
    it exercises the 'max' fold)."""
    j = jsr.Semiring(name="max_plus", add=jnp.maximum,
                     mul=lambda x, w: x if w is None else x + w,
                     identity=INT_MIN, reduce_kind="max")
    t = tsr.Semiring(name="max_plus", add=torch.maximum,
                     mul=lambda x, w: x if w is None else x + w,
                     identity=INT_MIN, reduce_kind="max")
    return j, t


def _case(kind):
    """(jax semiring, torch semiring, numpy value dtype, weighted)."""
    if kind == "sum":
        return jsr.plus_times(), tsr.plus_times(), np.float64, True
    if kind == "sum_f32":
        return jsr.plus_times(), tsr.plus_times(), np.float32, False
    if kind == "min":
        return jsr.min_plus(), tsr.min_plus(), np.int32, True
    if kind == "min_select":
        return jsr.min_select(), tsr.min_select(), np.int32, False
    j, t = _max_semirings()
    return j, t, np.int32, True


def _tiles(seed, weighted, n=1500, e=6000):
    rng = np.random.default_rng(seed)
    r = rng.integers(0, n, size=e)
    c = rng.integers(0, n, size=e)
    c[rng.random(e) < 0.2] = rng.integers(0, 8)       # a few hub columns
    w = rng.integers(1, 100, size=e).astype(np.int32) if weighted else None
    return build_tileset(r, c, w, Partition.build(n, 1, 1)), rng


def _x(rng, n, dtype, identity):
    if np.issubdtype(dtype, np.floating):
        return rng.random(n).astype(dtype)
    x = rng.integers(0, 5000, size=n).astype(dtype)
    x[rng.random(n) < 0.25] = identity                 # inactive sources
    return x


def _check(got, want, dtype):
    got, want = got.numpy(), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    if np.issubdtype(dtype, np.floating):
        rtol = 1e-12 if dtype == np.float64 else 1e-5
        np.testing.assert_allclose(got, want, rtol=rtol, atol=0)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ["sum", "sum_f32", "min", "min_select",
                                  "max"])
def test_spmv_functions_match_jax(kind):
    jsem, tsem, dtype, weighted = _case(kind)
    ts, rng = _tiles(seed=len(kind), weighted=weighted)
    n = int(ts.nnz[0, 0])
    x = _x(rng, ts.part.tile_cols, dtype, jsem.identity)
    rows, cols, ja = ts.rows[0], ts.cols[0], ts.ja[0]
    w = ts.weights[0] if weighted else None
    jw = None if w is None else jnp.asarray(w)
    tw = None if w is None else torch.from_numpy(w)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    jr, jc = jnp.asarray(rows), jnp.asarray(cols)
    tr, tc = torch.from_numpy(rows), torch.from_numpy(cols)

    jn = jnp.int32(n)
    _check(tspmv.edge_contributions(tx, tc, tw, n, tsem),
           jax.jit(lambda *a: jspmv.edge_contributions(*a, jsem))(
               jx, jc, jw, jn), dtype)
    y_seg = tspmv.spmv_segment(tx, tr, tc, tw, n, ts.NR, tsem)
    _check(y_seg, jax.jit(lambda *a: jspmv.spmv_segment(*a, ts.NR, jsem))(
        jx, jr, jc, jw, jn), dtype)
    y_scan = tspmv.spmv_sorted_scan(tx, tr, tc, tw, n,
                                    torch.from_numpy(ja), tsem)
    _check(y_scan, jax.jit(lambda *a: jspmv.spmv_sorted_scan(*a, jsem))(
        jx, jr, jc, jw, jn, jnp.asarray(ja)), dtype)
    iv = ts.iv_dense[0]
    _check(tspmv.expand_compact(y_scan, torch.from_numpy(iv), tsem),
           jspmv.expand_compact(jnp.asarray(y_scan.numpy()),
                                jnp.asarray(iv), jsem), dtype)


@pytest.mark.parametrize("kind", ["sum", "min", "max"])
def test_spmv_dense_reference_matches_jax(kind):
    jsem, tsem, dtype, weighted = _case(kind)
    ts, rng = _tiles(seed=7, weighted=weighted, n=300, e=900)
    n = int(ts.nnz[0, 0])
    x = _x(rng, ts.part.tile_cols, dtype, jsem.identity)
    w = ts.weights[0] if weighted else None
    got = tspmv.spmv_dense_reference(
        torch.from_numpy(x), torch.from_numpy(ts.rows[0]),
        torch.from_numpy(ts.cols[0]),
        None if w is None else torch.from_numpy(w), n, ts.NR, tsem)
    want = jspmv.spmv_dense_reference(
        jnp.asarray(x), jnp.asarray(ts.rows[0]), jnp.asarray(ts.cols[0]),
        None if w is None else jnp.asarray(w), jnp.int32(n), ts.NR, jsem)
    _check(got, want, dtype)


@pytest.mark.parametrize("name", ["plus_times", "min_plus", "min_select"])
def test_semiring_ops_match_jax(name):
    jsem, tsem = getattr(jsr, name)(), getattr(tsr, name)()
    assert (tsem.identity, tsem.reduce_kind) == \
        (jsem.identity, jsem.reduce_kind)
    rng = np.random.default_rng(3)
    if name == "plus_times":
        a = rng.random(64)
        b = rng.random(64)
        w = rng.integers(1, 9, size=64).astype(np.int32)
    else:
        a = rng.integers(0, 1 << 30, size=64).astype(np.int32)
        a[::5] = tsr.INF_I32                     # the INF guard of ⊗
        a[1::5] = tsr.INF_I32 - 3                # below INF: plain add
        b = rng.integers(0, 1 << 30, size=64).astype(np.int32)
        w = rng.integers(1, 129, size=64).astype(np.int32)
    ta, tb, tw = map(torch.from_numpy, (a, b, w))
    ja, jb, jw = map(jnp.asarray, (a, b, w))
    np.testing.assert_array_equal(tsem.add(ta, tb).numpy(),
                                  np.asarray(jsem.add(ja, jb)))
    np.testing.assert_array_equal(tsem.mul(ta, tw).numpy(),
                                  np.asarray(jsem.mul(ja, jw)))
    np.testing.assert_array_equal(tsem.mul(ta, None).numpy(), a)
    _check(tsem.axis_reduce(ta.view(8, 8), 1),
           jsem.axis_reduce(ja.reshape(8, 8), 1), a.dtype)
    seg = np.sort(rng.integers(0, 10, size=64))
    _check(tsem.segment_reduce(ta, torch.from_numpy(seg), 12),
           jsem.segment_reduce(ja, jnp.asarray(seg), 12), a.dtype)
