"""The device-memory probes P1-P3 on the CPU: the port's plain versions
against the JAX package's Pallas probes in interpret mode.

``tools_dev/bw_probe.py`` and ``tools_dev/route_cost_probe.py`` are loaded
from their paths as private module copies; in each copy only, ``pl`` is a
namespace whose ``pallas_call`` runs in interpret mode, ``TARGET_BYTES``
is 1 MB, and ``_time`` keeps the output the probe would only time. The
port's ``copy_1d``, ``copy_2d`` and ``multi_stream_sum`` (their plain
versions, on the CPU) must return the same arrays, bit for bit. The TPU
``route_like`` gives ``nwin`` in_specs but passes its table once, which
Pallas rejects; the test calls ``_body`` through a ``pallas_call`` with the
same specs and the table passed ``nwin`` times, and the port's
``route_like`` (which takes the table once) must equal it bit for bit,
its library form within f32 rounding. The CUDA kernels are held against
the same plain versions on the card (``tests/test_torch_cuda.py``).
"""

import functools
import importlib.util
import os
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from graphtap_tpu_torch.tools import bw_probe, route_cost_probe

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = 1 << 20


def _probe(name):
    """A private copy of tools_dev/<name>.py: interpret-mode pallas_call,
    TARGET_BYTES = 1 MB, and the outputs its ``_time`` sees."""
    spec = importlib.util.spec_from_file_location(
        f"_tpu_{name}", os.path.join(REPO, "tools_dev", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.pl = types.SimpleNamespace(**{
        **vars(pl), "pallas_call": functools.partial(pl.pallas_call,
                                                     interpret=True)})
    mod.TARGET_BYTES = SMALL
    outs = []

    def keep(fn, *args):
        out = fn(*args)
        jax.block_until_ready(out)
        outs.append(np.asarray(out))
        return 1.0
    mod._time = keep
    return mod, outs


@pytest.mark.parametrize("rows_per_block,dtype", [
    (8, "float32"), (64, "float32"), (64, "int8")])
def test_copy_1d_matches_pallas(rows_per_block, dtype):
    mod, outs = _probe("bw_probe")
    assert mod.copy_1d(rows_per_block, 1024, getattr(jnp, dtype)) > 0
    got, rate = bw_probe.copy_1d(rows_per_block, 1024, getattr(torch, dtype),
                                 device="cpu", target_bytes=SMALL)
    assert rate is None                  # no device rate from a CPU run
    np.testing.assert_array_equal(got.numpy(), outs[-1])
    assert got.dtype == getattr(torch, dtype)


@pytest.mark.parametrize("bm,bn", [(8, 128), (32, 1024)])
def test_copy_2d_matches_pallas(bm, bn):
    mod, outs = _probe("bw_probe")
    mod.copy_2d(bm, bn)
    got, _ = bw_probe.copy_2d(bm, bn, device="cpu", target_bytes=SMALL)
    assert got.shape == (SMALL // (8192 * 4) // bm * bm, 8192)
    np.testing.assert_array_equal(got.numpy(), outs[-1])


@pytest.mark.parametrize("nstreams", [2, 4])
def test_multi_stream_sum_matches_pallas(nstreams):
    mod, outs = _probe("bw_probe")
    mod.multi_stream_sum(nstreams)
    got, _ = bw_probe.multi_stream_sum(nstreams, device="cpu",
                                       target_bytes=SMALL)
    np.testing.assert_array_equal(got.numpy(), outs[-1])
    # stream i holds i + 1; the chain adds streams 1.. NCHAIN - 1 more times
    assert float(got[0, 0]) == 1 + bw_probe.NCHAIN * sum(
        range(2, nstreams + 1))


def _jax_route_like(mod, x2d, bases, npanels, nwin):
    """``route_like`` with its specs, the table passed nwin times."""
    def spec(t):
        return pl.BlockSpec((mod.STRIPE, mod.LANES),
                            lambda i, b, t=t: (b[i * nwin + t], 0))
    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=1, grid=(npanels,),
        in_specs=[spec(t) for t in range(nwin)],
        out_specs=pl.BlockSpec((mod.PROWS, mod.LANES), lambda i, b: (i, 0)))
    return pl.pallas_call(
        functools.partial(mod._body, nwin), grid_spec=grid_spec,
        out_shape=jax.ShapeDtypeStruct((npanels * mod.PROWS, mod.LANES),
                                       x2d.dtype),
        interpret=True)(bases, *([x2d] * nwin))


@pytest.mark.parametrize("nwin", [1, 4, 12])
def test_route_like_matches_pallas(nwin):
    mod, _ = _probe("route_cost_probe")
    rng = np.random.default_rng(nwin)
    nblk, npanels = 64, 6
    x = rng.standard_normal((nblk * 8, 128)).astype(np.float32)
    b = rng.integers(0, nblk, size=npanels * nwin).astype(np.int32)
    want = np.asarray(_jax_route_like(mod, jnp.asarray(x), jnp.asarray(b),
                                      npanels, nwin))
    tx, tb = torch.from_numpy(x), torch.from_numpy(b)
    got = route_cost_probe.route_like(tx, tb, npanels, nwin)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_allclose(
        route_cost_probe.route_like_library(tx, tb, npanels, nwin).numpy(),
        want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mode", ["same", "random"])
def test_route_like_measure_inputs(mode):
    """The measurement's inputs: a table of ones and all-0 or seeded
    random bases, so every output slot is nwin."""
    x, b = route_cost_probe.make_inputs(32, 20, mode, device="cpu")
    assert x.shape == (route_cost_probe.XBLOCKS * 8, 128)
    assert (int(b.max()) == 0) == (mode == "same")
    out = route_cost_probe.route_like(x, b, 32, 20)
    assert out.shape == (32 * 64, 128) and bool(torch.all(out == 20))


def test_probe_wrappers_reject_bad_inputs():
    x = torch.ones((16, 1024))
    with pytest.raises(ValueError):
        bw_probe.copy_blocks(x, 3, 1024)             # rows not whole tiles
    with pytest.raises(ValueError):
        bw_probe.copy_blocks(torch.ones((16, 6)), 8, 2)   # 8-byte rows
    with pytest.raises(ValueError):
        bw_probe.stream_sum([x, x, x])
    with pytest.raises(ValueError):
        bw_probe.stream_sum([x, x.double()])
    t = torch.ones((64, 128))
    with pytest.raises(ValueError):
        route_cost_probe.route_like(t, torch.tensor([0, 8], dtype=torch.int32),
                                    1, 2)              # base past the table
    with pytest.raises(ValueError):
        route_cost_probe.route_like(t, torch.zeros(3, dtype=torch.int32), 1,
                                    2)                 # wrong base count
    assert bw_probe.LAUNCHES == {"copy_blocks": 0, "stream_sum": 0}
    assert route_cost_probe.LAUNCHES == {"route_like": 0}


def test_route_like_checks_bases_once_per_version():
    """A bases tensor checked once is not read back again until it is
    written: a base moved past the table then raises."""
    t = torch.ones((64, 128))
    b = torch.zeros(2, dtype=torch.int32)
    assert route_cost_probe.route_like(t, b, 1, 2).shape == (64, 128)
    route_cost_probe.route_like(t, b, 1, 2)
    b[1] = 8
    with pytest.raises(ValueError):
        route_cost_probe.route_like(t, b, 1, 2)
    with pytest.raises(ValueError):
        route_cost_probe.route_like(t[:32], torch.tensor(
            [0, 4], dtype=torch.int32), 1, 2)


def _table_shapes():
    """(rows, cols, itemsize, bm, bn) of every P1 row of the probe's quick
    and full tables (``bw_probe.table``), at the probe's TARGET_BYTES."""
    return sorted({(*shape, torch.empty((), dtype=dt).element_size(), bm, bn)
                   for quick in (True, False)
                   for _, shape, dt, bm, bn, _ in bw_probe.copy_shapes(quick)})


# the card tests' shapes (tests/test_torch_cuda.py): 16-byte segments, a
# tile taller than a chunk, fewer tiles than SMs, one tile, a segment wider
# than a chunk, in int8 and f32
_CARD_SHAPES = [(512, 1024, 4, 8, 1024), (512, 1024, 4, 64, 128),
                (512, 1024, 4, 256, 512), (512, 1024, 1, 64, 16),
                (512, 1024, 4, 512, 4), (512, 1024, 4, 256, 1024),
                (512, 1024, 1, 512, 1024), (512, 1024, 4, 512, 1024),
                (16, 16384, 4, 16, 16384), (24, 12288, 4, 8, 12288)]


@pytest.mark.parametrize("rows,cols,itemsize,bm,bn",
                         _table_shapes() + _CARD_SHAPES)
def test_copy_chunks_follow_their_rule(rows, cols, itemsize, bm, bn):
    """P1's chunks (``copy_chunks``), walked as the kernel walks a tile:
    each chunk is whole row segments of one tile, or one piece of one row
    where a segment is wider than a chunk, in 16-byte multiples; it fits
    CHUNK_BYTES, and the chunks cover each tile in order, each byte
    once."""
    seg = bn * itemsize
    ch = bw_probe.copy_chunks(rows, cols * itemsize, bm, seg)
    assert ch.piece_bytes % 16 == 0
    assert ch.chunk_rows * ch.piece_bytes <= bw_probe.CHUNK_BYTES
    end = 0                      # bytes of the tile covered, row-major
    for rc in range(-(-bm // ch.chunk_rows)):
        r0 = rc * ch.chunk_rows
        nr = min(ch.chunk_rows, bm - r0)
        for pc in range(ch.pieces):
            b0 = pc * ch.piece_bytes
            nb = min(ch.piece_bytes, seg - b0)
            assert nb > 0 and nb % 16 == 0
            assert (b0, nb) == (0, seg) if ch.pieces == 1 else nr == 1
            assert r0 * seg + b0 == end
            end += nr * nb
    assert end == bm * seg
    if seg <= bw_probe.CHUNK_BYTES:      # the most whole rows a chunk holds
        assert ch.chunk_rows == min(bm, bw_probe.CHUNK_BYTES // seg)


def test_copy_chunks_reject_what_copy_blocks_rejects():
    for args in ((16, 4096, 3, 4096), (16, 24, 8, 8), (16, 4096, 8, 24)):
        with pytest.raises(ValueError, match="copy_chunks"):
            bw_probe.copy_chunks(*args)
