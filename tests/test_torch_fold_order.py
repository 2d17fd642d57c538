"""The fixed fold order of K3, K5 and K8 (kernels/fold_order.py) on the
CPU, against sequential numpy folds written out here: the lists of pass
(b) in runs of GROUP, ``ordered_fold`` (the one-call CPU form and the
rank-stepped form the card uses give the same bits), ``list_fold``'s two
levels, and K5's and K8's plain versions as a whole. The CUDA kernels are
held against these plain versions bit for bit on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``)."""

import numpy as np
import pytest
import torch

from graphtap_tpu_torch.kernels import fold_order as fo
from graphtap_tpu_torch.kernels import onehot_spmv as oh
from graphtap_tpu_torch.kernels import shuffle_kernels as sk

OPS = {"sum": lambda a, b: a + b, "min": min, "max": max}
IDENT = {"sum": 0.0, "min": np.inf, "max": -np.inf}


def _seq(vals, kind, ident):
    """ident ⊕ v0 ⊕ v1 ⊕ ..., one numpy scalar at a time, in order."""
    acc = vals.dtype.type(ident)
    for v in vals:
        acc = vals.dtype.type(OPS[kind](acc, v))
    return acc


def _targets(rng, n, nrows):
    """Targets with one hub row (several runs long) among sparse ones."""
    t = rng.integers(0, nrows, n)
    t[rng.random(n) < 0.4] = 3
    return t


@pytest.mark.parametrize("n,nrows", [(0, 5), (7, 5), (600, 40)])
def test_fold_lists_cut_each_row_into_runs(n, nrows):
    t = _targets(np.random.default_rng(n), n, nrows)
    rptr, gptr, idx = (a.numpy() for a in fo.fold_lists(torch.from_numpy(t),
                                                          nrows))
    assert rptr.dtype == gptr.dtype == idx.dtype == np.int32
    assert list(idx) == sorted(range(n), key=lambda i: (t[i], i))
    for r in range(nrows):
        runs = [idx[gptr[g]:gptr[g + 1]] for g in range(rptr[r], rptr[r + 1])]
        assert [len(x) for x in runs[:-1]] == [fo.GROUP] * (len(runs) - 1)
        assert [i for x in runs for i in x] == [i for i in range(n)
                                                if t[i] == r]
    with pytest.raises(ValueError):
        fo.fold_lists(torch.tensor([0, nrows]), nrows)


@pytest.mark.parametrize("kind", ["sum", "min", "max"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_ordered_fold_is_sequential_on_both_paths(kind, dtype):
    rng = np.random.default_rng(1)
    v = (rng.standard_normal((500, 3)) * 1e3).astype(dtype)
    s = _targets(rng, 500, 30)
    want = np.stack([[_seq(v[s == r, j], kind, IDENT[kind])
                      for j in range(3)] for r in range(30)])
    tv, ts = torch.from_numpy(v), torch.from_numpy(s)
    got = fo.ordered_fold(tv, ts, 30, kind, IDENT[kind])
    np.testing.assert_array_equal(got.numpy(), want)
    out = torch.full((30, 3), IDENT[kind], dtype=tv.dtype)
    stepped = fo._fold_by_rank(out, tv, ts, torch.sort(ts, stable=True)
                               .indices, kind)
    assert torch.equal(stepped, got)


@pytest.mark.parametrize("kind", ["sum", "max"])
def test_list_fold_two_levels(kind):
    rng = np.random.default_rng(2)
    v = (rng.standard_normal((700, 2)) * 1e4).astype(np.float32)
    t = _targets(rng, 700, 9)
    got = fo.list_fold(torch.from_numpy(v), torch.from_numpy(t), 9, kind,
                       IDENT[kind]).numpy()
    for r in range(9):
        rows = v[t == r]
        for j in range(2):
            runs = [_seq(rows[k:k + fo.GROUP, j], kind, IDENT[kind])
                    for k in range(0, len(rows), fo.GROUP)]
            want = _seq(np.array(runs, np.float32), kind, IDENT[kind])
            assert got[r, j] == want, (r, j)
    assert (t == 3).sum() > 3 * fo.GROUP       # the hub row has 4+ runs


def test_k5_k8_plain_folds_in_the_kernels_order():
    """K5 and K8's plain versions: each chunk's lanes folded in index
    order (K8 skipping slots whose ev is 0), then each block's chunk
    partials by list_fold."""
    rng = np.random.default_rng(3)
    nchunks, nblocks = 40, 5
    cb = np.sort(rng.integers(0, nblocks, nchunks)).astype(np.int32)
    cb[:25] = 2                                  # a block of 25 chunks
    c = rng.standard_normal(nchunks * oh.CHUNK).astype(np.float32)
    lr = rng.integers(0, 128, nchunks * oh.CHUNK).astype(np.int32)
    lr[:3000] = 7
    part = np.zeros((nchunks, 128), np.float32)
    for i in range(nchunks):
        for lane in range(128):
            sel = lr[i * oh.CHUNK:(i + 1) * oh.CHUNK] == lane
            part[i, lane] = _seq(c[i * oh.CHUNK:(i + 1) * oh.CHUNK][sel],
                                 "sum", 0.0)
    want = fo.list_fold(torch.from_numpy(part), torch.from_numpy(cb),
                        nblocks, "sum", 0.0)
    got = oh.segment_reduce_plain(torch.from_numpy(c), torch.from_numpy(lr),
                                  torch.from_numpy(cb), nblocks,
                                  nblocks * 128, "sum", 0.0)
    assert torch.equal(got, want.reshape(-1))
    # K8: 8-row chunks of 1024 slots, ev masking
    n8 = nchunks * 1024
    ev = (rng.random(n8) < 0.7).astype(np.int8)
    lr8 = lr[:n8].astype(np.int8)
    part8 = np.zeros((nchunks, 128), np.float32)
    for i in range(nchunks):
        sl = slice(i * 1024, (i + 1) * 1024)
        for lane in range(128):
            sel = (lr8[sl] == lane) & (ev[sl] != 0)
            part8[i, lane] = _seq(c[:n8][sl][sel], "sum", 0.0)
    want8 = fo.list_fold(torch.from_numpy(part8), torch.from_numpy(cb),
                         nblocks, "sum", 0.0)
    got8 = sk.grouped_reduce_plain(
        torch.from_numpy(c[:n8]).view(-1, 128),
        torch.from_numpy(lr8).view(-1, 128),
        torch.from_numpy(ev).view(-1, 128), torch.from_numpy(cb), nblocks,
        "sum", 0.0)
    assert torch.equal(got8, want8)


def test_fold_tables_kept_once_per_upload():
    cb = torch.tensor([0, 0, 2, 1, 2], dtype=torch.int32)
    t = {}
    a = fo.fold_tables(t, "oh", cb, 3, 5, torch.float32)
    b = fo.fold_tables(t, "oh", cb, 3, 5, torch.float32)
    assert all(x is y for x, y in zip(a["lists"], b["lists"]))
    assert a["scratch"][0] is b["scratch"][0]
    assert [tuple(x.shape) for x in a["scratch"]] == [(5, 128), (3, 128)]
    c = fo.fold_tables(t, "oh", cb, 3, 5, torch.float64)
    assert c["scratch"][0].dtype == torch.float64
    assert sorted(t) == ["oh_fgpart", "oh_fgptr", "oh_fidx", "oh_fpart",
                         "oh_frptr"]
