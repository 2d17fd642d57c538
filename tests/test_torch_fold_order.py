"""The fixed fold order of K3, K5 and K8 (kernels/fold_order.py) on the
CPU, against sequential numpy folds written out here: the lists of pass
(b) in runs of GROUP, ``ordered_fold`` (the one-call CPU form and the
rank-stepped form the card uses give the same bits), ``list_fold``'s two
levels, K5's and K8's chunk lists (K8's without the chunks that hold no
valid slot, a null item for a row block left with none), and K5's and
K8's plain versions as a whole, whose pass (a) folds each lane in runs
of RUN and then the runs' results: on one-lane chunks, a sorted K5 chunk
ending in a padding tail, an all-padding chunk and K8 chunks with
all-invalid 4-slot groups, in sum, min and max on f32, f64 and int32.
The CUDA kernels are held against these plain versions bit for bit on
the card (``tests/test_torch_cuda.py``)."""

import numpy as np
import pytest
import torch

from graphtap_tpu_torch.kernels import fold_order as fo
from graphtap_tpu_torch.kernels import onehot_spmv as oh
from graphtap_tpu_torch.kernels import shuffle_kernels as sk
from graphtap_tpu_torch.tools.ring_times import chunk_figures

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


IDENT_OF = {("sum", np.int32): 0, ("min", np.int32): 2 ** 31 - 1,
            ("max", np.int32): -2 ** 31}


def _chunk_fold_loop(c, lanes, keep, chunk, cb, nblocks, kind, ident):
    """K5's and K8's order, spelled out: each chunk's kept entries of
    each lane in index order, cut into runs of RUN, each run folded from
    the identity, then the runs' results in order; each row block's list
    (its chunks in chunk order, the ones with no kept entry left out
    where ``keep`` is given; the identity where none is left) in runs of
    GROUP, then the runs' results in order."""
    nchunks = len(cb)
    k = np.ones(c.size, bool) if keep is None else keep
    part = np.zeros((nchunks, 128), c.dtype)
    for i in range(nchunks):
        sl = slice(i * chunk, (i + 1) * chunk)
        for lane in range(128):
            v = c[sl][k[sl] & (lanes[sl] == lane)]
            runs = [_seq(v[j:j + fo.RUN], kind, ident)
                    for j in range(0, len(v), fo.RUN)]
            part[i, lane] = _seq(np.array(runs, c.dtype), kind, ident)
    y = np.zeros((nblocks, 128), c.dtype)
    for r in range(nblocks):
        ids = [i for i in range(nchunks) if cb[i] == r and (
            keep is None or k[i * chunk:(i + 1) * chunk].any())]
        rows = part[ids] if ids else np.full((1, 128), ident, c.dtype)
        for lane in range(128):
            runs = [_seq(rows[j:j + fo.GROUP, lane], kind, ident)
                    for j in range(0, len(rows), fo.GROUP)]
            y[r, lane] = _seq(np.array(runs, c.dtype), kind, ident)
    return y


@pytest.mark.parametrize("kind", ["sum", "min", "max"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.int32])
def test_k5_k8_plain_folds_in_the_kernels_order(kind, dtype):
    """K5's and K8's plain versions against ``_chunk_fold_loop``, bit for
    bit: a block of 25 chunks, a one-lane chunk, a sorted chunk ending in
    a padding tail of lane 0 and the identity, an all-padding chunk and a
    row block with no chunk; K8 with an all-invalid chunk (left out of
    its block's list), all-invalid 4-slot groups and a one-lane chunk."""
    rng = np.random.default_rng(3)
    ident = IDENT_OF.get((kind, dtype), IDENT[kind])
    nchunks, nblocks = 40, 6
    cb = np.sort(rng.integers(0, nblocks - 1, nchunks)).astype(np.int32)
    cb[:25] = 2                                  # a block of 25 chunks
    n = nchunks * oh.CHUNK
    c = (rng.integers(-1000, 1000, n).astype(dtype) if dtype == np.int32
         else (rng.standard_normal(n) * 1e3).astype(dtype))
    lr = np.sort(rng.integers(0, 128, (nchunks, oh.CHUNK)),
                 1).reshape(-1).astype(np.int32)
    lr[:oh.CHUNK] = 7                            # one lane
    tail = slice(2 * oh.CHUNK - 300, 2 * oh.CHUNK)
    lr[tail], c[tail] = 0, ident                 # padding tail
    pad = slice(3 * oh.CHUNK, 4 * oh.CHUNK)
    lr[pad], c[pad] = 0, ident                   # all padding
    want = _chunk_fold_loop(c, lr, None, oh.CHUNK, cb, nblocks, kind, ident)
    got = oh.segment_reduce_plain(torch.from_numpy(c), torch.from_numpy(lr),
                                  torch.from_numpy(cb), nblocks,
                                  nblocks * 128, kind, ident)
    assert np.array_equal(got.numpy(), want.reshape(-1))
    # K8: 8-row chunks of 1024 slots, ev masking
    n8 = nchunks * 1024
    ev = (rng.random(n8) < 0.7).astype(np.int8)
    ev.reshape(-1, 4)[rng.random(n8 // 4) < 0.3] = 0   # invalid groups
    ev[2 * 1024:3 * 1024] = 0                    # a chunk with no slot
    lr8 = rng.integers(0, 128, n8).astype(np.int8)
    lr8[5 * 1024:6 * 1024] = 9                   # one lane
    want8 = _chunk_fold_loop(c[:n8], lr8, ev != 0, 1024, cb, nblocks, kind,
                             ident)
    got8 = sk.grouped_reduce_plain(
        torch.from_numpy(c[:n8]).view(-1, 128),
        torch.from_numpy(lr8).view(-1, 128),
        torch.from_numpy(ev).view(-1, 128), torch.from_numpy(cb), nblocks,
        kind, ident)
    assert np.array_equal(got8.numpy(), want8)


def test_chunk_lists_leave_out_dead_chunks():
    """K5's and K8's lists: the chunks by block in chunk order, the ones
    ``live`` marks False left out, a null item -1 for a block left with
    no chunk, and runs of GROUP over the positions."""
    cb = torch.tensor([0, 2, 0, 2, 2, 3], dtype=torch.int32)
    live = torch.tensor([True, True, False, True, True, False])
    rptr, gptr, chunks = fo.chunk_lists(cb, 5, live)
    assert chunks.dtype == rptr.dtype == gptr.dtype == torch.int32
    assert chunks.tolist() == [0, -1, 1, 3, 4, -1, -1]
    assert rptr.tolist() == [0, 1, 2, 3, 4, 5]
    assert gptr.tolist() == [0, 1, 2, 5, 6, 7]
    assert fo.chunk_lists(cb, 5)[2].tolist() == [0, 2, -1, 1, 3, 4, 5, -1]
    big = torch.zeros(3 * fo.GROUP + 5, dtype=torch.int32)
    rptr, gptr, _ = fo.chunk_lists(big, 1)
    assert rptr.tolist() == [0, 4]
    assert gptr.tolist() == [0, 64, 128, 192, 197]
    with pytest.raises(ValueError):
        fo.chunk_lists(torch.tensor([0, 5], dtype=torch.int32), 5)


def test_fold_tables_build_chunk_lists_once():
    """K8's tables (``shuffle_kernels.reduce_tables``): the chunk list of
    the chunks with a valid slot, built once per upload, scratch of the
    list's length, and the launch arguments checked against them."""
    cb = torch.tensor([0, 0, 2, 1, 2], dtype=torch.int32)
    ev = torch.ones((5 * 8, 128), dtype=torch.int8)
    ev[8:16] = 0                                 # chunk 1: no valid slot
    t = {"chunk_block": cb, "ev_r": ev}
    a = sk.reduce_tables(t, 4, torch.float32)
    t["ev_r"] = torch.zeros_like(ev)             # not read again
    b = sk.reduce_tables(t, 4, torch.float32)
    assert all(x is y for x, y in zip(a["lists"], b["lists"]))
    assert all(x is y for x, y in zip(a["scratch"], b["scratch"]))
    assert a["lists"][2].tolist() == [0, 3, 2, 4, -1]
    assert [tuple(x.shape) for x in a["scratch"]] == [(5, 128), (4, 128)]
    assert a["lists"][3] == sk.ev_stamp(ev)      # the ev they came from
    assert sorted(t) == ["chunk_block", "ev_r", "rd_fev", "rd_fgpart",
                         "rd_fgptr", "rd_fidx", "rd_fpart", "rd_frptr"]
    args = fo.fold_args(a["lists"][:3], a["scratch"], 4, 5, torch.float32,
                        cb.device)
    assert len(args) == 5
    with pytest.raises(ValueError, match="part"):
        fo.fold_args(a["lists"][:3], a["scratch"], 4, 5, torch.float64,
                     cb.device)


def test_chunk_figures_match_numpy():
    rng = np.random.default_rng(7)
    nchunks, chunk, nblocks = 9, 1024, 4
    lanes = rng.integers(0, 128, nchunks * chunk)
    lanes[:chunk] = 5
    keep = rng.random(nchunks * chunk) < 0.5
    keep[chunk:2 * chunk] = False
    cb = np.array([0, 0, 1, 1, 1, 3, 3, 3, 3], np.int32)
    f = chunk_figures(torch.from_numpy(lanes), torch.from_numpy(keep),
                      chunk, torch.from_numpy(cb), nblocks, True)
    cnt = np.zeros((nchunks, 128), int)
    for i in range(nchunks):
        sl = slice(i * chunk, (i + 1) * chunk)
        np.add.at(cnt[i], lanes[sl][keep[sl]], 1)
    longest = cnt.max(1)
    assert f["chunks"] == nchunks and f["blocks"] == 3
    assert f["entries"] == keep.sum()
    assert f["median_longest"] == np.median(longest)
    assert f["max_longest"] == longest.max()
    assert f["sum_longest"] == longest.sum()
    assert f["single_lane"] == ((cnt > 0).sum(1) == 1).sum() >= 1
    assert f["empty_chunks"] == 1
    assert f["empty4"] == (~keep.reshape(-1, 4).any(1)).mean()
    assert f["max_block_chunks"] == 4 and f["max_list"] == 4
    rows = np.zeros((nblocks, 128), int)
    np.add.at(rows, cb, cnt)
    assert f["max_row"] == rows.max()
    assert chunk_figures(torch.from_numpy(lanes), torch.from_numpy(keep),
                         chunk, torch.from_numpy(cb), nblocks,
                         False)["max_list"] == 4


def test_fold_tables_kept_once_per_upload():
    cb = torch.tensor([0, 0, 2, 1, 2], dtype=torch.int32)
    t = {}
    a = fo.fold_tables(t, "oh", lambda: fo.fold_lists(cb, 3), torch.float32)
    b = fo.fold_tables(t, "oh", lambda: fo.fold_lists(cb, 3), torch.float32)
    assert all(x is y for x, y in zip(a["lists"], b["lists"]))
    assert a["scratch"][0] is b["scratch"][0]
    assert [tuple(x.shape) for x in a["scratch"]] == [(5, 128), (3, 128)]
    c = fo.fold_tables(t, "oh", lambda: fo.fold_lists(cb, 3), torch.float64)
    assert c["scratch"][0].dtype == torch.float64
    assert sorted(t) == ["oh_fgpart", "oh_fgptr", "oh_fidx", "oh_fpart",
                         "oh_frptr"]
