"""Device times of hand kernels at their main-path shapes, each beside
its PyTorch call: the plan-ring kernels K1 (``route_xr_exp``) and K11
(``route_expand``) and the staged chunk fold K13 (``colsum_chunks``, on
the staged stack1 of the same x) at the RMAT-20 f32 PageRank shapes, K6
(``expand_stream``, its three launches of the degree SpMV) and K8
(``grouped_reduce``) on the RMAT-20 degree shuffle plan, K5
(``segment_reduce``) on the RMAT-20 f32 PageRank one-hot plan, K5 from
the plan on the same plan (``segment_reduce_gather``: the f32 sum;
``segment_reduce_gather_w``: f32 min-plus over seeded weights, as SSSP's),
and P1 (``copy_blocks``) and P2 (``stream_sum``) at the probes' table
shapes.

    python -m graphtap_tpu_torch.tools.ring_times [name ...]

Names pick rows (``route_xr_exp``, ``route_expand``, ``colsum_chunks``,
``expand_stream``, ``segment_reduce``, ``segment_reduce_gather``,
``segment_reduce_gather_w``, ``grouped_reduce``, ``copy_blocks``,
``stream_sum``,
and ``degree_spmv``: the degree SpMV's warm time on the shuffle plan, the
median of five calls after a first one by CUDA events; none: all). The
RMAT-20 panel meta (edge factor 16, seed 1, transposed TCSC, f32, as
``run_pagerank`` plans it), the degree shuffle
plan (its COL ordering) and the one-hot plan (ROW, as ``run_pagerank``'s
onehot kernel plans it) are planned once (minutes; seconds) and kept in
the package's build directory under names that carry those settings
(``meta_path``, ``shuffle_path``, ``onehot_path``). So two checkouts can
be timed in one run on the same plans: run this file by its path with
the other checkout first on ``PYTHONPATH``, and its kernels are the ones
timed (that checkout's ``tools/timing.py`` must have ``device_ms``). x is
seeded, unweighted PageRank-like values (all ones for the degree plan).
Each kernel is held against its plain version bit for bit, and against
its PyTorch call bit for bit (K5's f32 atomic sum within 1e-4 of the
largest |y|), then timed device-only (``timing.device_ms``: ten calls
replayed as one CUDA graph). Prints the card's name and power limit,
then one JSON line per row: name, device ms, the PyTorch call's device
ms (``torch.take`` over an index precomputed from the plan, three for
K6; ``torch.scatter_reduce`` for K5, K8 and K13; for K5 from the plan
the torch contributions and K5, which it replaces and must equal bit for
bit; ``Tensor.copy_``;
``torch.add``), bytes moved (each input read once, each output written
once); K5's and K8's rows first print their plan's chunk figures
(``chunk_figures``), K13's its row -> chunks
lists' (rows, chunks, rows of more than one, the longest). Needs a
card.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch

from graphtap_tpu_torch.tools.timing import device_ms, slot_ids, take_call

SCALE, EDGE_FACTOR, SEED = 20, 16, 1
BUILD = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "build")


def meta_path(directory: str = BUILD, scale: int = SCALE) -> str:
    """Where the panel meta of RMAT-``scale`` is kept: its name carries
    every setting it was planned from."""
    return os.path.join(directory, f"ring_times_rmat{scale}_ef{EDGE_FACTOR}"
                                   f"_seed{SEED}_tcsc_f32.npz")


def load_meta(path: str, scale: int = SCALE):
    """The f32 PageRank panel meta of RMAT-``scale``, read from ``path``
    (``meta_path``) where it exists, else planned and written there."""
    from graphtap_tpu_torch import Graph, GraphConfig
    from graphtap_tpu_torch.ingest import rmat_edges
    from graphtap_tpu_torch.kernels.panel_meta import build_spmv3_meta
    from graphtap_tpu_torch.tools import artifact_cache as ac
    if os.path.exists(path):
        return ac.load_spmv3_meta(path)
    r, c, _ = rmat_edges(scale, EDGE_FACTOR, seed=SEED)
    g = Graph.from_edges(r, c, None, GraphConfig(num_vertices=1 << scale,
                                                 transpose=True))
    meta = build_spmv3_meta(g.tiled(), value_dtype=np.float32)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    ac.save_spmv3_meta(meta, path)
    return meta


def shuffle_path(directory: str = BUILD, scale: int = SCALE) -> str:
    """Where the degree shuffle plan of RMAT-``scale`` is kept."""
    return os.path.join(directory, f"ring_times_rmat{scale}_ef{EDGE_FACTOR}"
                                   f"_seed{SEED}_tcsc_col_shuffle_f32.npz")


def load_shuffle(path: str, scale: int = SCALE):
    """The f32 degree-phase shuffle plan of RMAT-``scale`` (COL ordering,
    as ``run_pagerank``'s degree phase plans it), read from ``path``
    (``shuffle_path``) where it exists, else planned and written there."""
    from graphtap_tpu_torch import Graph, GraphConfig, Ordering
    from graphtap_tpu_torch.ingest import rmat_edges
    from graphtap_tpu_torch.kernels.shuffle_engine import build_shuffle_plans
    from graphtap_tpu_torch.tools import artifact_cache as ac
    if os.path.exists(path):
        return ac.load_shuffle_plans(path)
    r, c, _ = rmat_edges(scale, EDGE_FACTOR, seed=SEED)
    g = Graph.from_edges(r, c, None, GraphConfig(num_vertices=1 << scale,
                                                 transpose=True))
    meta = build_shuffle_plans(g.tiled(Ordering.COL),
                               value_dtype=np.float32)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    ac.save_shuffle_plans(meta, path)
    return meta


def onehot_path(directory: str = BUILD, scale: int = SCALE) -> str:
    """Where the one-hot plan of RMAT-``scale`` is kept."""
    return os.path.join(directory, f"ring_times_rmat{scale}_ef{EDGE_FACTOR}"
                                   f"_seed{SEED}_tcsc_row_onehot.npz")


def load_onehot(path: str, scale: int = SCALE):
    """(the one-hot plan of RMAT-``scale``'s ROW tiles, as
    ``build_onehot_plan`` makes it, NR, NC), read from ``path``
    (``onehot_path``) where it exists, else planned and written there."""
    from graphtap_tpu_torch.kernels.onehot_spmv import (PallasPlan,
                                                        build_onehot_plan)
    if os.path.exists(path):
        with np.load(path) as z:
            plan = PallasPlan(Ep=int(z["Ep"]), nblocks=int(z["nblocks"]),
                              nchunks=int(z["nchunks"]), lrows=z["lrows"],
                              cols=z["cols"], weights=None,
                              evalid=z["evalid"],
                              chunk_block=z["chunk_block"])
            return plan, int(z["NR"]), int(z["NC"])
    from graphtap_tpu_torch import Graph, GraphConfig
    from graphtap_tpu_torch.ingest import rmat_edges
    r, c, _ = rmat_edges(scale, EDGE_FACTOR, seed=SEED)
    g = Graph.from_edges(r, c, None, GraphConfig(num_vertices=1 << scale,
                                                 transpose=True))
    ts = g.tiled()
    plan = build_onehot_plan(ts)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, Ep=plan.Ep, nblocks=plan.nblocks, nchunks=plan.nchunks,
             lrows=plan.lrows, cols=plan.cols, evalid=plan.evalid,
             chunk_block=plan.chunk_block, NR=ts.NR,
             NC=g.part.tile_cols)
    return plan, ts.NR, g.part.tile_cols


def chunk_figures(lanes, keep, chunk: int, chunk_block: torch.Tensor,
                  nblocks: int, live_only: bool) -> dict:
    """What K5's and K8's fold turns on, for one chunked stream: chunks,
    row blocks with a chunk, the entries ``keep`` marks (None: all), the
    longest lane of each chunk (its median and maximum, and the sum over
    chunks: the old kernel's serial folds), the chunks whose entries all
    fall in one lane, the largest lane of one row block across its
    chunks, the most chunks of one row block, the chunks with no kept
    entry, the 4-entry groups with none, and the longest list of pass
    (b) (``live_only``: the chunks with no kept entry left out, as
    K8's lists leave them; else every chunk is listed)."""
    from graphtap_tpu_torch.kernels.fold_order import LANES
    nchunks = chunk_block.shape[0]
    n = nchunks * chunk
    ln = lanes.reshape(-1)[:n].long().view(nchunks, chunk)
    k = (torch.ones_like(ln, dtype=torch.bool) if keep is None
         else keep.reshape(-1)[:n].view(nchunks, chunk).bool())
    cnt = torch.zeros((nchunks, LANES), dtype=torch.long, device=ln.device)
    cnt.scatter_add_(1, ln, k.long())
    longest = cnt.max(1).values
    live = k.any(1)
    cb = chunk_block.long()
    per_row = torch.zeros((nblocks, LANES), dtype=torch.long,
                          device=ln.device)
    per_row.index_add_(0, cb, cnt)
    chunks_per = torch.bincount(cb, minlength=nblocks)
    listed = torch.bincount(cb[live] if live_only else cb,
                            minlength=nblocks)
    return {"chunks": nchunks, "blocks": int((chunks_per > 0).sum()),
            "entries": int(k.sum()),
            "median_longest": float(longest.double().median()),
            "max_longest": int(longest.max()) if nchunks else 0,
            "sum_longest": int(longest.sum()),
            "single_lane": int(((cnt > 0).sum(1) == 1).sum()),
            "max_row": int(per_row.max()) if nblocks else 0,
            "max_block_chunks": int(chunks_per.max()) if nblocks else 0,
            "empty_chunks": int((~live).sum()),
            "empty4": float((~k.view(-1, 4).any(1)).double().mean())
            if n else 0.0,
            "max_list": int(listed.max()) if nblocks else 0}


def _scatter_call(vals, dst, nrows, identity, kind="sum"):
    """One torch.scatter_reduce of ``vals`` into ``nrows`` slots from the
    identity (index ``dst`` precomputed), the PyTorch call of K5 and K8."""
    y0 = torch.full((nrows,), identity, dtype=vals.dtype, device=vals.device)
    op = {"sum": "sum", "min": "amin", "max": "amax"}[kind]
    return lambda: torch.scatter_reduce(y0, 0, dst, vals.reshape(-1), op)


def segment_row(plan, nr, nc, device="cuda"):
    """(name, kernel call, plain call, PyTorch call, bytes, figures) of K5
    on the one-hot plan ``plan`` (nr rows, nc columns): the f32 PageRank
    contributions of seeded x, summed. Bytes: every contribution and its
    int32 row (the kernel cannot know the padding), chunk_block, and y
    written once."""
    from graphtap_tpu_torch.kernels import onehot_spmv as oh
    from graphtap_tpu_torch.kernels.semiring import plus_times
    from graphtap_tpu_torch.tools.convert import meta_from_numpy
    t = meta_from_numpy(plan.arrays, device)
    rng = np.random.default_rng(SEED)
    x = torch.from_numpy(rng.random(nc).astype(np.float32)).to(device)
    contrib = oh.onehot_contrib(x, t, plus_times())
    args = (contrib, t["oh_lrows"], t["oh_chunk_block"], plan.nblocks, nr,
            "sum", 0.0)
    folds = oh.fold_tables(t, plan, torch.float32)
    dst = (t["oh_chunk_block"].long().repeat_interleave(oh.CHUNK) * oh.RB
           + t["oh_lrows"].long())
    lib = _scatter_call(contrib, dst, plan.nblocks * oh.RB, 0.0)
    nbytes = (contrib.numel() * 8 + plan.nchunks * 4
              + plan.nblocks * oh.RB * 4)
    figs = chunk_figures(t["oh_lrows"], t["oh_evalid"] != 0, oh.CHUNK,
                         t["oh_chunk_block"], plan.nblocks, False)
    return ("segment_reduce", lambda: oh.segment_reduce(*args, **folds),
            lambda: oh.segment_reduce_plain(*args),
            lambda: lib()[:nr], nbytes, figs)


def gather_rows(plan, nr, nc, device="cuda"):
    """(name, kernel call, plain call, PyTorch call, bytes) of K5 from the
    one-hot plan ``plan`` (nr rows, nc columns), twice: the f32 sum of
    seeded x (``segment_reduce_gather``), and f32 min-plus over seeded
    weights in [0, 1) with a third of x +inf (``segment_reduce_gather_w``,
    SSSP's ⊗ and ⊕). The PyTorch call is what the kernel replaces: the
    contributions built in torch (``onehot_contrib``), then K5. The
    kernel reads the plan's gather tables, built once here. Bytes (the
    plan's, which the bound is counted in): each slot's col, row and ev byte
    (and weight), chunk_block, x read once, and y written once."""
    import dataclasses
    from graphtap_tpu_torch.kernels import onehot_spmv as oh
    from graphtap_tpu_torch.kernels.semiring import (inf_of, min_plus,
                                                     plus_times)
    from graphtap_tpu_torch.kernels.shuffle_engine import mul_kind
    from graphtap_tpu_torch.tools.convert import meta_from_numpy
    rng = np.random.default_rng(SEED)
    out = []
    for name, sem, weighted in (
            ("segment_reduce_gather", plus_times(), False),
            ("segment_reduce_gather_w", min_plus(inf_of(torch.float32)),
             True)):
        xh = rng.random(nc).astype(np.float32)
        if weighted:
            plan = dataclasses.replace(plan, weights=rng.random(
                (1, plan.Ep)).astype(np.float32))
            xh[rng.random(nc) < 1 / 3] = np.inf
        t = meta_from_numpy(plan.arrays, device)
        x = torch.from_numpy(xh).to(device)
        folds = oh.fold_tables(t, plan, torch.float32)
        w = t.get("oh_w")
        args = (x, t["oh_cols"], t["oh_evalid"], w, t["oh_lrows"],
                t["oh_chunk_block"], plan.nblocks, nr, nc, sem.reduce_kind,
                mul_kind(plan, sem), sem.identity)
        # an older checkout's K5 reads the plan itself (no gather tables)
        tabs = ({"tables": oh.gather_tables(*args[1:3], args[4], w, nc)}
                if hasattr(oh, "gather_tables") else {})

        def glue(t=t, x=x, sem=sem, folds=folds, nblocks=plan.nblocks):
            return oh.segment_reduce(
                oh.onehot_contrib(x, t, sem), t["oh_lrows"],
                t["oh_chunk_block"], nblocks, nr, sem.reduce_kind,
                sem.identity, **folds)
        nbytes = (plan.Ep * (13 if weighted else 9) + plan.nchunks * 4
                  + nc * 4 + plan.nblocks * oh.RB * 4)
        out.append((name,
                    lambda a=args, f={**folds, **tabs}:
                    oh.segment_reduce_gather(*a, **f),
                    lambda a=args: oh.segment_reduce_gather_plain(*a),
                    glue, nbytes))
    return out


def grouped_row(meta, device="cuda"):
    """(name, kernel call, plain call, PyTorch call, bytes, figures) of K8
    on the degree shuffle plan ``meta``'s grouped stream (x all ones).
    Bytes: every ev byte, the value and lane byte of each valid slot,
    chunk_block, and y written once; the PyTorch call sends the holes to
    scratch slots past y."""
    from graphtap_tpu_torch.kernels import shuffle_kernels as sk
    from graphtap_tpu_torch.kernels.semiring import plus_times
    from graphtap_tpu_torch.kernels.shuffle_engine import spmv_stages
    from graphtap_tpu_torch.kernels.shuffle_plan import LANES, RED_ROWS
    from graphtap_tpu_torch.tools.convert import meta_from_numpy
    t = meta_from_numpy(meta.arrays, device)
    x = torch.ones(meta.NC, dtype=torch.float32, device=device)
    st = spmv_stages(x, t, meta, plus_times(), meta.NR)
    grouped = st["grouped"]
    del st
    args = (grouped, t["lr"], t["ev_r"], t["chunk_block"], meta.nblocks,
            "sum", 0.0)
    folds = sk.reduce_tables(t, meta.nblocks, torch.float32)
    valid = t["ev_r"] != 0
    nvalid = int(valid.sum())
    blk = t["chunk_block"].long().repeat_interleave(RED_ROWS * LANES).view(
        -1, LANES)
    hole = meta.nblocks * LANES + torch.arange(
        valid.numel(), device=valid.device).view(valid.shape) % 4096
    dst = torch.where(valid, blk * LANES + t["lr"].long(), hole).reshape(-1)
    lib = _scatter_call(grouped, dst, meta.nblocks * LANES + 4096, 0.0)
    nbytes = (valid.numel() + nvalid * 5 + t["chunk_block"].numel() * 4
              + meta.nblocks * LANES * 4)
    figs = chunk_figures(t["lr"], valid, RED_ROWS * LANES,
                         t["chunk_block"], meta.nblocks, True)
    return ("grouped_reduce", lambda: sk.grouped_reduce(*args, **folds),
            lambda: sk.grouped_reduce_plain(*args),
            lambda: lib()[:meta.nblocks * LANES].view(-1, LANES), nbytes,
            figs)


def expand_row(meta, device="cuda"):
    """(name, kernel call, plain call, PyTorch call, bytes) of K6's three
    launches of the degree SpMV on the shuffle plan ``meta`` (x all ones,
    as the degree phase's): the stream expand and the dense expansion's A
    and B windows, unweighted; each call returns the three outputs.
    Bytes count what this data needs: the table, grp and ev whole, slot
    and lane where ev is set, the output written once."""
    from graphtap_tpu_torch.kernels import shuffle_kernels as sk
    from graphtap_tpu_torch.kernels.semiring import plus_times
    from graphtap_tpu_torch.kernels.shuffle_engine import spmv_stages
    from graphtap_tpu_torch.kernels.shuffle_plan import LANES, SUB, WROWS
    from graphtap_tpu_torch.tools.convert import meta_from_numpy
    t = meta_from_numpy(meta.arrays, device)
    x = torch.ones(meta.NC, dtype=torch.float32, device=device)
    st = spmv_stages(x, t, meta, plus_times(), meta.NR)
    calls = [(st["x3d"], t["grp"], t["slot"], t["lane"], t["ev_x"])] + [
        (st["ytab"], t[f"mexp_grp_{h}"], t[f"mexp_slot_{h}"],
         t["mexp_lane"], t[f"mexp_ev_{h}"]) for h in ("a", "b")]
    nbytes, takes = 0, []
    for tab, grp, slot, lane, ev in calls:
        valid = ev != 0
        nbytes += (tab.numel() * 4 + grp.numel() * 4 + ev.numel()
                   + 2 * int(valid.sum()) + slot.numel() * 4)
        ext = torch.cat([tab.reshape(-1), tab.new_zeros(1)])
        win = grp.long().repeat_interleave(SUB)[:, None]
        takes.append((ext, torch.where(
            valid, (win * WROWS + slot.long()) * LANES + lane.long(),
            ext.numel() - 1)))

    def kern():
        return tuple(sk.expand_stream(*a, None, 0.0) for a in calls)

    def plain():
        return tuple(sk.expand_stream_plain(*a, None, 0.0) for a in calls)

    def lib():
        return tuple(torch.take(e, i) for e, i in takes)
    return ("expand_stream", kern, plain, lib, nbytes)


def sum_row(device="cuda", sum_bytes=None):
    """(name, kernel call, plain call, PyTorch call, bytes) of P2 on two
    f32 (rows, 1024) streams of ``sum_bytes`` in all (default the probe's
    TARGET_BYTES: (34,304, 1024))."""
    from graphtap_tpu_torch.tools import bw_probe as bw
    gen = torch.Generator(device=device).manual_seed(SEED)
    rows = (sum_bytes or bw.TARGET_BYTES) // (1024 * 4 * 2) // 64 * 64
    xs = [torch.rand((rows, 1024), device=device, generator=gen)
          for _ in range(2)]
    return ("stream_sum", lambda: bw.stream_sum(xs),
            lambda: bw.stream_sum_plain(xs), lambda: torch.add(xs[0], xs[1]),
            3 * xs[0].numel() * 4)


def copy_row(device="cuda", copy_bytes=None):
    """(name, kernel call, plain call, PyTorch call, bytes) of P1 on
    ``copy_bytes`` (default the probe's TARGET_BYTES) in (256, 1024)
    tiles."""
    from graphtap_tpu_torch.tools import bw_probe as bw
    xc = torch.rand(((copy_bytes or bw.TARGET_BYTES) // 4096, 1024),
                    device=device)
    yc = torch.empty_like(xc)
    return ("copy_blocks", lambda: bw.copy_blocks(xc, 256, 1024),
            lambda: bw.copy_blocks_plain(xc, 256, 1024),
            lambda: yc.copy_(xc), 2 * xc.numel() * 4)


def rows(meta, device="cuda", copy_bytes=None):
    """The rows of K1 and K11 on ``meta`` and P1 (``copy_row``), their
    inputs on ``device``."""
    from graphtap_tpu_torch.kernels import panel_kernels as pk
    from graphtap_tpu_torch.kernels.panel_engine import (pad_x,
                                                         staged_tables)
    from graphtap_tpu_torch.tools.convert import meta_from_numpy
    t = staged_tables(meta_from_numpy(meta.arrays, device), meta)
    rng = np.random.default_rng(SEED)
    x = torch.from_numpy(rng.random(meta.NC).astype(np.float32)).to(device)
    x2d = pad_x(x, meta, 0.0)
    nxe = meta.exp_panels + 1
    xr = (x2d, t["xr_bases"], t["xr_plan"], 0.0, nxe, meta.xr_nwin)
    one = dict(out_rows=pk.XROWS, two_layer=False)
    x_ext = pk.route_passa(*xr, **one)
    panel = pk.PROWS * pk.LANES * 4
    k1 = (x2d, t["xr_bases"], t["xe_plan"], None, 0.0, nxe, meta.xr_nwin)
    k1_idx = pk.route_xr_exp_plain(slot_ids(x2d), *k1[1:4], -1, *k1[5:])
    k11 = (x_ext, t["exp_plan"], None, 0.0, nxe)
    k11_idx = pk.route_expand_plain(slot_ids(x_ext), k11[1], None, -1, nxe)
    return [
        ("route_xr_exp", lambda: pk.route_xr_exp(*k1),
         lambda: pk.route_xr_exp_plain(*k1), take_call(x2d, k1_idx, 0.0),
         x2d.numel() * 4 + 4 * nxe * meta.xr_nwin
         + nxe * pk.xe_plan_rows(meta.xr_nwin) * pk.LANES + nxe * panel),
        ("route_expand", lambda: pk.route_expand(*k11),
         lambda: pk.route_expand_plain(*k11), take_call(x_ext, k11_idx, 0.0),
         x_ext.numel() * 4 + nxe * pk.plan_rows(pk.XROWS) * pk.LANES
         + nxe * panel),
        copy_row(device, copy_bytes)]


def staged_row(meta, device="cuda"):
    """(name, kernel call, plain call, PyTorch call, bytes, figures) of K13
    on the staged stack1 (x_ext -> s0 -> s1 -> stack1) of a seeded x on
    ``meta``; its PyTorch call is one scatter_reduce over
    repeat_interleave(chunk_dst, 8); the figures are its row -> chunks
    lists' (rows, chunks, rows of more than one, rows of more than
    ``panel_kernels.COLSUM_LONG`` and their chunks, the longest list)."""
    from graphtap_tpu_torch.kernels import panel_kernels as pk
    from graphtap_tpu_torch.kernels.panel_engine import (CHUNK_LISTS, pad_x,
                                                         staged_tables)
    from graphtap_tpu_torch.tools.convert import meta_from_numpy
    t = staged_tables(meta_from_numpy(meta.arrays, device), meta)
    rng = np.random.default_rng(SEED)
    x = torch.from_numpy(rng.random(meta.NC).astype(np.float32)).to(device)
    nxe = meta.exp_panels + 1
    x_ext = pk.route_passa(pad_x(x, meta, 0.0), t["xr_bases"], t["xr_plan"],
                           0.0, nxe, meta.xr_nwin, out_rows=pk.XROWS,
                           two_layer=False)
    s1 = pk.route_passa(pk.route_expand(x_ext, t["exp_plan"], None, 0.0,
                                        nxe),
                        t["pa_bases"], t["pa_plan"], 0.0,
                        meta.pa_panels + 1, meta.pa_nwin)
    stack1 = pk.route_passa(s1, t["fixr_bases"], t["fixr_plan"], 0.0,
                            meta.fix_panels, meta.fixr_nwin)
    k13 = (stack1, t["chunk_dst"], meta.nrb, "sum", 0.0)
    lists = tuple(t[k] for k in CHUNK_LISTS)
    dest = (t["chunk_dst"].long().repeat_interleave(pk.STRIPE)[:, None]
            * pk.LANES + torch.arange(pk.LANES, device=stack1.device)
            ).reshape(-1)
    y0 = torch.zeros(meta.nrb * pk.LANES, device=stack1.device)
    per_row = lists[0][1:] - lists[0][:-1]
    return ("colsum_chunks", lambda: pk.colsum_chunks(*k13, lists=lists),
            lambda: pk.colsum_chunks_plain(*k13),
            lambda: torch.scatter_reduce(y0, 0, dest, stack1.reshape(-1),
                                         "sum").view(meta.nrb, pk.LANES),
            stack1.numel() * 4 + sum(4 * a.numel() for a in lists)
            + meta.nrb * pk.LANES * 4,
            {"rows": meta.nrb, "chunks": int(per_row.sum()),
             "rows_of_more_than_one": int((per_row > 1).sum()),
             "long_rows": lists[2].numel(), "long_chunks": lists[3].numel(),
             "longest_list": int(per_row.max())})


def check(name, kern, plain, lib, rtol=None) -> None:
    """The kernel call equals its plain version bit for bit, and its
    PyTorch call bit for bit, or within ``rtol`` of the largest |value|
    (each output of a call that returns several)."""
    def outs(v):
        return v if isinstance(v, tuple) else (v,)
    a = outs(kern())
    for b, c in zip(outs(plain()), outs(lib())):
        k = a[0]
        a = a[1:]
        c = c.view(k.shape)
        lib_ok = (torch.equal(c, k) if rtol is None else
                  float((c.double() - k.double()).abs().max())
                  <= rtol * float(k.double().abs().max()))
        if not torch.equal(k, b) or not lib_ok:
            raise AssertionError(f"{name}: the kernel, its plain version "
                                 f"and its PyTorch call disagree")


def degree_spmv(t, meta, calls: int = 6):
    """The degree SpMV (``spmv_local``, x all ones) on the shuffle plan
    ``meta`` with its plan tensors ``t`` on the card: ``calls`` calls,
    each between two CUDA events; (the median of all but the first, in
    ms; each call's ms)."""
    from graphtap_tpu_torch.kernels.semiring import plus_times
    from graphtap_tpu_torch.kernels.shuffle_engine import spmv_local
    x = torch.ones(meta.NC, dtype=torch.float32, device=t["grp"].device)
    times = []
    for _ in range(calls):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        spmv_local(x, t, meta, plus_times(), meta.NR)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    warm = sorted(times[1:])
    return warm[len(warm) // 2], times


PANEL_ROWS = ("route_xr_exp", "route_expand")
GATHER_ROWS = ("segment_reduce_gather", "segment_reduce_gather_w")
NAMES = PANEL_ROWS + ("colsum_chunks", "expand_stream", "segment_reduce",
                      *GATHER_ROWS, "grouped_reduce",
                      "copy_blocks", "stream_sum", "degree_spmv")
# K5's and K13's PyTorch calls sum in f32 with atomics, in another order
# each call
LIB_RTOL = {"segment_reduce": 1e-4, "colsum_chunks": 1e-5}


def all_rows(names, device="cuda"):
    """The rows of ``names`` (NAMES), planning only what they need."""
    out = []
    if set(names) & set(PANEL_ROWS):
        out += [r for r in rows(load_meta(meta_path()), device)
                if r[0] in names]
    elif "copy_blocks" in names:
        out.append(copy_row(device))
    if "colsum_chunks" in names:
        out.append(staged_row(load_meta(meta_path()), device))
    if "expand_stream" in names:
        out.append(expand_row(load_shuffle(shuffle_path()), device))
    if "segment_reduce" in names:
        out.append(segment_row(*load_onehot(onehot_path()), device))
    if set(names) & set(GATHER_ROWS):
        out += [r for r in gather_rows(*load_onehot(onehot_path()), device)
                if r[0] in names]
    if "grouped_reduce" in names:
        out.append(grouped_row(load_shuffle(shuffle_path()), device))
    if "stream_sum" in names:
        out.append(sum_row(device))
    return out


def main(argv=None) -> int:
    names = (sys.argv[1:] if argv is None else argv) or list(NAMES)
    bad = set(names) - set(NAMES)
    if bad:
        print(f"ring_times: unknown rows {sorted(bad)}; use {NAMES}",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("ring_times: no CUDA device; it times the card",
              file=sys.stderr)
        return 1
    import graphtap_tpu_torch
    from graphtap_tpu_torch.tools.bw_probe import card
    print(f"{card()} ({torch.cuda.get_device_name(0)}); package "
          f"{os.path.dirname(graphtap_tpu_torch.__file__)}", flush=True)
    for name, kern, plain, lib, nbytes, *figs in all_rows(names):
        if figs:
            print(json.dumps({"name": name, "chunk_figures": figs[0]}),
                  flush=True)
        check(name, kern, plain, lib, LIB_RTOL.get(name))
        print(json.dumps({"name": name, "device_ms": device_ms(kern),
                          "library_device_ms": device_ms(lib),
                          "bytes": nbytes}), flush=True)
    if "degree_spmv" in names:
        from graphtap_tpu_torch.tools.convert import meta_from_numpy
        meta = load_shuffle(shuffle_path())
        med, times = degree_spmv(meta_from_numpy(meta.arrays, "cuda"), meta)
        print(json.dumps({"name": "degree_spmv", "warm_median_ms": med,
                          "ms": times}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
