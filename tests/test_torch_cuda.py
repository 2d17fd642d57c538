"""The CUDA kernels and the port's paths against their plain torch
versions and the CPU, on the card.

Marked ``gpu``: each test skips (with a reason) where torch sees no CUDA
device, and runs on the card with
``python -m pytest tests/test_torch_cuda.py -q --noconftest`` (the
tests' conftest imports jax). K1, K2 and K4 must match
bit for bit, and so must K3, K5 and K8, whose float sums fold in a fixed
order that their plain versions follow (``kernels/fold_order.py``); called
twice on the same RMAT-14 f32 inputs they give the same bits, and f32
PageRank to convergence settles on every kernel. The gated K1-K3 match bit
for bit, and BFS, CC and SSSP on the card equal the same runs on the CPU.
The shuffle kernels K6 and K7 (one composed gather per call, three radix
passes among the cases) and the windowed gathers K9 and K10 (f32, f64 and
i32; steps with no subop, fewer than nsub, and 30 in f64, so that K10's
ring of shared-memory windows wraps) match bit for bit. The staged pipeline's kernels: K2's single-layer form and K11 bit
for bit (K11's s0 equal to K1's), K12 bit for bit in int32 and within rtol
1e-6 in floats, K13 bit for bit in f32, f64 and int32 (it folds each
row's chunks in ascending chunk order, the Pallas grid's), twice, on
rows of hundreds of chunks; the staged y equal to the fused y within
rounding. ``graft_entry.entry()``'s step equals the same step on the
plain versions bit for bit. Whole SpMVs on the card are
held against the CPU within the same rtol. The probes P1-P3 match their
plain versions bit for bit. K2 in both its forms (the source windows
staged in shared memory beside the plan block, or read from device
memory), static and gated, and K9 on steps with nact 0, nact beyond nsub
and SID_INVALID slots under each ⊗, match bit for bit on seeded synthetic
plans. K1 and K3 on their plan rings (static and gated, every ⊗ and ⊕
kind, npanels 1 and past the persistent grid, K3 in both ring depths,
each nwin up to the wrapper's shared-memory limit) match bit for bit on
seeded synthetic plans, and so does K11 on K1's plan ring (every ⊗ in
f32, f64 and int32, npanels 1 and past the grid, fill slots), twice. P1's
TMA chunk copies equal x.clone() on 16-byte segments, tiles taller than a
chunk, fewer tiles than SMs, one tile and segments wider than a chunk.
K6 (one block a step, no plan loads for all-invalid 4-slot groups)
matches bit for bit in f32, f64 and int32 under each ⊗ on 1-step runs, a
long run, all-invalid steps, the last window and a window read again
after a gap; P2 (16 KB chunks) on shapes whose last chunk is partial.
K5 and K8 (each lane's entries folded in runs of 32 in a block a chunk)
match bit for bit, twice, and equal the CPU, on hub chunks, sorted and
unsorted K5 chunks, padding tails, K8's all-invalid groups and chunks
and row blocks with no chunk, in every value type and ⊕. On RMAT-14
plans of CSC tiles (raw local rows, NR = C*L), K5 on the one-hot plan and
K1-K4 on the panel meta match bit for bit, twice. K5's f32 min and max
(Graph500 kernel 3's float SSSP) match bit for bit, twice; float SSSP on
onehot equals the CPU run; one float SSSP superstep copies nothing
between the host and the card and does not synchronize, its vote being
the one read. K5 from the plan (the gather, ⊗ and padding mask made in
the fold) equals the torch contributions folded by K5 bit for bit, twice,
at RMAT-16 in every value type, ⊕ and ⊗ and on a last chunk of padding;
a PageRank and a float SSSP superstep on onehot run no torch op over the
plan's slots and count the plan's length in ``onehot_gathered_slots``.
TCSC_CF PageRank to tolerance (pr.cpp's deployment) runs K5 from each
phase's own plan bit for bit with its plain version, and takes the CPU
run's supersteps.

Whole paths: PageRank on panel, shuffle, shuffle2 and onehot over TCSC,
TCSC_CF and CSC tiles equals the CPU, the golden model and
``golden.degree``, with each path's launches a superstep
(``PATH_LAUNCHES``); BFS, CC and SSSP on panel equal the CPU with the
panel gate on its vote, forced and off. The mesh on the card (four gloo
ranks of a 2x2 mesh on the one card; one rank in an NCCL group), the five
mains, ``dryrun_multichip(4)`` and the kernel lab's nine variants run at
RMAT-10 against the card's group-free runs, the golden models and
``lab_table``'s gates.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from graphtap_tpu_torch import Compression, Graph, GraphConfig
from graphtap_tpu_torch.apps import (bfs_config, cc_config, run_bfs,
                                     run_cc, run_pagerank, run_sssp,
                                     sssp_config)
from graphtap_tpu_torch.ingest import rmat_edges
from graphtap_tpu_torch.ingest.io import write_binary
from graphtap_tpu_torch.kernels import gather_kernels as gk
from graphtap_tpu_torch.kernels import onehot_spmv as oh
from graphtap_tpu_torch.kernels import panel_kernels as pk
from graphtap_tpu_torch.kernels import shuffle_kernels as sk
from graphtap_tpu_torch.kernels import semiring as tsr
from graphtap_tpu_torch.kernels import panel_engine as tpe
from graphtap_tpu_torch.kernels.gather_engine import (STAGES,
                                                      build_spmv2_meta,
                                                      spmv2_stages,
                                                      stage_plan,
                                                      stage_src_rows)
from graphtap_tpu_torch.kernels.gather_plan import build_gather_plan
from graphtap_tpu_torch.kernels.panel_engine import (spmv3_staged_stages,
                                                     spmv3_stages,
                                                     staged_tables)
from graphtap_tpu_torch.kernels.panel_meta import (build_spmv3_meta,
                                                   fill_blocks)
from graphtap_tpu_torch.kernels.shuffle_engine import (build_shuffle_plans,
                                                       mul_kind, spmv_stages)
from graphtap_tpu_torch.kernels.shuffle_plan import build_spmv_plan
from graphtap_tpu_torch.engine import executor
from graphtap_tpu_torch.parallel.launch import launch
from graphtap_tpu_torch.tools import bw_probe, route_cost_probe, timing
from graphtap_tpu_torch.tools.convert import meta_from_numpy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import golden  # noqa: E402
from onehot_cases import GATHER_CASES, gather_case  # noqa: E402

pytestmark = pytest.mark.gpu

FOLD_RTOL = {torch.float32: 1e-5, torch.float64: 1e-12}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype,weighted", [(np.float32, False),
                                            (np.float64, True),
                                            (np.int32, True)])
def test_kernels_match_plain(cuda, dtype, weighted):
    sem = tsr.min_plus() if dtype == np.int32 else tsr.plus_times()
    r, c, w = rmat_edges(12, 16, seed=3, weighted=weighted)
    g = Graph.from_edges(r, c, w, GraphConfig(num_vertices=1 << 12,
                                              transpose=True))
    meta = build_spmv3_meta(g.tiled(), value_dtype=dtype)
    t = meta_from_numpy(meta.arrays, cuda)
    rng = np.random.default_rng(1)
    if dtype == np.int32:
        x = rng.integers(0, 1000, size=g.part.tile_cols).astype(dtype)
        x[rng.random(x.size) < 0.3] = tsr.INF_I32
    else:
        x = rng.random(g.part.tile_cols).astype(dtype)
    before = dict(pk.LAUNCHES)
    st = spmv3_stages(torch.from_numpy(x).to(cuda), t, meta, sem,
                      g.part.tile_rows)
    assert {k: pk.LAUNCHES[k] - before[k] for k in before} == {
        "route_xr_exp": 1, "route_passa": 1, "route_fold": 2,
        "hub_fold": 1, "route_xr_exp_gated": 0, "route_passa_gated": 0,
        "route_fold_gated": 0, "route_passa_single": 0, "route_expand": 0,
        "fold_stripes": 0, "colsum_chunks": 0}
    fill, kind = sem.identity, sem.reduce_kind
    mul = ("mul" if kind == "sum" else "add_sat") if weighted else "none"
    xe = (st["x2d"], t["xr_bases"], t["xe_plan"], t.get("w_stream"), fill,
          meta.exp_panels + 1, meta.xr_nwin, mul)
    assert torch.equal(st["s0"], pk.route_xr_exp_plain(*xe))
    pa = (st["s0"], t["pa_bases"], t["pa_plan"], fill, meta.pa_panels + 1,
          meta.pa_nwin)
    assert torch.equal(st["s1"], pk.route_passa_plain(*pa))
    assert torch.equal(st["y_hub"],
                       pk.hub_fold_plain(st["y_mid"], t["hub_mask"], kind))
    folds = [
        (st["y_mid"], (st["s1"], t["fixr_bases"], t["fixr_plan"],
                       t["fix_dst"], t["fixr_seg"], meta.nrb, kind, fill,
                       meta.fix_panels, meta.fixr_nwin)),
        (st["y"].view(-1), (st["y_hub"], t["f2_bases"], t["f2_plan"],
                            t["fix2_dst"], t["f2_seg"], meta.f2_rows, kind,
                            fill, meta.f2_panels, meta.f2_nwin))]
    for got, args in folds:
        want = pk.route_fold_plain(*args).view(-1)[:got.numel()].view(
            got.shape)
        assert torch.equal(got, want)


# the launches each kernel path makes a superstep (a degree SpMV is one)
PATH_LAUNCHES = {"panel": {"route_xr_exp": 1, "route_passa": 1,
                           "route_fold": 2, "hub_fold": 1},
                 "shuffle": {"expand_stream": 3, "group_stream": 1,
                             "grouped_reduce": 1},
                 "shuffle2": {"windowed_gather": 6, "grouped_reduce": 1},
                 "onehot": {"segment_reduce_gather": 1}}


@pytest.mark.parametrize("kernel,comp", [
    ("panel", "TCSC"), ("shuffle", "TCSC"), ("shuffle2", "TCSC"),
    ("onehot", "TCSC"), ("panel", "TCSC_CF"), ("onehot", "TCSC_CF"),
    ("panel", "CSC"), ("shuffle2", "CSC"), ("onehot", "CSC")])
def test_pagerank_on_cuda_matches_cpu(cuda, kernel, comp):
    """20 f64 PageRank iterations at RMAT-12 on each kernel path, on TCSC,
    TCSC_CF (pr.cpp's first/middle/last phases) and CSC tiles: the ranks
    equal the CPU's within 1e-12 relative, the checksum the f64 golden
    model's, and the degree phase (on shuffle, or onehot, which takes CSC)
    ``golden.degree``; the run launches its degree SpMV and, each
    superstep, its path's kernels (``PATH_LAUNCHES``), and nothing else."""
    r, c, _ = rmat_edges(12, 16, seed=1)
    n = 1 << 12
    g = Graph.from_edges(r, c, None, GraphConfig(
        num_vertices=n, transpose=True, compression=Compression[comp]))
    deg = "onehot" if kernel == "onehot" or comp == "CSC" else "shuffle"
    timing.reset_launches()
    on_card = run_pagerank(g, 20, torch.float64, kernel=kernel,
                           device=cuda, degree_kernel=deg)
    want = dict(PATH_LAUNCHES[deg])
    for k, v in PATH_LAUNCHES[kernel].items():
        want[k] = want.get(k, 0) + 20 * v
    assert on_card.iteration == 20
    assert timing.launches() == want
    on_cpu = run_pagerank(g, 20, torch.float64, kernel=kernel,
                          device="cpu", degree_kernel=deg)
    np.testing.assert_allclose(on_card.state_vector()["rank"],
                               on_cpu.state_vector()["rank"], rtol=1e-12,
                               atol=0)
    np.testing.assert_array_equal(
        on_card.degree_phase.state_vector()["degree"],
        golden.degree(r, c, n + 1).astype(np.float64))
    gsum = float(golden.pagerank(r, c, n + 1, 20).sum())
    assert abs(on_card.checksum()[0] - gsum) <= 1e-10 * gsum


def test_wrappers_reject_mixed_devices(cuda):
    r, c, _ = rmat_edges(8, 16, seed=1)
    g = Graph.from_edges(r, c, None, GraphConfig(num_vertices=256,
                                                 transpose=True))
    meta = build_spmv3_meta(g.tiled(), np.float32)
    t = meta_from_numpy(meta.arrays, "cpu")
    s0 = torch.zeros(((meta.exp_panels + 1) * 64, 128), device=cuda)
    with pytest.raises(ValueError):
        pk.route_passa(s0, t["pa_bases"], t["pa_plan"], 0.0,
                       meta.pa_panels + 1, meta.pa_nwin)


# share of K2's panels pointed at the fill block, by frontier
_PA_OFF = {"sparse": 0.5, "dense": 0.7, "empty": 1.0}


@pytest.mark.parametrize("frontier", ["sparse", "dense", "empty"])
@pytest.mark.parametrize("weighted", [True, False])
def test_gated_kernels_match_plain(cuda, weighted, frontier):
    """Gated K1-K3 at RMAT-12, int32 min: K1 on the real gating maps of a
    2% frontier clustered mid-range, a 30% one (a contiguous range) or an
    empty one; K2 with half, 70% or all of its panels pointed at the fill
    block, K3 with about half, so the kernels' fill-block early exit is
    held against the plain version fed the fill plan."""
    sem = tsr.min_plus() if weighted else tsr.min_select()
    inf = sem.identity
    r, c, w = rmat_edges(12, 16, seed=1, weighted=weighted)
    n = 1 << 12
    cfg = sssp_config(n) if weighted else bfs_config(n)
    g = Graph.from_edges(r, c, w, cfg)
    meta = build_spmv3_meta(g.tiled(), value_dtype=np.int32)
    t = meta_from_numpy(meta.arrays, cuda)
    nc = g.part.tile_cols
    rng = np.random.default_rng(2)
    x = np.full(nc, inf, np.int32)
    if frontier != "empty":
        lo, k = (nc // 2, nc // 50) if frontier == "sparse" else (
            nc // 4, 3 * nc // 10)
        x[lo:lo + k] = rng.integers(0, 1000, k)
    x2d = tpe.pad_x(torch.from_numpy(x).to(cuda), meta, inf)
    xe_b, xe_q = tpe.gating_maps(tpe.window_activity(x2d, t, meta, inf),
                                 t, meta)[:2]
    fb = fill_blocks(meta)

    def half_off(nq, fill, share=0.5):
        q = np.arange(nq, dtype=np.int32)
        q[rng.random(nq) < share] = fill
        return torch.from_numpy(q).to(cuda)

    npa = meta.pa_panels + 1
    pa_q = half_off(npa, fb["pa_plan"], _PA_OFF[frontier])
    fx_q = half_off(meta.fix_panels, fb["fixr_plan"])
    mul = "add_sat" if weighted else "none"
    before = dict(pk.LAUNCHES)
    xe = (x2d, xe_b, t["xe_plan"], t.get("w_stream"), inf,
          meta.exp_panels + 1, meta.xr_nwin, mul)
    s0 = pk.route_xr_exp(*xe, plan_idx=xe_q, fill_block=fb["xe_plan"])
    assert torch.equal(s0, pk.route_xr_exp_plain(*xe, plan_idx=xe_q))
    pa = (s0, t["pa_bases"], t["pa_plan"], inf, npa, meta.pa_nwin)
    s1 = pk.route_passa(*pa, plan_idx=pa_q, fill_block=fb["pa_plan"])
    assert torch.equal(s1, pk.route_passa_plain(*pa, plan_idx=pa_q))
    fx = (s1, t["fixr_bases"], t["fixr_plan"], t["fix_dst"],
          t["fixr_seg"], meta.nrb, "min", inf, meta.fix_panels,
          meta.fixr_nwin)
    y = pk.route_fold(*fx, plan_idx=fx_q, fill_block=fb["fixr_plan"])
    assert torch.equal(y, pk.route_fold_plain(*fx, plan_idx=fx_q))
    assert {k: pk.LAUNCHES[k] - before[k] for k in before} == {
        "route_xr_exp": 0, "route_passa": 0, "route_fold": 0,
        "hub_fold": 0, "route_xr_exp_gated": 1, "route_passa_gated": 1,
        "route_fold_gated": 1, "route_passa_single": 0, "route_expand": 0,
        "fold_stripes": 0, "colsum_chunks": 0}
    # the gated SpMV equals the static one
    xs = torch.from_numpy(x).to(cuda)
    assert torch.equal(
        tpe.spmv3_local(xs, t, meta, sem, g.part.tile_rows, gate=True),
        tpe.spmv3_local(xs, t, meta, sem, g.part.tile_rows))


@pytest.mark.parametrize("app", ["bfs", "cc", "sssp"])
@pytest.mark.parametrize("gate", ["auto", "1", "0"])
def test_apps_on_cuda_match_cpu(cuda, monkeypatch, gate, app):
    """BFS, CC and SSSP on panel at RMAT-12 equal the CPU's runs, with the
    panel gate (``GRAPHTAP_PANEL_GATE``) on its vote, forced and off: every
    superstep takes the same branch on both, every one gated when forced
    and none when off."""
    monkeypatch.setenv(executor.GATE_ENV, gate)
    n = 1 << 12
    if app == "sssp":
        r, c, w = rmat_edges(12, 16, seed=1, weighted=True)
        g = Graph.from_edges(r, c, w, sssp_config(n))
        run = lambda device: run_sssp(g, 0, kernel="panel", device=device)
    else:
        r, c, _ = rmat_edges(12, 16, seed=1)
        if app == "bfs":
            g = Graph.from_edges(r, c, None, bfs_config(n))
            run = lambda device: run_bfs(g, 0, kernel="panel",
                                         device=device)
        else:
            g = Graph.from_edges(r, c, None, cc_config(n))
            run = lambda device: run_cc(g, kernel="panel", device=device)
    before = dict(pk.LAUNCHES)
    with timing.tracing():
        on_card = run(cuda)
    assert pk.LAUNCHES["hub_fold"] > before["hub_fold"]
    on_cpu = run("cpu")
    assert on_card.iteration == on_cpu.iteration
    branches = [s["gated"] for s in on_card.supersteps]
    assert branches == [s["gated"] for s in on_cpu.supersteps]
    if gate != "auto":
        assert set(branches) == {gate == "1"}
    assert all(s["ms"] > 0 for s in on_card.supersteps)
    a, b = on_card.state_vector(), on_cpu.state_vector()
    for k in b:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("case", ["f32_sum", "f64_sum_w", "i32_min_w",
                                  "i32_min"])
def test_shuffle_kernels_match_plain(cuda, case):
    """K6 (with its two dense-expansion calls), K7 and K8 at RMAT-12
    against their plain versions on the card, and the whole SpMV."""
    n = 1 << 12
    weighted = case.endswith("_w")
    r, c, w = rmat_edges(12, 16, seed=3, weighted=weighted)
    if case.startswith("i32"):
        dtype = np.int32
        sem = tsr.min_plus() if weighted else tsr.min_select()
        cfg = sssp_config(n) if weighted else bfs_config(n)
    else:
        dtype = np.float32 if case == "f32_sum" else np.float64
        sem = tsr.plus_times()
        cfg = GraphConfig(num_vertices=n, transpose=True)
    g = Graph.from_edges(r, c, w, cfg)
    meta = build_shuffle_plans(g.tiled(), value_dtype=dtype)
    t = meta_from_numpy(meta.arrays, cuda)
    rng = np.random.default_rng(1)
    if dtype == np.int32:
        x = rng.integers(0, 1000, size=g.part.tile_cols).astype(dtype)
        x[rng.random(x.size) < 0.3] = tsr.INF_I32
    else:
        x = rng.random(g.part.tile_cols).astype(dtype)
    fill, kind = sem.identity, sem.reduce_kind
    before = dict(sk.LAUNCHES)
    st = spmv_stages(torch.from_numpy(x).to(cuda), t, meta, sem,
                     g.part.tile_rows)
    assert {k: sk.LAUNCHES[k] - before[k] for k in before} == {
        "expand_stream": 3, "group_stream": 1, "grouped_reduce": 1}
    assert torch.equal(st["contrib"], sk.expand_stream_plain(
        st["x3d"], t["grp"], t["slot"], t["lane"], t["ev_x"],
        t.get("w_stream"), fill, mul_kind(meta, sem)))
    for half in ("a", "b"):
        assert torch.equal(st["y" + half], sk.expand_stream_plain(
            st["ytab"], t[f"mexp_grp_{half}"], t[f"mexp_slot_{half}"],
            t["mexp_lane"], t[f"mexp_ev_{half}"], None, fill))
    assert torch.equal(st["grouped"], sk.group_stream_plain(
        st["contrib"], t["frag_dst"], t["frag_idx"], meta.rows_per_super,
        meta.npasses, fill))
    assert torch.equal(st["y_blocks"], sk.grouped_reduce_plain(
        st["grouped"], t["lr"], t["ev_r"], t["chunk_block"], meta.nblocks,
        kind, fill))
    cpu = spmv_stages(torch.from_numpy(x), meta_from_numpy(meta.arrays,
                                                           "cpu"),
                      meta, sem, g.part.tile_rows)["y"]
    if cpu.dtype.is_floating_point:
        torch.testing.assert_close(st["y"].cpu(), cpu,
                                   rtol=FOLD_RTOL[cpu.dtype], atol=0)
    else:
        assert torch.equal(st["y"].cpu(), cpu)


_STREAM_DTYPES = {"f32": (torch.float32, 0.0), "f64": (torch.float64, 0.0),
                  "i32": (torch.int32, tsr.INF_I32)}


@pytest.mark.parametrize("dt", sorted(_STREAM_DTYPES))
def test_group_stream_matches_plain_three_passes(cuda, dt):
    """K7 over three forced radix passes (the RMAT-20 degree plan's count)
    equals the pass-by-pass plain version bit for bit, with its composed
    index given or built, one launch per call."""
    rng = np.random.default_rng(6)
    rows, cols = rng.integers(0, 8000, 30000), rng.integers(0, 3000, 30000)
    plan = build_spmv_plan(rows, cols, None, 8000, 3000, nwin=4,
                           rows_per_super=512, force_npasses=3)
    assert plan.npasses == 3
    dtype, fill = _STREAM_DTYPES[dt]
    shape = (plan.nsupers * plan.rows_per_super, 128)
    c = (torch.from_numpy(rng.random(shape)).to(dtype) if dt != "i32" else
         torch.from_numpy(rng.integers(0, 10000, shape).astype(np.int32)))
    c, fd, fi = (torch.as_tensor(a).to(cuda) for a in (
        c, plan.frag_dst, plan.frag_idx))
    want = sk.group_stream_plain(c, fd, fi, plan.rows_per_super, 3, fill)
    src = sk.group_index(fd, fi, plan.rows_per_super, 3)
    before = sk.LAUNCHES["group_stream"]
    for kw in ({}, {"src": src}):
        assert torch.equal(sk.group_stream(c, fd, fi, plan.rows_per_super,
                                           3, fill, **kw), want)
    assert sk.LAUNCHES["group_stream"] == before + 2
    assert torch.equal(sk.group_gather_plain(c, src, fill), want)


@pytest.mark.parametrize("app", ["bfs", "cc", "sssp"])
def test_apps_shuffle_on_cuda_match_cpu(cuda, app):
    n = 1 << 12
    weighted = app == "sssp"
    r, c, w = rmat_edges(12, 16, seed=1, weighted=weighted)
    cfg = {"bfs": bfs_config, "cc": cc_config, "sssp": sssp_config}[app](n)
    g = Graph.from_edges(r, c, w, cfg)
    run = {"bfs": lambda d: run_bfs(g, 0, kernel="shuffle", device=d),
           "cc": lambda d: run_cc(g, kernel="shuffle", device=d),
           "sssp": lambda d: run_sssp(g, 0, kernel="shuffle", device=d)}[app]
    before = dict(sk.LAUNCHES)
    on_card = run(cuda)
    assert sk.LAUNCHES["grouped_reduce"] - before["grouped_reduce"] == \
        on_card.iteration + 1                     # + the flush
    on_cpu = run("cpu")
    assert on_card.iteration == on_cpu.iteration
    a, b = on_card.state_vector(), on_cpu.state_vector()
    for k in b:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _case_graph(case, n=1 << 12):
    """(graph, value dtype, semiring) of a parity case at RMAT-12."""
    weighted = case.endswith("_w")
    r, c, w = rmat_edges(12, 16, seed=3, weighted=weighted)
    if case.startswith("i32"):
        sem = tsr.min_plus() if weighted else tsr.min_select()
        cfg = sssp_config(n) if weighted else bfs_config(n)
        return Graph.from_edges(r, c, w, cfg), np.int32, sem
    dtype = np.float32 if case == "f32_sum" else np.float64
    return (Graph.from_edges(r, c, w, GraphConfig(num_vertices=n,
                                                  transpose=True)),
            dtype, tsr.plus_times())


def _x(g, dtype, seed=1):
    rng = np.random.default_rng(seed)
    if dtype == np.int32:
        x = rng.integers(0, 1000, size=g.part.tile_cols).astype(dtype)
        x[rng.random(x.size) < 0.3] = tsr.INF_I32
        return x
    return rng.random(g.part.tile_cols).astype(dtype)


def _close(got, want, rtol=None):
    """Floats within ``rtol`` (default: the folds' FOLD_RTOL), ints bit for
    bit."""
    if got.dtype.is_floating_point:
        torch.testing.assert_close(
            got, want, rtol=FOLD_RTOL[got.dtype] if rtol is None else rtol,
            atol=0)
    else:
        assert torch.equal(got, want)


@pytest.mark.parametrize("case", ["f32_sum", "f64_sum_w", "i32_min_w",
                                  "i32_min"])
def test_gather_kernels_match_plain(cuda, case):
    """K9 at each of its six stage calls and K8 at RMAT-12 against their
    plain versions on the card, and the whole v2 SpMV against the CPU."""
    g, dtype, sem = _case_graph(case)
    meta = build_spmv2_meta(g.tiled(), value_dtype=dtype)
    t = meta_from_numpy(meta.arrays, cuda)
    x = _x(g, dtype)
    fill = sem.identity
    before = {**gk.LAUNCHES, **sk.LAUNCHES}
    st = spmv2_stages(torch.from_numpy(x).to(cuda), t, meta, sem,
                      g.part.tile_rows)
    after = {**gk.LAUNCHES, **sk.LAUNCHES}
    assert after["windowed_gather"] - before["windowed_gather"] == 6
    assert after["grouped_reduce"] - before["grouped_reduce"] == 1
    srcs = dict(zip(STAGES, ["x2d", "exp", "p0", "p1", "p2", "y_blocks"]))
    for k in STAGES:
        w = t.get("w_stream") if k == "exp" else None
        mk = mul_kind(meta, sem) if k == "exp" else "none"
        assert torch.equal(st[k], gk.windowed_gather_plain(
            st[srcs[k]], *stage_plan(t, k), w, fill, meta.nsub[k], mk)), k
    assert torch.equal(st["y_blocks"], sk.grouped_reduce_plain(
        st["p3"], t["lr"], t["ev_r"], t["chunk_block"], meta.nblocks,
        sem.reduce_kind, fill))
    cpu = spmv2_stages(torch.from_numpy(x), meta_from_numpy(meta.arrays,
                                                            "cpu"),
                       meta, sem, g.part.tile_rows)["y"]
    _close(st["y"].cpu(), cpu)


# K2 on seeded synthetic routes (its plain version needs no routable
# plan): (npanels, nwin, out_rows, two_layer, share of panels pointed at
# the fill block or None for a static launch)
_PASSA_CASES = {
    "pa12": (300, 12, 64, True, None),          # the corner turn's nwin
    "pa12_gated_all": (300, 12, 64, True, 1.0),   # a 0% frontier
    "pa12_gated_70": (300, 12, 64, True, 0.7),    # a 30% frontier
    "single24": (300, 24, 32, False, None),     # x -> x_ext, unstaged
    "single11": (300, 11, 32, False, None),     # the largest staged f64
    "staged_edge": (300, 17, 64, True, None),   # the largest staged f32
    "wide40": (200, 40, 64, True, None),        # past 32 windows: unstaged
    "one": (1, 12, 64, True, None),
    "many": (1001, 12, 64, True, None),         # not a multiple of the grid
}


def _values(rng, dt, shape):
    if dt == "i32":
        return torch.from_numpy(rng.integers(-1000, 1000, shape).astype(
            np.int32))
    return torch.from_numpy(rng.standard_normal(shape)).to(
        _STREAM_DTYPES[dt][0])


def _route_block(rng, src_rows, out_rows, nsel, nbands):
    """One random plan block: idx1 lanes in [0, 128) (src_rows), nsel sel
    layers of bands in [0, nbands) (out_rows each), idx3 any byte (bit 7
    picks sel_b)."""
    band = rng.integers(0, nbands, (nsel * out_rows, 128))
    sel = band * 8 + rng.integers(0, 8, band.shape)
    return np.concatenate([rng.integers(0, 128, (src_rows, 128)), sel,
                           rng.integers(0, 256, (out_rows, 128))])


def _fill_block(src_rows, out_rows, nsel):
    """The all-fill plan block: every sel 0xF8 (band 31)."""
    return np.concatenate([np.zeros((src_rows, 128)),
                           np.full((nsel * out_rows, 128), 0xF8),
                           np.zeros((out_rows, 128))])


def _windowed(rng, dt, npanels, nwin):
    """A source of 2*nwin + 3 windows and npanels*nwin window bases."""
    nblk = 2 * nwin + 3
    src = _values(rng, dt, (nblk * 8, 128))
    bases = torch.from_numpy(rng.integers(0, nblk, npanels * nwin).astype(
        np.int32))
    return src, bases


def _passa_inputs(rng, dt, npanels, nwin, out_rows, two_layer):
    """src (2*nwin + 3 windows), bases, and a plan of npanels random
    blocks plus an all-fill block (sel 0xF8) at index npanels: idx1 lanes
    in [0, 128), sel bands in [0, nwin] (band nwin, where below 32, is
    the fill), idx3 any byte (bit 7 picks sel_b)."""
    src, bases = _windowed(rng, dt, npanels, nwin)
    nsel = 2 if two_layer else 1
    blocks = [_route_block(rng, nwin * 8, out_rows, nsel, min(nwin + 1, 32))
              for _ in range(npanels)]
    blocks.append(_fill_block(nwin * 8, out_rows, nsel))
    plan = torch.from_numpy(np.concatenate(blocks).astype(np.uint8))
    return src, bases, plan


def _gate(rng, npanels, off, device):
    """plan_idx with a share ``off`` of the panels pointed at the fill
    block (index npanels), the rest at their own blocks."""
    q = np.arange(npanels, dtype=np.int32)
    q[rng.random(npanels) < off] = npanels
    return torch.from_numpy(q).to(device)


def _launched(before):
    return {k: pk.LAUNCHES[k] - before[k] for k in before
            if pk.LAUNCHES[k] != before[k]}


@pytest.mark.parametrize("dt", sorted(_STREAM_DTYPES))
@pytest.mark.parametrize("case", sorted(_PASSA_CASES))
def test_route_passa_forms_match_plain(cuda, case, dt):
    """K2 in each form (staged windows or values from device memory, as
    ``passa_form`` picks from nwin and the value size), static and gated,
    against its plain version bit for bit, one launch per call."""
    npanels, nwin, out_rows, two_layer, off = _PASSA_CASES[case]
    dtype, fill = _STREAM_DTYPES[dt]
    rng = np.random.default_rng(11)
    src, bases, plan = (a.to(cuda) for a in _passa_inputs(
        rng, dt, npanels, nwin, out_rows, two_layer))
    form = pk.passa_form(nwin, out_rows, two_layer, src.element_size())
    assert form == ("unstaged" if case in ("single24", "wide40") or (
        dt == "f64" and two_layer) else "staged"), form
    kw = {"out_rows": out_rows, "two_layer": two_layer}
    key = "route_passa" if two_layer else "route_passa_single"
    if off is not None:
        kw["plan_idx"] = _gate(rng, npanels, off, cuda)
        key = "route_passa_gated"
    args = (src, bases, plan, fill, npanels, nwin)
    before = dict(pk.LAUNCHES)
    got = pk.route_passa(*args, fill_block=npanels if off else None, **kw)
    assert _launched(before) == {key: 1}
    want = pk.route_passa_plain(*args, **kw)
    assert torch.equal(got, want)
    if off == 1.0:
        assert bool((got == fill).all())


# K1 on seeded synthetic routes: (npanels, nwin (None: the largest the
# wrapper admits for the value size), ⊗ kind, share of panels pointed at
# the fill block or None for a static launch)
_XR_EXP_CASES = {
    "nwin24": (300, 24, "none", None),          # every meta's nwin
    "nwin24_mul": (300, 24, "mul", None),
    "nwin24_add_sat": (300, 24, "add_sat", None),
    "gated_all": (300, 24, "mul", 1.0),         # a 0% frontier
    "gated_70": (300, 24, "add_sat", 0.7),      # a 30% frontier
    "one": (1, 24, "none", None),
    "many": (1001, 24, "mul", None),            # not a multiple of the grid
    "limit": (40, None, "add_sat", None),       # nwin 69 (4 B), 61 (8 B)
}


@pytest.mark.parametrize("dt", sorted(_STREAM_DTYPES))
@pytest.mark.parametrize("case", sorted(_XR_EXP_CASES))
def test_route_xr_exp_forms_match_plain(cuda, case, dt):
    """K1 (the plan ring: x -> x_ext into shared memory, then the expand
    route out of it, ⊗ per slot), static and gated, against its plain
    version bit for bit, one launch per call; nwin at the wrapper's
    shared-memory limit, one past it raises."""
    npanels, nwin, mul, off = _XR_EXP_CASES[case]
    dtype, fill = _STREAM_DTYPES[dt]
    es = torch.tensor([], dtype=dtype).element_size()
    if nwin is None:
        nwin = {4: 69, 8: 61}[es]
        with pytest.raises(ValueError, match="route_xr_exp: nwin"):
            pk.xr_exp_smem(nwin + 1, es)
    pk.xr_exp_smem(nwin, es)
    rng = np.random.default_rng(12)
    x2d, bases = _windowed(rng, dt, npanels, nwin)
    blocks = []
    for _ in range(npanels):
        blocks += [_route_block(rng, nwin * 8, 32, 1, min(nwin + 1, 32)),
                   _route_block(rng, 32, 64, 2, 6)]    # bands 4, 5: fill
    blocks += [_fill_block(nwin * 8, 32, 1), _fill_block(32, 64, 2)]
    plan = torch.from_numpy(np.concatenate(blocks).astype(np.uint8))
    w = _values(rng, dt, ((npanels + 1) * 64, 128))
    x2d, bases, plan, w = (a.to(cuda) for a in (x2d, bases, plan, w))
    kw, key = {}, "route_xr_exp"
    if off is not None:
        kw["plan_idx"] = _gate(rng, npanels, off, cuda)
        key = "route_xr_exp_gated"
    args = (x2d, bases, plan, None if mul == "none" else w, fill, npanels,
            nwin, mul)
    before = dict(pk.LAUNCHES)
    got = pk.route_xr_exp(*args, fill_block=npanels if off else None, **kw)
    assert _launched(before) == {key: 1}
    assert torch.equal(got, pk.route_xr_exp_plain(*args, **kw))
    if off == 1.0:               # fill ⊗ the fill block's weights
        assert torch.equal(got, (fill * w[npanels * 64:]).to(dtype).repeat(
            npanels, 1))


# K11 on seeded synthetic routes: (npanels, ⊗ kind)
_EXPAND_CASES = {
    "none": (300, "none"),
    "mul": (300, "mul"),
    "add_sat": (300, "add_sat"),
    "one": (1, "mul"),
    "many": (1001, "add_sat"),              # past the persistent grid
}


@pytest.mark.parametrize("dt", sorted(_STREAM_DTYPES))
@pytest.mark.parametrize("case", sorted(_EXPAND_CASES))
def test_route_expand_forms_match_plain(cuda, case, dt):
    """K11 (K1's plan ring: each panel's plan block and x_ext block staged
    by TMA, K1's expand stage) against its plain version bit for bit, one
    launch per call, the same bits on a second call; fill slots where a
    sel names band 4 or 5 of the 4-band x_ext panel. Its two stages fit
    two blocks an SM for 4-byte values, one for 8-byte."""
    npanels, mul = _EXPAND_CASES[case]
    dtype, fill = _STREAM_DTYPES[dt]
    itemsize = torch.empty((), dtype=dtype).element_size()
    assert pk.ring_blocks_per_sm("route_expand", dtype) == {
        4: 2, 8: 1}[itemsize]
    rng = np.random.default_rng(13)
    x_ext = _values(rng, dt, (npanels * 32, 128))
    plan = torch.from_numpy(np.concatenate(
        [_route_block(rng, 32, 64, 2, 6) for _ in range(npanels)]).astype(
        np.uint8))
    w = _values(rng, dt, (npanels * 64, 128))
    x_ext, plan, w = (a.to(cuda) for a in (x_ext, plan, w))
    args = (x_ext, plan, None if mul == "none" else w, fill, npanels, mul)
    before = dict(pk.LAUNCHES)
    got = pk.route_expand(*args)
    assert _launched(before) == {"route_expand": 1}
    want = pk.route_expand_plain(*args)
    assert bool((want == fill).any()) or mul != "none"
    assert torch.equal(got, want)
    assert torch.equal(pk.route_expand(*args), got)


# K3 on seeded synthetic routes: (npanels, nwin, share of panels pointed at
# the fill block or None for a static launch)
_FOLD_CASES = {
    "fixr31": (300, 31, None),                  # RMAT-20's fixr nwin
    "fix2_28": (300, 28, None),                 # and its fix2 nwin
    "one_stage": (60, 100, None),               # one plan block fits
    "limit": (20, 202, None),                   # the last nwin that fits
    "gated_all": (300, 31, 1.0),                # a 0% frontier
    "gated_70": (300, 31, 0.7),                 # a 30% frontier
    "one": (1, 31, None),
    "many": (1001, 31, None),                   # not a multiple of the grid
}
_FOLD_KINDS = {"f32_sum": ("f32", "sum", 0.0), "f64_sum": ("f64", "sum", 0.0),
               "i32_sum": ("i32", "sum", 0),
               "i32_min": ("i32", "min", tsr.INF_I32),
               "i32_max": ("i32", "max", -tsr.INF_I32)}


@pytest.mark.parametrize("kind", sorted(_FOLD_KINDS))
@pytest.mark.parametrize("case", sorted(_FOLD_CASES))
def test_route_fold_forms_match_plain(cuda, case, kind):
    """K3 (pass (a) on the plan ring, two stages or one as fold_stages
    picks from nwin, then the fixed-order pass (b)), static and gated,
    against its plain version bit for bit, one launch per call, and the
    same bits on a second call; one nwin past the limit raises."""
    npanels, nwin, off = _FOLD_CASES[case]
    dt, red, fill = _FOLD_KINDS[kind]
    assert pk.fold_stages(nwin) == (2 if nwin <= 89 else 1)
    if case == "limit":
        with pytest.raises(ValueError, match="route_fold: nwin"):
            pk.fold_stages(nwin + 1)
    rng = np.random.default_rng(13)
    src, bases, plan = (a.to(cuda) for a in _passa_inputs(
        rng, dt, npanels, nwin, 64, True))
    nrows = 2 * 8192                             # two fold segments
    dst = torch.from_numpy(rng.integers(0, 50, npanels * 8).astype(
        np.int32)).to(cuda)                      # many bands a y row
    seg = torch.from_numpy(rng.integers(0, 2, npanels).astype(
        np.int32)).to(cuda)
    kw, key = {}, "route_fold"
    if off is not None:
        kw["plan_idx"] = _gate(rng, npanels, off, cuda)
        key = "route_fold_gated"
    args = (src, bases, plan, dst, seg, nrows, red, fill, npanels, nwin)
    before = dict(pk.LAUNCHES)
    got = pk.route_fold(*args, fill_block=npanels if off else None, **kw)
    assert _launched(before) == {key: 1}
    assert torch.equal(got, pk.route_fold_plain(*args, **kw))
    assert torch.equal(got, pk.route_fold(
        *args, fill_block=npanels if off else None, **kw))
    if off == 1.0:
        assert bool((got == fill).all())


def _k9_edge_plan(rng, nsub=6, nwin=20):
    """Five 8-row steps over nwin source windows: nact 0, nact 3 < nsub,
    nact = nsub, nact 9 > nsub, and nsub with a tenth of its slots
    SID_INVALID; every step's sids run to nsub + 1, past its live ones."""
    nact = np.array([0, 3, nsub, 9, nsub], np.int32)
    nsteps = nact.size
    wsel = rng.integers(0, nwin, nsteps * nsub).astype(np.int32)
    base = (np.arange(nsteps) * nsub).astype(np.int32)
    cidx = rng.integers(0, 128, (nsteps * nsub, 8, 128)).astype(np.int8)
    sid = rng.integers(0, nsub + 2, (nsteps, 8, 128))
    sid[-1][rng.random((8, 128)) < 0.1] = gk.SID_INVALID
    meta = (sid * 8 + rng.integers(0, 8, sid.shape)).astype(np.uint8)
    return nwin * 8, [torch.from_numpy(a) for a in (wsel, base, nact, cidx,
                                                    meta)]


@pytest.mark.parametrize("mul", ["none", "mul", "add_sat"])
@pytest.mark.parametrize("dt", sorted(_STREAM_DTYPES))
def test_windowed_gather_edges_match_plain(cuda, dt, mul):
    """K9 against its plain version bit for bit on nact 0, nact below,
    at and above nsub and SID_INVALID slots, under each ⊗ (add_sat from
    the min-plus fill); a 0-step stage launches nothing."""
    rng = np.random.default_rng(12)
    dtype = _STREAM_DTYPES[dt][0]
    fill = {"add_sat": float("inf"), "mul": 1.0, "none": 0.0}[mul]
    if dt == "i32":
        fill = tsr.INF_I32 if mul == "add_sat" else int(fill)
    rows, plan = _k9_edge_plan(rng)
    src = _values(rng, dt, (rows, 128)).to(cuda)
    plan = [a.to(cuda) for a in plan]
    w = None if mul == "none" else _values(rng, dt, (5, 8, 128)).to(cuda)
    before = gk.LAUNCHES["windowed_gather"]
    got = gk.windowed_gather(src, *plan, w, fill, 6, mul)
    assert gk.LAUNCHES["windowed_gather"] == before + 1
    assert torch.equal(got, gk.windowed_gather_plain(src, *plan, w, fill, 6,
                                                     mul))
    empty = [a[:0] for a in plan[:3]] + [plan[3], plan[4][:0]]
    out = gk.windowed_gather(src, *empty, None if w is None else w[:0],
                             fill, 6, mul)
    assert out.shape == (0, 128)
    assert gk.LAUNCHES["windowed_gather"] == before + 1


def _k10_plans():
    """(source rows, 64-row plan, src_of) of two K10 cases: the mx stage
    of an RMAT-12 v2 plan, re-planned with 64-row steps from the stage's
    own source index; and four synthetic steps over 40 source windows: no
    live slot (nact 0), half the slots from 5 windows, every slot from 30
    windows (nsub 30), and 40% of the slots from 3 windows at random
    source lanes (conflict layers). Holes hold SID_INVALID."""
    g, dtype, sem = _case_graph("f32_sum")
    meta = build_spmv2_meta(g.tiled(), value_dtype=dtype)
    t = meta_from_numpy(meta.arrays, "cpu")
    src_of = gk.gather_index(*stage_plan(t, "mx"),
                             meta.nsub["mx"]).reshape(-1).numpy()
    rows = gk.seg_round_rows64(meta.out_rows["mx"])
    src_of = np.concatenate([src_of, np.full(rows * 128 - src_of.size, -1)])
    mx_rows = stage_src_rows(meta, "mx")
    cases = [(mx_rows, build_gather_plan(mx_rows, rows, src_of,
                                         block_rows=gk.BLK64), src_of)]
    rng = np.random.default_rng(5)
    nwin, step = 40, gk.BLK64 * 128
    lane = np.tile(np.arange(128), gk.BLK64)
    src_of = np.full(4 * step, -1, np.int64)
    for i, (wins, live, free_lane) in enumerate(
            ((0, 0.0, False), (5, 0.5, False), (30, 1.0, False),
             (3, 0.4, True))):
        if not wins:
            continue
        b = rng.permutation(nwin)[:wins][rng.integers(0, wins, step)]
        j = rng.integers(0, 8, step)
        cl = (rng.integers(0, 128, step) if free_lane
              else (7 * lane + 3 * b + j) % 128)
        s = (b * 8 + j) * 128 + cl
        s[rng.random(step) >= live] = -1
        src_of[i * step:(i + 1) * step] = s
    plan = build_gather_plan(nwin * 8, 4 * gk.BLK64, src_of,
                             block_rows=gk.BLK64)
    assert plan.nsub == 30 and list(plan.nact[:3]) == [0, 5, 30]
    assert 0 < plan.nact[3] < 30
    cases.append((nwin * 8, plan, src_of))
    return cases


@pytest.mark.parametrize("dt", sorted(_STREAM_DTYPES))
def test_windowed_gather64_matches_plain(cuda, dt):
    """K10 (the shared-memory ring) against its plain version bit for bit,
    one launch per call, on both ``_k10_plans`` cases; and one K9 call on
    an 8-row plan of the synthetic source index, unchanged."""
    dtype, fill = _STREAM_DTYPES[dt]
    rng = np.random.default_rng(2)
    for src_rows, plan, src_of in _k10_plans():
        src = torch.from_numpy(rng.random((src_rows, 128))).to(dtype) \
            if dt != "i32" else torch.from_numpy(
                rng.integers(0, 10000, (src_rows, 128)).astype(np.int32))
        src = src.to(cuda)
        args = [torch.from_numpy(a).to(cuda) for a in (
            plan.wsel, plan.base, plan.nact, plan.cidx, plan.meta)]
        before = gk.LAUNCHES["windowed_gather64"]
        got = gk.windowed_gather64(src, *args, fill, plan.nsub)
        assert gk.LAUNCHES["windowed_gather64"] == before + 1
        assert torch.equal(got, gk.windowed_gather64_plain(
            src, *args, fill, plan.nsub))
        valid = torch.from_numpy(src_of >= 0).to(cuda)
        idx = torch.from_numpy(src_of).to(cuda)
        assert torch.equal(got.view(-1)[valid], src.view(-1)[idx[valid]])
        assert bool((got.view(-1)[~valid] == fill).all())
    # K9 keeps its own kernel: an 8-row plan of the same source index
    plan8 = build_gather_plan(src_rows, src_of.size // 128, src_of)
    args8 = [torch.from_numpy(a).to(cuda) for a in (
        plan8.wsel, plan8.base, plan8.nact, plan8.cidx, plan8.meta)]
    before = dict(gk.LAUNCHES)
    got8 = gk.windowed_gather(src, *args8, None, fill, plan8.nsub)
    assert gk.LAUNCHES == {**before, "windowed_gather":
                           before["windowed_gather"] + 1}
    assert torch.equal(got8, gk.windowed_gather_plain(
        src, *args8, None, fill, plan8.nsub))
    assert torch.equal(got8.view(-1), got.view(-1))


@pytest.mark.parametrize("case", ["f32_sum", "f64_sum_w", "i32_min_w",
                                  "i32_min"])
def test_onehot_matches_plain(cuda, case):
    """K5 at RMAT-12 against its plain version on the card, and the whole
    one-hot SpMV against the CPU."""
    g, dtype, sem = _case_graph(case)
    ts = g.tiled()
    plan = oh.build_onehot_plan(ts)
    t = meta_from_numpy(plan.arrays, cuda)
    x = torch.from_numpy(_x(g, dtype)).to(cuda)
    c = oh.onehot_contrib(x, t, sem)
    args = (c, t["oh_lrows"], t["oh_chunk_block"], plan.nblocks, ts.NR,
            sem.reduce_kind, sem.identity)
    before = oh.LAUNCHES["segment_reduce"]
    got = oh.segment_reduce(*args)
    assert oh.LAUNCHES["segment_reduce"] == before + 1
    assert torch.equal(got, oh.segment_reduce_plain(*args))
    cpu = oh.spmv_onehot(x.cpu(), meta_from_numpy(plan.arrays, "cpu"), plan,
                         sem, ts.NR)
    _close(oh.spmv_onehot(x, t, plan, sem, ts.NR).cpu(), cpu)


@pytest.mark.parametrize("kernel", ["shuffle2", "onehot"])
@pytest.mark.parametrize("app", ["bfs", "cc", "sssp"])
def test_apps_new_kernels_on_cuda_match_cpu(cuda, app, kernel):
    n = 1 << 12
    weighted = app == "sssp"
    r, c, w = rmat_edges(12, 16, seed=1, weighted=weighted)
    cfg = {"bfs": bfs_config, "cc": cc_config, "sssp": sssp_config}[app](n)
    g = Graph.from_edges(r, c, w, cfg)
    run = {"bfs": lambda d: run_bfs(g, 0, kernel=kernel, device=d),
           "cc": lambda d: run_cc(g, kernel=kernel, device=d),
           "sssp": lambda d: run_sssp(g, 0, kernel=kernel, device=d)}[app]
    on_card = run(cuda)
    on_cpu = run("cpu")
    assert on_card.iteration == on_cpu.iteration
    a, b = on_card.state_vector(), on_cpu.state_vector()
    for k in b:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("dtype,weighted", [(np.float32, False),
                                            (np.float64, True),
                                            (np.int32, True)])
def test_staged_kernels_match_plain(cuda, dtype, weighted):
    """The staged SpMV at RMAT-12: K2 single-layer, K11, K13 (and K12 on
    its stack1) against their plain versions; K11's s0 equals the fused
    K1's, and the staged y_mid and y the fused ones."""
    sem = tsr.min_plus() if dtype == np.int32 else tsr.plus_times()
    r, c, w = rmat_edges(12, 16, seed=3, weighted=weighted)
    g = Graph.from_edges(r, c, w, GraphConfig(num_vertices=1 << 12,
                                              transpose=True))
    meta = build_spmv3_meta(g.tiled(), value_dtype=dtype)
    t = staged_tables(meta_from_numpy(meta.arrays, cuda), meta)
    rng = np.random.default_rng(1)
    if dtype == np.int32:
        x = rng.integers(0, 1000, size=g.part.tile_cols).astype(dtype)
        x[rng.random(x.size) < 0.3] = tsr.INF_I32
    else:
        x = rng.random(g.part.tile_cols).astype(dtype)
    x = torch.from_numpy(x).to(cuda)
    before = dict(pk.LAUNCHES)
    st = spmv3_staged_stages(x, t, meta, sem, g.part.tile_rows)
    assert {k: pk.LAUNCHES[k] - before[k] for k in before
            if pk.LAUNCHES[k] != before[k]} == {
        "route_passa_single": 1, "route_expand": 1, "route_passa": 2,
        "colsum_chunks": 1, "hub_fold": 1, "route_fold": 1}
    fused = spmv3_stages(x, t, meta, sem, g.part.tile_rows)
    fill, kind = sem.identity, sem.reduce_kind
    nxe = meta.exp_panels + 1
    mul = ("mul" if kind == "sum" else "add_sat") if weighted else "none"
    assert torch.equal(st["x_ext"], pk.route_passa_plain(
        st["x2d"], t["xr_bases"], t["xr_plan"], fill, nxe, meta.xr_nwin,
        out_rows=pk.XROWS, two_layer=False))
    assert torch.equal(st["s0"], pk.route_expand_plain(
        st["x_ext"], t["exp_plan"], t.get("w_stream"), fill, nxe, mul))
    assert torch.equal(st["s0"], fused["s0"])
    assert torch.equal(st["stack1"], pk.route_passa_plain(
        st["s1"], t["fixr_bases"], t["fixr_plan"], fill, meta.fix_panels,
        meta.fixr_nwin))
    assert torch.equal(st["y_mid"], pk.colsum_chunks_plain(
        st["stack1"], t["chunk_dst"], meta.nrb, kind, fill))
    _close(st["y_mid"], fused["y_mid"])
    _close(st["y"], fused["y"])
    for red in ("sum", "min", "max"):
        got = pk.fold_stripes(st["stack1"], red, meta.fix_panels)
        _close(got, pk.fold_stripes_plain(st["stack1"], red,
                                          meta.fix_panels), 1e-6)


def test_staged_kernels_reject_bad_arguments(cuda):
    x = torch.zeros((64, 128), device=cuda)
    with pytest.raises(ValueError):
        pk.colsum_chunks(x, torch.zeros(8, dtype=torch.int32, device=cuda),
                         8, "min", 0.0)           # floats take sum only
    with pytest.raises(ValueError):
        pk.fold_stripes(x, "sum", 2)              # 2 panels need 128 rows
    with pytest.raises(ValueError):
        pk.route_expand(x, torch.zeros((224, 128), dtype=torch.uint8),
                        None, 0.0, 2)             # plan on another device


@pytest.mark.parametrize("dtype,kind", [(torch.float32, "sum"),
                                        (torch.float64, "sum"),
                                        (torch.int32, "min"),
                                        (torch.int32, "max")])
def test_colsum_chunks_ascending_order(cuda, dtype, kind):
    """K13 on 3,000 chunks: three long rows of about 960 chunks (past
    COLSUM_LONG, on blocks of their own, several shared-memory tiles
    each), 37 short rows of 2-3 and one with none, values spread over
    eight decades: twice the same bits, equal to the plain version
    (ascending chunk order) bit for bit; the same with the lists built
    by the wrapper."""
    rng = np.random.default_rng(15)
    nblocks = 41
    dst = np.concatenate([rng.integers(0, 3, 2900),
                          rng.integers(3, nblocks - 1, 100)])
    rng.shuffle(dst)
    nchunks = dst.size
    dst = torch.from_numpy(dst.astype(np.int32))
    if dtype == torch.int32:
        stack = torch.from_numpy(rng.integers(
            -10**6, 10**6, (nchunks * 8, 128), dtype=np.int32))
        fill = tsr.INF_I32 if kind == "min" else -2**31
    else:
        stack = torch.from_numpy(
            rng.standard_normal((nchunks * 8, 128))
            * 10.0 ** rng.uniform(-4, 4, (nchunks * 8, 1))).to(dtype)
        fill = 0.0
    stack, dst = stack.to(cuda), dst.to(cuda)
    lists = pk.colsum_lists(dst, nblocks)
    assert lists[2].tolist() == [0, 1, 2]
    y = _twice_equal(
        lambda: pk.colsum_chunks(stack, dst, nblocks, kind, fill,
                                 lists=lists),
        lambda: pk.colsum_chunks_plain(stack, dst, nblocks, kind, fill))
    assert torch.equal(pk.colsum_chunks(stack, dst, nblocks, kind, fill), y)
    assert torch.equal(y.cpu(), pk.colsum_chunks_plain(
        stack.cpu(), dst.cpu(), nblocks, kind, fill))


def test_entry_step_equals_plain_step(cuda):
    """graft_entry.entry() on the card: K1-K4 launched 1, 1, 2, 1 times,
    the step equal to the same step on the plain versions on the card bit
    for bit, its sum within 1e-5 of the JAX entry step's 1100.7751."""
    from graphtap_tpu_torch import graft_entry
    step, args = graft_entry.entry("cuda")
    pstep, pargs = graft_entry.entry("cuda", plain=True)
    before = dict(pk.LAUNCHES)
    out = step(*args)
    assert {k: pk.LAUNCHES[k] - before[k] for k in before
            if pk.LAUNCHES[k] != before[k]} == {
        "route_xr_exp": 1, "route_passa": 1, "route_fold": 2, "hub_fold": 1}
    assert torch.equal(out, pstep(*pargs))
    assert abs(float(out.sum()) - 1100.7751) <= 1e-5 * 1100.7751


def _twice_equal(call, plain):
    """Two launches give the same bits, and those of the plain version."""
    a, b = call(), call()
    assert torch.equal(a, b)
    assert torch.equal(a, plain())
    return a


@pytest.mark.parametrize("kernel", ["route_fold", "route_fold_gated",
                                    "segment_reduce", "grouped_reduce"])
def test_float_folds_deterministic(cuda, kernel):
    """K3 (static and gated), K5 and K8 on RMAT-14 f32 PageRank-like
    inputs, called twice: bit-identical y, equal to the plain version."""
    n = 1 << 14
    r, c, _ = rmat_edges(14, 16, seed=1)
    g = Graph.from_edges(r, c, None, GraphConfig(num_vertices=n,
                                                 transpose=True))
    sem = tsr.plus_times()
    x = torch.from_numpy(_x(g, np.float32)).to(cuda)
    if kernel.startswith("route_fold"):
        meta = build_spmv3_meta(g.tiled(), value_dtype=np.float32)
        t = meta_from_numpy(meta.arrays, cuda)
        st = spmv3_stages(x, t, meta, sem, g.part.tile_rows)
        fx = (st["s1"], t["fixr_bases"], t["fixr_plan"], t["fix_dst"],
              t["fixr_seg"], meta.nrb, "sum", 0.0, meta.fix_panels,
              meta.fixr_nwin)
        kw, pkw = {}, {}
        if kernel == "route_fold_gated":
            q = np.arange(meta.fix_panels, dtype=np.int32)
            q[np.random.default_rng(4).random(q.size) < 0.3] = \
                fill_blocks(meta)["fixr_plan"]
            pkw = {"plan_idx": torch.from_numpy(q).to(cuda)}
            kw = {**pkw, "fill_block": fill_blocks(meta)["fixr_plan"]}
        before = pk.LAUNCHES[kernel]
        _twice_equal(lambda: pk.route_fold(*fx, **kw),
                     lambda: pk.route_fold_plain(*fx, **pkw))
        assert pk.LAUNCHES[kernel] == before + 2
        f2 = (st["y_hub"], t["f2_bases"], t["f2_plan"], t["fix2_dst"],
              t["f2_seg"], meta.f2_rows, "sum", 0.0, meta.f2_panels,
              meta.f2_nwin)
        _twice_equal(lambda: pk.route_fold(*f2),
                     lambda: pk.route_fold_plain(*f2))
    elif kernel == "segment_reduce":
        ts = g.tiled()
        plan = oh.build_onehot_plan(ts)
        t = meta_from_numpy(plan.arrays, cuda)
        args = (oh.onehot_contrib(x, t, sem), t["oh_lrows"],
                t["oh_chunk_block"], plan.nblocks, ts.NR, "sum", 0.0)
        before = oh.LAUNCHES[kernel]
        _twice_equal(lambda: oh.segment_reduce(*args),
                     lambda: oh.segment_reduce_plain(*args))
        assert oh.LAUNCHES[kernel] == before + 2
    else:
        for build in (build_shuffle_plans, build_spmv2_meta):
            meta = build(g.tiled(), value_dtype=np.float32)
            t = meta_from_numpy(meta.arrays, cuda)
            st = (spmv_stages if build is build_shuffle_plans
                  else spmv2_stages)(x, t, meta, sem, g.part.tile_rows)
            src = st["grouped"] if "grouped" in st else st["p3"]
            args = (src, t["lr"], t["ev_r"], t["chunk_block"], meta.nblocks,
                    "sum", 0.0)
            before = sk.LAUNCHES[kernel]
            _twice_equal(lambda: sk.grouped_reduce(*args),
                         lambda: sk.grouped_reduce_plain(*args))
            assert sk.LAUNCHES[kernel] == before + 2


@pytest.mark.parametrize("kernel,comp", [
    ("scan", Compression.TCSC), ("onehot", Compression.TCSC),
    ("shuffle2", Compression.TCSC), ("panel", Compression.TCSC),
    ("onehot", Compression.TCSC_CF)])
def test_f32_pagerank_converges(cuda, monkeypatch, kernel, comp):
    """f32 execute(0) at RMAT-12 settles on the card (a guard of 2000
    iterations stands in for the executor's 2**20), within 2 iterations
    of the same run on the CPU and its checksum within 1e-4 relative."""
    monkeypatch.setattr(executor, "MAX_CONVERGENCE_ITERS", 2000)
    r, c, _ = rmat_edges(12, 16, seed=1)
    g = Graph.from_edges(r, c, None, GraphConfig(
        num_vertices=1 << 12, transpose=True, compression=comp))
    on_card = run_pagerank(g, 0, torch.float32, kernel=kernel, device=cuda,
                           degree_kernel="scan")
    assert on_card.iteration < 2000
    on_cpu = run_pagerank(g, 0, torch.float32, kernel=kernel, device="cpu",
                          degree_kernel="scan")
    assert abs(on_card.iteration - on_cpu.iteration) <= 2
    a, b = on_card.checksum()[0], on_cpu.checksum()[0]
    assert abs(a - b) <= 1e-4 * abs(b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.int8])
def test_probe_copy_matches_plain(cuda, dtype):
    """P1 (TMA chunk copies) equals x.clone() bit for bit on the table's
    tile shapes and on 16-byte segments, a tile taller than one chunk,
    fewer tiles than SMs, one tile, and segments wider than a chunk."""
    x = torch.randint(-100, 100, (512, 1024), device=cuda).to(dtype)
    b16 = 16 // x.element_size()
    shapes = [((512, 1024), 8, 1024), ((512, 1024), 64, 128),
              ((512, 1024), 256, 512), ((512, 1024), 64, b16),
              ((512, 1024), 512, b16), ((512, 1024), 256, 1024),
              ((512, 1024), 512, 1024), ((16, 16384), 16, 16384),
              ((24, 12288), 8, 12288)]
    before = bw_probe.LAUNCHES["copy_blocks"]
    for shape, bm, bn in shapes:
        xs = x.reshape(shape) if shape == x.shape else torch.randint(
            -100, 100, shape, device=cuda).to(dtype)
        assert torch.equal(bw_probe.copy_blocks(xs, bm, bn),
                           bw_probe.copy_blocks_plain(xs, bm, bn)), (
            shape, bm, bn)
    assert bw_probe.LAUNCHES["copy_blocks"] == before + len(shapes)
    out, gbs = bw_probe.copy_1d(64, 1024, dtype, device=cuda,
                                target_bytes=1 << 22)
    assert gbs > 0 and bool(torch.all(out == 1))


@pytest.mark.parametrize("nstreams", [2, 4])
def test_probe_stream_sum_matches_plain(cuda, nstreams):
    xs = [torch.rand(256, 1024, device=cuda) for _ in range(nstreams)]
    before = bw_probe.LAUNCHES["stream_sum"]
    assert torch.equal(bw_probe.stream_sum(xs),
                       bw_probe.stream_sum_plain(xs))
    assert bw_probe.LAUNCHES["stream_sum"] == before + 1
    out, gbs = bw_probe.multi_stream_sum(nstreams, device=cuda,
                                         target_bytes=1 << 22)
    assert gbs > 0
    assert float(out[0, 0]) == 1 + bw_probe.NCHAIN * sum(
        range(2, nstreams + 1))


@pytest.mark.parametrize("nwin", [1, 4, 20, 31])
def test_probe_route_like_matches_plain(cuda, nwin):
    rng = np.random.default_rng(nwin)
    x = torch.from_numpy(rng.standard_normal((512 * 8, 128)).astype(
        np.float32)).to(cuda)
    b = torch.from_numpy(rng.integers(0, 512, 40 * nwin).astype(
        np.int32)).to(cuda)
    before = route_cost_probe.LAUNCHES["route_like"]
    got = route_cost_probe.route_like(x, b, 40, nwin)
    assert route_cost_probe.LAUNCHES["route_like"] == before + 1
    assert torch.equal(got, route_cost_probe.route_like_plain(x, b, 40, nwin))
    _, us = route_cost_probe.measure(64, nwin)
    assert us > 0


# K6's synthetic plan: 1-step runs, a long run, all-invalid steps, the
# last window (Sx3 - 1) and a window read again after a gap
_K6_GRP = [0, 3] + [5] * 11 + [3, 3, 9, 9, 9, 0, 2]
_K6_EMPTY_STEPS = (4, 16)
_K6_WINDOWS = 10


def _k6_plan(rng):
    """(grp, slot, lane, ev) of the synthetic K6 plan: ev set on about
    half the slots, none in _K6_EMPTY_STEPS, and whole 4-slot groups unset
    besides."""
    rows = len(_K6_GRP) * 8
    slot = rng.integers(0, 64, (rows, 128)).astype(np.int8)
    lane = rng.integers(0, 128, (rows, 128)).astype(np.int8)
    ev = (rng.random((rows, 128)) < 0.5).astype(np.int8)
    ev.reshape(-1, 4)[rng.random(rows * 32) < 0.2] = 0
    for s in _K6_EMPTY_STEPS:
        ev[s * 8:(s + 1) * 8] = 0
    return [torch.from_numpy(a) for a in (np.array(_K6_GRP, np.int32), slot,
                                          lane, ev)]


@pytest.mark.parametrize("mul", ["none", "mul", "add_sat"])
@pytest.mark.parametrize("dt", sorted(_STREAM_DTYPES))
def test_expand_stream_edges_match_plain(cuda, dt, mul):
    """K6 against its plain version bit for bit, in f32, f64 and int32
    under each ⊗ (add_sat from the min-plus fill, with x values at the
    fill), on 1-step runs, a long run, all-invalid steps and 4-slot
    groups, the last window and a window read again after a gap; twice
    with the same bits."""
    rng = np.random.default_rng(6)
    fill = {"add_sat": float("inf"), "mul": 1.0, "none": 0.0}[mul]
    if dt == "i32":
        fill = tsr.INF_I32 if mul == "add_sat" else int(fill)
    x3d = _values(rng, dt, (_K6_WINDOWS, 64, 128))
    if mul == "add_sat":
        x3d.view(-1)[torch.from_numpy(rng.random(x3d.numel()) < 0.1)] = fill
    x3d = x3d.to(cuda)
    plan = [a.to(cuda) for a in _k6_plan(rng)]
    w = None if mul == "none" else _values(
        rng, dt, tuple(plan[1].shape)).to(cuda)
    args = (x3d, *plan, w, fill, mul)
    before = sk.LAUNCHES["expand_stream"]
    got = sk.expand_stream(*args)
    assert sk.LAUNCHES["expand_stream"] == before + 1
    assert torch.equal(got, sk.expand_stream_plain(*args))
    assert torch.equal(got, sk.expand_stream(*args))
    for s in _K6_EMPTY_STEPS:
        assert bool((got[s * 8:(s + 1) * 8] == fill).all())


@pytest.mark.parametrize("nstreams", [2, 4])
def test_probe_stream_sum_partial_chunk(cuda, nstreams):
    """P2 against its plain version bit for bit on shapes whose last 16 KB
    chunk is partial: (250, 1024) in (2, 1024) blocks and (63, 132) in
    (9, 132) blocks (two chunks and 496 bytes)."""
    gen = torch.Generator(device=cuda).manual_seed(nstreams)
    for shape, bm in (((250, 1024), 2), ((63, 132), 9)):
        xs = [torch.randn(shape, device=cuda, generator=gen)
              for _ in range(nstreams)]
        before = bw_probe.LAUNCHES["stream_sum"]
        assert torch.equal(bw_probe.stream_sum(xs, bm),
                           bw_probe.stream_sum_plain(xs)), shape
        assert bw_probe.LAUNCHES["stream_sum"] == before + 1


def _k5_chunks(rng, dt, ident):
    """K5 input of 200 chunks over 9 row blocks: block 1 of 150 chunks
    (three runs of GROUP in pass (b)), among them 20 one-lane chunks (hub
    rows) and 30 of random lanes (the general path); every block's last
    chunk ends in a padding tail of lane 0 and the identity; an
    all-padding chunk; block 7 with no chunk."""
    from graphtap_tpu_torch.kernels.onehot_spmv import CHUNK
    counts = [5, 150, 12, 1, 3, 20, 8, 0, 1]
    cb = np.repeat(np.arange(len(counts)), counts).astype(np.int32)
    nchunks = cb.size
    lr = np.sort(rng.integers(0, 128, (nchunks, CHUNK)), 1)
    lr[10:30] = rng.integers(0, 128, (20, 1))           # one lane each
    lr[40:70] = rng.integers(0, 128, (30, CHUNK))       # unsorted
    c = _values(rng, dt, (nchunks, CHUNK))
    ends = np.cumsum(counts)[np.array(counts) > 0] - 1
    for i, cut in zip(ends, rng.integers(1, CHUNK, ends.size)):
        lr[i, cut:] = 0
        c[i, cut:] = ident
    lr[170], c[170] = 0, ident                          # all padding
    return (c.reshape(-1), torch.from_numpy(lr.reshape(-1).astype(np.int32)),
            torch.from_numpy(cb), len(counts))


def _k8_chunks(rng, dt, ident):
    """K8 input of 200 8-row chunks over 9 row blocks in no order: ev set
    on 60% of slots with 30% of the 4-slot groups all invalid, 20 chunks
    with no valid slot (left out of the list), two one-lane chunks, block
    4 with no live chunk and block 7 with no chunk; a block of 70 live
    chunks (two runs of GROUP)."""
    nchunks, nblocks = 200, 9
    cb = rng.choice(np.array([0, 1, 2, 3, 5, 6, 8]), nchunks)
    cb[:70] = 6
    cb[100:103] = 4
    cb = rng.permutation(cb).astype(np.int32)
    ev = (rng.random((nchunks, 1024)) < 0.6).astype(np.int8)
    ev.reshape(-1, 4)[rng.random(nchunks * 256) < 0.3] = 0
    ev[rng.choice(nchunks, 20, replace=False)] = 0
    ev[cb == 4] = 0
    lr = rng.integers(0, 128, (nchunks, 1024)).astype(np.int8)
    lr[:2] = 77
    c = _values(rng, dt, (nchunks * 8, 128))
    return (c, torch.from_numpy(lr.reshape(-1, 128)),
            torch.from_numpy(ev.reshape(-1, 128)), torch.from_numpy(cb),
            nblocks)


@pytest.mark.parametrize("kind", sorted(_FOLD_KINDS))
@pytest.mark.parametrize("kernel", ["segment_reduce", "grouped_reduce"])
def test_chunk_folds_match_plain(cuda, kernel, kind):
    """K5 and K8 equal their plain versions bit for bit, twice, and the
    CPU, on hub chunks, sorted and unsorted K5 chunks, padding tails, an
    all-padding chunk, K8's all-invalid 4-slot groups and chunks, and row
    blocks with no chunk, for every value type and ⊕."""
    dt, red, ident = _FOLD_KINDS[kind]
    rng = np.random.default_rng(11)
    if kernel == "segment_reduce":
        c, lr, cb, nblocks = _k5_chunks(rng, dt, ident)
        args = tuple(a.to(cuda) if torch.is_tensor(a) else a for a in (
            c, lr, cb)) + (nblocks, nblocks * oh.RB, red, ident)
        mod = oh
    else:
        c, lr, ev, cb, nblocks = _k8_chunks(rng, dt, ident)
        args = tuple(a.to(cuda) for a in (c, lr, ev, cb)) + (
            nblocks, red, ident)
        mod = sk
    before = mod.LAUNCHES[kernel]
    call = getattr(mod, kernel)
    got = call(*args)
    assert mod.LAUNCHES[kernel] == before + 1
    assert torch.equal(got, getattr(mod, kernel + "_plain")(*args))
    assert torch.equal(call(*args), got)
    cpu = getattr(mod, kernel)(*(a.cpu() if torch.is_tensor(a) else a
                                 for a in args))
    assert torch.equal(got.cpu(), cpu)


@pytest.mark.parametrize("kernel", ["segment_reduce", "panel"])
def test_csc_kernels_match_plain(cuda, kernel):
    """On RMAT-14 f32 plans of CSC tiles (raw local rows, NR = C*L, about
    twice TCSC's row blocks): K5 on the one-hot plan, and K1-K4 on the
    panel meta, each twice with the same bits as its plain version."""
    n = 1 << 14
    r, c, _ = rmat_edges(14, 16, seed=1)
    g = Graph.from_edges(r, c, None, GraphConfig(
        num_vertices=n, transpose=True, compression=Compression.CSC))
    ts = g.tiled()
    assert ts.ir is None and ts.NR == g.part.tile_rows
    sem = tsr.plus_times()
    x = torch.from_numpy(_x(g, np.float32)).to(cuda)
    if kernel == "segment_reduce":
        plan = oh.build_onehot_plan(ts)
        t = meta_from_numpy(plan.arrays, cuda)
        args = (oh.onehot_contrib(x, t, sem), t["oh_lrows"],
                t["oh_chunk_block"], plan.nblocks, ts.NR, "sum", 0.0)
        before = oh.LAUNCHES[kernel]
        got = _twice_equal(lambda: oh.segment_reduce(*args),
                           lambda: oh.segment_reduce_plain(*args))
        assert oh.LAUNCHES[kernel] == before + 2
        assert got.shape == (ts.NR,)
        return
    meta = build_spmv3_meta(ts, value_dtype=np.float32)
    t = meta_from_numpy(meta.arrays, cuda)
    st = spmv3_stages(x, t, meta, sem, g.part.tile_rows)
    xe = (st["x2d"], t["xr_bases"], t["xe_plan"], None, 0.0,
          meta.exp_panels + 1, meta.xr_nwin, "none")
    pa = (st["s0"], t["pa_bases"], t["pa_plan"], 0.0, meta.pa_panels + 1,
          meta.pa_nwin)
    fx = (st["s1"], t["fixr_bases"], t["fixr_plan"], t["fix_dst"],
          t["fixr_seg"], meta.nrb, "sum", 0.0, meta.fix_panels,
          meta.fixr_nwin)
    f2 = (st["y_hub"], t["f2_bases"], t["f2_plan"], t["fix2_dst"],
          t["f2_seg"], meta.f2_rows, "sum", 0.0, meta.f2_panels,
          meta.f2_nwin)
    before = dict(pk.LAUNCHES)
    for call, plain, args in (
            (pk.route_xr_exp, pk.route_xr_exp_plain, xe),
            (pk.route_passa, pk.route_passa_plain, pa),
            (pk.hub_fold, pk.hub_fold_plain, (st["y_mid"], t["hub_mask"],
                                               "sum")),
            (pk.route_fold, pk.route_fold_plain, fx),
            (pk.route_fold, pk.route_fold_plain, f2)):
        _twice_equal(lambda: call(*args), lambda: plain(*args))
    assert {k: pk.LAUNCHES[k] - before[k] for k in (
        "route_xr_exp", "route_passa", "route_fold", "hub_fold")} == {
        "route_xr_exp": 2, "route_passa": 2, "route_fold": 4, "hub_fold": 2}
    assert torch.equal(st["s0"], pk.route_xr_exp_plain(*xe))


def test_initialize_enqueues_no_copy_or_sync(cuda):
    """One PageRank job's ``initialize(other=)`` and one BFS query's
    ``initialize()`` on the onehot executor, under ``torch.profiler``,
    launch kernels and no copy between the host and the card and no
    synchronize (the device-to-device copies of ``clone`` are kernels of
    the card's own): the state is built on the card from the rows
    uploaded at construction and the degree executor's state (freed, as
    ``run_pagerank`` hands it over)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    from graphtap_tpu_torch.apps import BFSProgram, PageRankProgram
    from graphtap_tpu_torch.apps.degree import run_degree
    from graphtap_tpu_torch.config import EngineConfig, Ordering
    n = 1 << 12
    r, c, _ = rmat_edges(12, 16, seed=3)
    pg = Graph.from_edges(r, c, None, GraphConfig(num_vertices=n,
                                                  transpose=True))
    deg = run_degree(pg, torch.float32, Ordering.COL, "onehot", cuda)
    deg.free()
    pr = executor.Executor(pg, PageRankProgram(torch.float32),
                           EngineConfig(stationary=True,
                                        ordering=Ordering.ROW),
                           kernel="onehot", device=cuda)
    bfs = executor.Executor(Graph.from_edges(r, c, None, bfs_config(n)),
                            BFSProgram(root=1),
                            EngineConfig(stationary=False,
                                         apply_depends_on_iter=True,
                                         ordering=Ordering.ROW),
                            kernel="onehot", device=cuda)
    jobs = (lambda: pr.initialize(other=deg), bfs.initialize)
    for job in jobs:                        # warm the allocator's pool
        job()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function("initialize_jobs"):
            for job in jobs:
                job()
    torch.cuda.synchronize()
    events = prof.events()
    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    span = next(e for e in cpu if e.name == "initialize_jobs")
    inside = [e.name for e in cpu
              if span.time_range.start <= e.time_range.start
              <= span.time_range.end]
    assert "aten::where" in inside, inside
    assert not [k for k in inside if "synchronize" in k.lower()], inside
    copies = [e.name for e in events
              if "HtoD" in e.name or "DtoH" in e.name]
    assert not copies, copies
    np.testing.assert_array_equal(
        pr.state["degree"].cpu().numpy(),
        np.where(pg.tiled().i_own[0], deg.state["degree"].cpu().numpy(), 0))


_F32_MINMAX = {"f32_min": ("f32", "min", float("inf")),
               "f32_max": ("f32", "max", -float("inf"))}


def _g500_sssp_graph(scale=12, seed=1):
    """Graph500 kernel 3's graph at ``scale``: undirected, deduplicated,
    weighted by the pair hash in float32."""
    from benchmark.g500_weights import pair_weights
    r, c, _ = rmat_edges(scale, 16, seed=seed)
    w = pair_weights(torch.from_numpy(r), torch.from_numpy(c)).numpy()
    return Graph.from_edges(r, c, w, GraphConfig(
        num_vertices=1 << scale, directed=False, self_loops=False,
        parallel_edges=False, has_weight=True))


def _sssp_executor(g, root, device):
    from graphtap_tpu_torch.apps.sssp import SSSPProgram
    from graphtap_tpu_torch.config import EngineConfig, Ordering
    return executor.Executor(
        g, SSSPProgram(root=root, value_dtype=torch.float32),
        EngineConfig(stationary=False, gather_depends_on_apply=True,
                     ordering=Ordering.ROW), kernel="onehot", device=device)


@pytest.mark.parametrize("kind", sorted(_F32_MINMAX))
def test_k5_f32_min_max_match_plain(cuda, kind):
    """K5's f32 min and max equal the plain version bit for bit, twice,
    and the CPU, on the synthetic chunks of ``test_chunk_folds_match_plain``
    and, for min, on the contributions of a float SSSP superstep from
    every vertex at RMAT-12 (pair-hash weights, +inf padding)."""
    dt, red, ident = _F32_MINMAX[kind]
    c, lr, cb, nblocks = _k5_chunks(np.random.default_rng(12), dt, ident)
    args = tuple(a.to(cuda) for a in (c, lr, cb)) + (
        nblocks, nblocks * oh.RB, red, ident)
    before = oh.LAUNCHES["segment_reduce"]
    got = _twice_equal(lambda: oh.segment_reduce(*args),
                       lambda: oh.segment_reduce_plain(*args))
    assert oh.LAUNCHES["segment_reduce"] == before + 2
    assert torch.equal(got.cpu(), oh.segment_reduce(
        *(a.cpu() if torch.is_tensor(a) else a for a in args)))
    if red != "min":
        return
    g = _g500_sssp_graph()
    ts = g.tiled()
    plan = oh.build_onehot_plan(ts)
    assert plan.weights.dtype == np.float32
    t = meta_from_numpy(plan.arrays, cuda)
    sem = tsr.min_plus(tsr.inf_of(torch.float32))
    x = torch.from_numpy(np.random.default_rng(2).random(
        g.part.tile_cols).astype(np.float32)).to(cuda)
    x[::7] = float("inf")                       # vertices not reached
    kargs = (oh.onehot_contrib(x, t, sem), t["oh_lrows"],
             t["oh_chunk_block"], plan.nblocks, ts.NR, "min", sem.identity)
    _twice_equal(lambda: oh.segment_reduce(*kargs),
                 lambda: oh.segment_reduce_plain(*kargs))


def test_f32_sssp_on_cuda_matches_cpu(cuda):
    """Float SSSP to convergence on onehot (K5's f32 min) at RMAT-12:
    the card's distances equal the CPU's bit for bit, in as many
    supersteps, for two roots."""
    g = _g500_sssp_graph()
    card, cpu = _sssp_executor(g, 0, cuda), _sssp_executor(g, 0, "cpu")
    for root in (1, 77):
        for ex in (card, cpu):
            ex.program.root = root
            ex.initialize()
            ex.execute(0)
        assert card.iteration == cpu.iteration > 3
        a = card.state_vector()["distance"]
        b = cpu.state_vector()["distance"]
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))


def test_sssp_superstep_no_copy_or_sync(cuda):
    """One float SSSP superstep on onehot enqueues no copy between the
    host and the card and no synchronize (under the sync debug mode's
    "error"); its vote is the one read, a single device-to-host copy, and
    under a tracer the frontier's edge count rides in that same copy."""
    from torch.profiler import ProfilerActivity, profile, record_function
    g = _g500_sssp_graph()
    ex = _sssp_executor(g, 1, cuda)
    with timing.tracing():                  # warm the allocator's pool and
        ex.initialize()                     # upload the counters' degrees
        ex.execute(0)
    for tracer in (None, timing.tracing()):
        ex.initialize()
        V, C = ex.state, ex.changed
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with record_function("superstep"):
                torch.cuda.set_sync_debug_mode("error")
                try:
                    frontier = (ex._frontier_edges(C, "main")
                                if tracer is not None else None)
                    _, C2, _ = ex._superstep(V, C, 0, "main", False)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            with record_function("vote"):
                if tracer is None:
                    ex._voted(C2)
                else:
                    with tracer:
                        ex._voted(C2, frontier)
        torch.cuda.synchronize()
        copies = [e.name for e in prof.events()
                  if "HtoD" in e.name or "DtoH" in e.name]
        assert not [k for k in copies if "HtoD" in k], copies
        assert len([k for k in copies if "DtoH" in k]) == 1, copies
        if tracer is not None:                 # the root's stored edges
            ts = ex.tiles
            deg = np.bincount(ts.cols[0, :int(ts.nnz[0, 0])],
                              minlength=g.part.tile_cols)
            assert tracer.counters["frontier_edges"] == int(
                deg[C.cpu().numpy()].sum()) > 0


@pytest.mark.parametrize("case", GATHER_CASES)
def test_k5_gather_matches_composition(cuda, case):
    """K5 from the plan equals the torch contributions (``onehot_contrib``)
    folded by K5, bit for bit, twice, and the plain composition, at
    RMAT-16 (the gather tables' edge cases of ``onehot_cases``: a few
    chunks, null items, chunks with no edge, a hub lane, x of
    ``col_bound`` values); one launch each, counted as
    ``segment_reduce_gather``'s alone; the tables built on the card equal
    those built on the CPU."""
    x, plan, nr, sem = gather_case(case, scale=16)
    x = x.to(cuda)
    t = meta_from_numpy(plan.arrays, cuda)
    folds = oh.fold_tables(t, plan, x.dtype)
    w = t.get("oh_w")
    args = (t["oh_lrows"], t["oh_chunk_block"], plan.nblocks, nr,
            sem.reduce_kind)
    old = oh.segment_reduce(oh.onehot_contrib(x, t, sem), *args,
                            sem.identity, **folds)
    gargs = (x, t["oh_cols"], t["oh_evalid"], w, *args[:4], plan.col_bound,
             sem.reduce_kind, mul_kind(plan, sem), sem.identity)
    before = dict(oh.LAUNCHES)
    got = _twice_equal(lambda: oh.segment_reduce_gather(*gargs, **folds),
                       lambda: oh.segment_reduce_gather_plain(*gargs))
    assert oh.LAUNCHES == {**before, "segment_reduce_gather":
                           before["segment_reduce_gather"] + 2}
    assert torch.equal(got, old)
    assert torch.equal(oh.spmv_onehot(x, t, plan, sem, nr), old)
    cpu = meta_from_numpy(plan.arrays, "cpu")
    want = oh.gather_tables(cpu["oh_cols"], cpu["oh_evalid"],
                            cpu["oh_lrows"], cpu.get("oh_w"), plan.col_bound)
    for k, a in zip(oh._GATHER_KEYS, want):
        assert (k in t) == (a is not None)
        assert a is None or torch.equal(t[k].cpu(), a), k
    if case == "f32_sum_null_items":
        assert (folds["lists"][2] < 0).any()


def test_k5_gather_equals_plain_on_pagerank_supersteps(cuda):
    """Every K5-from-the-plan call of three RMAT-16 f32 PageRank
    supersteps on onehot equals the plain version of its inputs bit for
    bit (the plain version folds in the order of the rank-and-sort kernel
    the gather tables replaced)."""
    r, c, _ = rmat_edges(16, 16, seed=1)
    g = Graph.from_edges(r, c, None, GraphConfig(num_vertices=1 << 16,
                                                 transpose=True))
    calls, kernel = [], oh.segment_reduce_gather

    def record(*args, **kw):
        y = kernel(*args, **kw)
        calls.append(((args[0].clone(),) + args[1:], y.clone()))
        return y
    oh.segment_reduce_gather = record
    try:
        run_pagerank(g, 3, torch.float32, kernel="onehot", device=cuda,
                     degree_kernel="scan")
    finally:
        oh.segment_reduce_gather = kernel
    assert len(calls) == 3
    for args, y in calls:
        assert torch.equal(y, oh.segment_reduce_gather_plain(*args))


def _cf_graph(scale):
    r, c, _ = rmat_edges(scale, 16, seed=1)
    return Graph.from_edges(r, c, None, GraphConfig(
        num_vertices=1 << scale, transpose=True,
        compression=Compression.TCSC_CF))


def test_k5_gather_equals_plain_on_cf_phases(cuda):
    """Every K5-from-the-plan call of an RMAT-14 f32 TCSC_CF PageRank run
    to tolerance on onehot equals the plain version of its inputs bit for
    bit, on each phase's own plan: "first" once, "middle" until the vote,
    the flush on "last"."""
    calls, kernel = [], oh.segment_reduce_gather

    def record(*args, **kw):
        y = kernel(*args, **kw)
        calls.append(((args[0].clone(),) + args[1:], y.clone()))
        return y
    oh.segment_reduce_gather = record
    try:
        ex = run_pagerank(_cf_graph(14), 0, torch.float32, kernel="onehot",
                          device=cuda, degree_kernel="scan")
    finally:
        oh.segment_reduce_gather = kernel
    n = ex.iteration
    phase_of = {ex._phases[ph][2]["oh_cols"].data_ptr(): ph
                for ph in executor.CF_PHASES}
    assert [phase_of[args[1].data_ptr()] for args, _ in calls] == (
        ["first"] + ["middle"] * (n - 1) + ["last"])
    for args, y in calls:
        assert torch.equal(y, oh.segment_reduce_gather_plain(*args))


def test_cf_pagerank_to_tolerance_on_cuda_matches_cpu(cuda):
    """f32 TCSC_CF PageRank to tolerance at RMAT-14 on onehot: the card's
    run takes the CPU run's supersteps and its ranks within rtol 1e-6
    (K5 folds in one fixed order on both, and every other step is an
    elementwise f32 op, so the two agree to the last bits; the tolerance
    leaves room for an elementwise kernel's own rounding)."""
    g = _cf_graph(14)
    on_card = run_pagerank(g, 0, torch.float32, kernel="onehot",
                           device=cuda, degree_kernel="scan")
    on_cpu = run_pagerank(g, 0, torch.float32, kernel="onehot",
                          device="cpu", degree_kernel="scan")
    assert on_card.iteration == on_cpu.iteration > 50
    np.testing.assert_allclose(on_card.state_vector()["rank"],
                               on_cpu.state_vector()["rank"], rtol=1e-6,
                               atol=0)


@pytest.mark.parametrize("app", ["pagerank", "sssp"])
def test_onehot_superstep_builds_no_slot_array(cuda, app):
    """One PageRank and one float SSSP superstep on onehot, under
    ``torch.profiler``, run no torch op with an input of the plan's length
    (the gather, ⊗ and padding mask over every slot are K5's now) and no
    index_select or gather kernel, and launch K5 from the plan once and K5
    on contributions never; under a tracer each superstep adds the plan's
    length to ``onehot_gathered_slots``."""
    from torch.profiler import ProfilerActivity, profile
    from graphtap_tpu_torch.apps import PageRankProgram
    from graphtap_tpu_torch.config import EngineConfig, Ordering
    if app == "pagerank":
        r, c, _ = rmat_edges(12, 16, seed=3)
        ex = executor.Executor(
            Graph.from_edges(r, c, None, GraphConfig(num_vertices=1 << 12,
                                                     transpose=True)),
            PageRankProgram(torch.float32),
            EngineConfig(stationary=True, ordering=Ordering.ROW),
            kernel="onehot", device=cuda)
    else:
        ex = _sssp_executor(_g500_sssp_graph(), 1, cuda)
    ep = ex.meta.Ep
    ex.initialize()
    ex.execute(2)                               # warm the allocator's pool
    ex.initialize()
    torch.cuda.synchronize()
    before = dict(oh.LAUNCHES)
    with timing.tracing() as tr:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     record_shapes=True) as prof:
            ex._superstep(ex.state, ex.changed, 0, "main", False)
            torch.cuda.synchronize()
    assert oh.LAUNCHES == {**before, "segment_reduce_gather":
                           before["segment_reduce_gather"] + 1}
    assert tr.counters["onehot_gathered_slots"] == ep
    assert tr.counters["supersteps"] == 1
    events = prof.events()
    slot_long = [e.name for e in events
                 if any(ep in s for s in e.input_shapes if s)]
    assert not slot_long, slot_long
    gathers = [e.name for e in events if "index_select" in e.name.lower()
               or "indexselect" in e.name.lower()
               or "scatter_gather" in e.name.lower()]
    assert not gathers, gathers
    with timing.tracing() as tr:
        ex.initialize()
        ex.execute(3)
    assert tr.counters["onehot_gathered_slots"] == ep * 3


# the mesh on the card: (shape, the exchange's transport) of a backend
_MESH = {"gloo": ((2, 2), "gloo-host"), "nccl": ((1, 1), "nccl")}


def _mesh_spec(tmp_path, backend):
    """A ``tools/mesh_run.py`` spec at RMAT-10 (seed 1; SSSP weighted),
    with every shard holding vertices (``segment_align`` 128): BFS, CC
    and SSSP on onehot and shuffle2 with the sparse exchange at K = 8,
    then f32 PageRank, 20 iterations, on panel and onehot (the degree
    phase on shuffle), onehot's once more through ``execute_profiled``;
    each run again on the group-free 1x1 layout (``plain``)."""
    files = {}
    for tag, weighted in (("", False), ("w", True)):
        files[tag] = str(tmp_path / f"rmat10{tag}.bin")
        write_binary(files[tag], *rmat_edges(10, 16, seed=1,
                                             weighted=weighted))
    graphs = {app: {"path": files["w" if app == "sssp" else ""],
                    "nv": 1 << 10, "config": app,
                    "overrides": {"segment_align": 128}}
              for app in ("pr", "bfs", "cc", "sssp")}
    runs = [{"name": f"{app}_{k}", "graph": app, "app": app, "kernel": k,
             "capacity": 8, "plain": True}
            for app in ("bfs", "cc", "sssp")
            for k in ("onehot", "shuffle2")]
    runs += [{"name": f"pagerank_{k}", "graph": "pr", "app": "pagerank",
              "kernel": k, "dtype": "float32", "iters": 20,
              "degree_kernel": "shuffle", "plain": True}
             for k in ("panel", "onehot")]
    runs.append(dict(runs[-1], name="pagerank_onehot_profiled",
                     profiled=True))
    return {"shape": list(_MESH[backend][0]), "backend": backend,
            "device": "cuda", "out": str(tmp_path / "out"),
            "graphs": graphs, "runs": runs}


def _mesh_result(out, name):
    with np.load(os.path.join(out, f"{name}.npz")) as z:
        state = {k: z[k] for k in z.files}
    with open(os.path.join(out, f"{name}.json")) as f:
        return state, json.load(f)


@pytest.mark.parametrize("backend", sorted(_MESH))
def test_mesh_on_cuda_matches_group_free(cuda, tmp_path, backend):
    """The mesh on the card (``parallel/launch.py`` starting
    ``tools/mesh_run.py``): four gloo ranks of a 2x2 mesh, whose
    exchanges go through host memory, and one rank in an NCCL group (NCCL
    puts one rank on a card). Each run against the card's group-free run
    of the same case: BFS, CC and SSSP bit for bit, in as many
    supersteps, with both branches of the sparse exchange seen at 2x2;
    PageRank elementwise within 1e-5 relative (f32) and its checksum
    within 1e-6, bit for bit in NCCL's 1x1; ``execute_profiled`` equal to
    ``execute`` bit for bit. Every rank launches its path's kernels each
    superstep (and the flush)."""
    from graphtap_tpu_torch.kernels import _cuda
    _cuda.library()                     # the ranks load what this built
    spec = _mesh_spec(tmp_path, backend)
    path = tmp_path / "spec.json"
    path.write_text(json.dumps(spec))
    shape, transport = _MESH[backend]
    launch([sys.executable, "-m", "graphtap_tpu_torch.tools.mesh_run",
            str(path)], shape[0] * shape[1], 600,
           env=dict(os.environ, PYTHONPATH=REPO), cwd=REPO)
    for run in spec["runs"]:
        name, kernel = run["name"], run["kernel"]
        state, meta = _mesh_result(spec["out"], name)
        want, alone = _mesh_result(spec["out"], name + "_1x1")
        assert meta["exchange"] == transport and alone["exchange"] is None
        assert len(meta["ranks"]) == shape[0] * shape[1]
        steps = 20 if run["app"] == "pagerank" else meta["iteration"] + 1
        for rk in meta["ranks"]:
            for k, v in PATH_LAUNCHES[kernel].items():
                assert rk["launches"].get(k, 0) == steps * v, (name, k)
        assert meta["iteration"] == alone["iteration"], name
        if run["app"] == "pagerank" and backend == "gloo":
            np.testing.assert_allclose(state["rank"], want["rank"],
                                       rtol=1e-5, atol=0, err_msg=name)
            np.testing.assert_array_equal(state["degree"], want["degree"])
            assert abs(meta["checksum"] - alone["checksum"]) <= \
                1e-6 * abs(alone["checksum"]), name
        else:
            assert set(state) == set(want), name
            for k in want:
                np.testing.assert_array_equal(state[k], want[k],
                                              err_msg=f"{name} {k}")
        if run["app"] != "pagerank" and backend == "gloo":
            assert {rec["sparse"] for rk in meta["ranks"]
                    for rec in rk["supersteps"]} == {True, False}, name
    # execute_profiled gives execute's bits, and each rank's fenced phases
    state, meta = _mesh_result(spec["out"], "pagerank_onehot_profiled")
    want, _ = _mesh_result(spec["out"], "pagerank_onehot")
    for k in want:
        np.testing.assert_array_equal(state[k], want[k], err_msg=k)
    assert all("exchange" in rk["phases"] for rk in meta["ranks"])


# the five mains: app -> (third argument, weighted edge file)
_MAINS = {"pr": ("20", False), "pr1": ("20", False), "bfs": ("0", False),
          "cc": (None, False), "sssp": ("0", True)}


@pytest.fixture(scope="module")
def mains_on_card(tmp_path_factory):
    """The five mains as subprocesses on the card, all at once, each on
    its default device and kernel (``cuda``, panel), on RMAT-10 files
    (seed 1; weighted for SSSP): app -> (the finished process, its
    stdout, its stderr, the edges it read)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    from graphtap_tpu_torch.kernels import _cuda
    _cuda.library()
    d = tmp_path_factory.mktemp("mains")
    edges, files = {}, {}
    for weighted in (False, True):
        edges[weighted] = rmat_edges(10, 16, seed=1, weighted=weighted)
        files[weighted] = str(d / f"rmat10{'w' if weighted else ''}.bin")
        write_binary(files[weighted], *edges[weighted])
    procs = {app: subprocess.Popen(
        [sys.executable, "-m", f"graphtap_tpu_torch.apps.{app}",
         files[weighted], str(1 << 10)] + ([third] if third else []),
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for app, (third, weighted) in _MAINS.items()}
    done = {}
    try:
        for app, p in procs.items():
            out, err = p.communicate(timeout=600)
            done[app] = (p, out, err, edges[_MAINS[app][1]])
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    return done


@pytest.mark.parametrize("app", sorted(_MAINS))
def test_mains_on_cuda_match_golden(cuda, mains_on_card, app):
    """``python -m graphtap_tpu_torch.apps.<app> <file> 1024 [20|0]`` on
    the card prints the balance line and the five oracle lines; PageRank's
    checksum (pr: TCSC_CF; pr1: two loads) within 1e-4 relative of the
    f64 golden model's after 20 iterations, BFS's, CC's and SSSP's
    checksum and reachable count equal the golden models'."""
    p, out, err, (r, c, w) = mains_on_card[app]
    assert p.returncode == 0, err[-3000:]
    balance, *lines = out.strip().splitlines()
    assert balance.startswith("Edge balance: edges=")
    assert [ln.split(":")[0] for ln in lines] == [
        f"{app} end-to-end time", "Execute time", "Iterations",
        "Value checksum", "Reachable vertices"]
    checksum = float(lines[3].split(":")[1])
    reach = int(lines[4].split(":")[1])
    nv = (1 << 10) + 1
    r64, c64 = r.astype(np.int64), c.astype(np.int64)
    if app in ("pr", "pr1"):
        want = float(golden.pagerank(r, c, nv, 20).sum())
        assert int(lines[2].split(":")[1]) == 20
        assert abs(checksum - want) <= 1e-4 * want
        return
    v = {"bfs": lambda: golden.bfs(r64, c64, nv, 0)[1],
         "cc": lambda: golden.cc(r64, c64, nv),
         "sssp": lambda: golden.sssp(r64, c64, w.astype(np.int64), nv,
                                     0)}[app]()
    v = v[v != golden.INF]
    assert (checksum, reach) == (float(v.sum()), int(v.size))


def test_dryrun_multichip_on_cuda(cuda):
    """``dryrun_multichip(4)`` on the card (four gloo ranks of a 2x2 mesh
    on one card) equals ``dryrun_multichip(1)``: BFS and SSSP bit for bit,
    the PageRank programs' checksums within 1e-6 relative; every rank of
    a panel program launches K1-K3 (static or gated) and K4, and the
    gated K1-K3 where one of its supersteps is gated."""
    from graphtap_tpu_torch import graft_entry
    got = graft_entry.dryrun_multichip(4, cuda, timeout=600)
    one = graft_entry.dryrun_multichip(1, cuda, timeout=600)
    for name, r in got.items():
        want = one[name]
        assert r["exchange"] == "gloo-host" and len(r["ranks"]) == 4, name
        if name in ("bfs", "sssp"):
            for k, v in want["state"].items():
                np.testing.assert_array_equal(r["state"][k], v,
                                              err_msg=f"{name} {k}")
        else:
            assert abs(r["checksum"] - want["checksum"]) <= \
                1e-6 * abs(want["checksum"]), name
        for rk in r["ranks"]:
            if rk["supersteps"][0]["gated"] is None:
                continue                    # scan: no kernel to launch
            n = rk["launches"]
            for k in ("route_xr_exp", "route_passa", "route_fold"):
                assert n.get(k, 0) + n.get(k + "_gated", 0) > 0, (name, k)
            assert n.get("hub_fold", 0) > 0, name
            if any(st["gated"] for st in rk["supersteps"]):
                for k in ("route_xr_exp", "route_passa", "route_fold"):
                    assert n.get(k + "_gated", 0) > 0, (name, k)


def test_lab_on_cuda_gates(cuda, tmp_path):
    """The kernel lab's nine variants on the card at RMAT-10 (seed 1), 20
    iterations each (``tools/lab_table.py``): its gates hold (operations
    equal, checksums within 1e-5 relative of each other), every checksum
    is within 1e-4 relative of the f64 golden model's, and variant 6
    (onehot) launches K5 from the plan for its degree SpMV, its warm-up
    and its timed run: 1 + 2 x 20 times."""
    from graphtap_tpu_torch.tools import lab_table
    r, c, _ = rmat_edges(10, 16, seed=1)
    path = str(tmp_path / "rmat10.bin")
    write_binary(path, r, c)
    n = 1 << 10
    rows = []
    for which in range(9):
        timing.reset_launches()
        rows += lab_table.run_rows(path, n, 20, [which], "cuda")
        if which == 6:
            assert timing.launches() == {"segment_reduce_gather": 41}
    lab_table.gates(rows)
    want = float(golden.pagerank(r, c, n + 1, 20).sum())
    for row in rows:
        assert abs(row["checksum"] - want) <= 1e-4 * want, row["which"]
