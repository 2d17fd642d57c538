#!/usr/bin/env python3
"""Drive the torch port's PageRank (TCSC, TCSC_CF and CSC, fixed
iterations and f32 convergence), staged-panel, shuffle, shuffle2, one-hot
and frontier paths, its kernel lab, its device-memory probes, its five
mains, its 2x2 mesh (four ranks on the one card), its top-level entry
points, its two profiling tools and its two benchmarks, on one
NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed as it runs; any failure exits non-zero:

  1. device   the card's name and power limit (nvidia-smi), torch, CUDA
              and nvcc versions; fails without CUDA.
  2. build    nvcc builds the panel-route (K1-K4, K11-K13), shuffle
              (K6-K8), windowed-gather (K9, K10), one-hot (K5) and probe
              (P1-P3) kernels from csrc/, one nvcc per source, in parallel.
  2b. probes  P1-P3 against their plain versions at the probes' shapes,
              bit for bit; then the quick P1/P2 copy-rate table
              (tools/bw_probe.py) and the P3 per-panel table
              (tools/route_cost_probe.py), each with the card's name and
              power limit, and each P1 row's chunks (chunk rows, pieces,
              bw_probe.copy_chunks) and ring depth (chunks in flight an
              SM, the card's occupancy query); the best copy rate of
              the table (a P1 row's, or Tensor.copy_'s where it beats
              every P1 row; the row is logged) is the measured ceiling
              each kernel row's bytes are also set against.
  3. parity   each panel kernel against its plain torch version on the
              card, on RMAT-14 plans in f32 sum, f64 sum (weighted) and
              int32 min (weighted), bit for bit: K3's float sums fold in
              the fixed order its plain version follows
              (kernels/fold_order.py), and two K3 calls on the same
              inputs give the same bits (static, and in f32 gated with a
              third of the panels pointed at the fill block).
  3b. gated  the gated K1-K3 against their gated plain versions, bit for
              bit, on RMAT-14 plans in int32 min (weighted add_sat through
              sssp_config, unweighted through bfs_config), on a 2%, a 30%
              (each a contiguous vertex range) and an empty frontier; and
              the gated spmv3 against the static one, bit for bit.
  3c. shuffle K6 (with its two dense-expansion calls), K7 and K8 against
              their plain versions on RMAT-14 shuffle plans in f32 sum, f64
              sum (weighted, mul), int32 min (weighted add_sat through
              sssp_config) and int32 min (bfs_config), bit for bit, K8
              twice on the same inputs with the same bits; the whole
              spmv_local against the plain pipeline (elementwise rtol
              1e-5 in f32, 1e-12 in f64).
  3d. gather  on RMAT-14 v2 plans in the same four settings: K9 at each of
              its six stage calls (bit for bit) and K8 against their plain
              versions, the whole spmv2_local against the plain pipeline;
              K5 on the one-hot plans of the same graphs (bit for bit, and
              twice with the same bits, as K8) and the whole one-hot SpMV
              against the plain one; K10 on the first RMAT-14 stage (mx,
              exp, p0 .. p3) that re-plans with 64-row steps, on the
              stage's f32 source and on f64 and int32 sources.
  4. main     RMAT-20 (edge factor 16, seed 1): degree on the shuffle
              kernel (COL ordering) + 20 PageRank iterations on the panel
              kernel through apps.run_pagerank(device="cuda") in f32; the
              degrees equal tests/golden.py::degree bit for bit, the
              checksum within 1e-4 relative of the f64 NumPy golden model;
              the launch counts of K1-K4 and K6-K8; warm GTEPS, the median
              of five warm 20-iteration runs, each run listed (as on every
              PageRank path below). After phases 5 and
              5b: f32 PageRank to convergence (execute(0)) on the same
              executor, re-initialized from the degree phase, and one
              execute_profiled of 20 iterations with its PhaseTimer report
              (scatter_gather, exchange, combine, apply, each fenced by a
              device synchronize).
  5. kernels  each kernel's time beside its plain version's, its bound
              and, where one PyTorch call computes the same function, that
              call's time, at the RMAT-20 shapes of the main path (K1-K4:
              the PageRank superstep; K6-K8: the degree SpMV), and their
              largest difference (0: every kernel equals its plain
              version bit for bit there). Each K2 call of the smoke logs
              its npanels, nwin and kernel form (passa_form: the source
              windows staged in shared memory or read from device memory),
              each K9 stage its steps and nsub, and each meta whose K1 and
              K3 the smoke runs (parity, gated, main, CF phases, BFS, CC,
              SSSP) its K1, fixr and fix2 npanels, nwin, plan-ring depth,
              shared memory and blocks an SM. K3's pass (b) share is
              estimated from its bytes at the measured copy rate (no
              switch runs it alone), and the five launches of the panel
              superstep are summed by device time beside the eager SpMV
              and superstep (CUDA events): what is left is the host's.
              Every row's kernel and library
              call are timed twice: CUDA events around ten eager calls
              (the enqueue rate of the host bounds a short call), and
              device-only: the ten calls captured into one CUDA graph and
              replayed between two events. Library calls: torch.take
              over an index precomputed from the plan for K1, K2
              (unweighted), K6, K7 (one take over the radix passes'
              composed index); torch.scatter_reduce for K8, and for K3
              when no source slot of its route feeds two (row, lane)
              slots (checked here). K6's plan figures on the degree
              plan logged (steps, slots, valid slots, windows, runs of
              one window, all-invalid 4-slot groups), and K8's chunk
              figures (ring_times.chunk_figures: chunks, row blocks,
              longest lane of a chunk, single-lane chunks, chunks with no
              valid slot, all-invalid 4-slot groups, longest fold list;
              K5's on the one-hot plan in 4b). K7 also in f64 and
              int32 on seeded random streams of the degree plan, bit for
              bit, and its
              earlier yardstick (one take per pass) logged; then the
              degree SpMV's warm time (median of five calls).
  5b. staged  the staged SpMV (kernels/panel_engine.py::spmv3_staged) on
              the main path's own RMAT-20 panel meta and PageRank x, with
              K12 on its stack1: K2 single-layer, K11, K2 x2, K13, K4, K3;
              every one launched; K11's s0 equal to K1's bit for bit; the
              staged y_mid and y within K3's tolerance of the fused ones
              (max |diff| <= 1e-5 x max |fused|, f32); K12's rows scattered
              by chunk_dst with ⊕ equal to K13's y_mid at that tolerance;
              K13 (which folds each y row's chunks in ascending chunk
              order, the Pallas grid's) equal to its plain version bit
              for bit in f32, and twice with the same bits.
              K11's plan ring is logged (npanels, stage bytes, shared
              memory, blocks an SM). Then the kernel rows of K2
              single-layer, K11, K12 and K13, with torch.take (K2, K11),
              view(-1, 8, 128).sum(1) (K12) and one scatter_reduce (K13)
              as their library calls.
  4b. paths   RMAT-20 PageRank, 20 iterations in f32, on shuffle2 (its
              executor built here and handed the main phase's shuffle
              degrees, as bench.py composes BENCH_KERNEL=shuffle2) and on
              onehot (run_pagerank with degree_kernel="onehot"): each
              checksum within 1e-4 relative of the f64 golden, the one-hot
              degrees equal golden.degree, launches (windowed_gather 6,
              grouped_reduce 1, segment_reduce_gather 1 per
              superstep), warm GTEPS beside panel's. Then the kernel rows
              of K9 (its six stage calls at the shuffle2 superstep), K10
              (one RMAT-20 stage re-planned with 64-row steps; no path
              launches it) and K5 (on contributions, at the one-hot
              superstep's shapes), with torch.take and
              torch.scatter_reduce as their library calls, and K5 from
              the plan (segment_reduce_gather, the path's launch: x
              gathered, ⊗ and masked in the fold) beside the torch
              contributions and K5 it replaces (bit for bit). Then f32
              PageRank to convergence on both executors, re-initialized
              from their degree phases, the onehot one profiled for 20
              iterations as panel's; and on a scan executor (the portable
              kernel) handed the main phase's degrees.
  6. bfs      RMAT-18 through bfs_config: apps.run_bfs(device="cuda") to
              convergence, frontier-gated ("auto"); hops and parents equal
              tests/golden.py::bfs bit for bit; every gated kernel
              launched; each superstep's branch and time (CUDA events);
              then re-initialized and run again warm. The gated kernels'
              times at the shapes of BFS's first superstep. Then BFS on the
              shuffle, shuffle2 and onehot kernels: equal to golden, in as
              many iterations.
  7. cc/sssp  CC and SSSP at RMAT-18, each through its own config, to
              convergence, on the panel and then the shuffle, shuffle2 and
              onehot kernels (SSSP on shuffle2 takes K9's add_sat);
              labels and distances equal the golden models, iteration
              counts equal across the kernels. On the SSSP panel meta the
              staged SpMV (int32 min, add_sat) equals the fused one bit
              for bit, and K12's rows scattered by chunk_dst equal K13's.
  8. cf       RMAT-20 PageRank in pr.cpp's config (transposed, TCSC_CF,
              f32, 20 iterations): the degree phase on shuffle, then the
              first/middle/last phases on onehot and on panel (the panel
              phase plans built in worker processes), each checksum within
              1e-4 relative of the f64 golden, per-phase superstep ms;
              then convergence runs (execute(0)) on onehot: f32, which must
              settle (the executor's cap is 2**20 iterations), and f64 on
              TCSC_CF and on TCSC, which agree in ranks within 2e-5. Every
              f32 convergence run of the smoke (scan, onehot, shuffle2,
              panel on TCSC; onehot on TCSC_CF) is held against the f64
              run of its compression: checksum within 1e-4 relative.
  8b. csc     RMAT-20 PageRank in the kernel lab's CSC config (transposed,
              f32; raw local rows, NR = C*L): the degree phase on onehot
              (shuffle takes no CSC), equal to golden.degree; 20
              iterations on onehot and on panel (its ROW plan built by a
              worker), each checksum within 1e-4 of the f64 golden, the
              launches of PATH_LAUNCHES per superstep, warm GTEPS beside
              TCSC's; K5 and the panel superstep's five launches on the CSC
              shapes against their plain versions bit for bit (the folds
              twice), their device ms (CUDA-graph replay) beside TCSC's.
              Then 20 iterations on shuffle2 on CSC at RMAT-18 (its v2 plan
              built by a worker: at RMAT-20 the v2 plans take minutes).
  8c. lab     the kernel lab (tools/kernel_lab.py through
              tools/lab_table.py), 20 iterations a variant, on one RMAT
              binary of each scale written once under
              graphtap_tpu_torch/build/smoke_lab/: variant 6 (onehot) at
              RMAT-20; the plain torch variants 0, 1, 2, 7 and 8 beside 6
              at RMAT-18 (at RMAT-20 their host tiles take ~150 s of the
              smoke's time limit); variants 3, 4 and 5 at RMAT-16 (each
              plans its degree and PageRank phases, minutes of host time
              a plan at RMAT-20, and their kernels run at RMAT-20 in
              phases 4, 4b and 8); the rows printed as the
              markdown table; at each scale operations equal, checksums
              within 1e-5 relative of each other and within 1e-4 of the f64
              golden; variant 6 launches K5 (the degree SpMV and 2 x 20).
  9. cli      RMAT-14 binary edge files (io.write_binary; weighted for
              SSSP), then `python3 -m graphtap_tpu_torch.apps.<app>
              <file> 16384 [20|0]` for pr, pr1, bfs, cc and sssp, as
              subprocesses on the card: the balance line and the five
              oracle lines, each checksum equal to (bfs, cc, sssp) or
              within 1e-4 of (pr, pr1) the golden model's.
  10. mesh    the R x C mesh on torch.distributed, one rank per shard
              (parallel/launch.py starting tools/mesh_run.py; a rank's
              failure fails the smoke): (a) four ranks of a 2x2 mesh on
              this one card (gloo; every exchange staged through host
              memory), each reading its byte range of the RMAT-20 binary
              file written under graphtap_tpu_torch/build/ and exchanging
              edges: degree on shuffle (bit for bit with golden.degree),
              20 PageRank iterations on panel and on onehot (each
              checksum within 1e-4 of the f64 golden and 1e-5 of phase
              4's), each rank's K1-K4, K6-K8 and K5 launch counts > 0,
              per rank the plan seconds and superstep ms, and one more
              onehot run through execute_profiled (bit for bit with the
              first), its exchange, combine and apply ms per rank (the
              four ranks time-share the card: no multi-GPU figure); (b)
              BFS, CC and SSSP at RMAT-18 on onehot and shuffle2 at 2x2
              with the sparse exchange, K = 4096 and K = 8: bit for bit
              with the golden models, both branches seen; (c) one rank
              in an NCCL group (1x1: NCCL cannot put two ranks on one
              card): PageRank on onehot at RMAT-18, bit for bit with the
              group-free run.
  11. entry   the top-level entry points (graft_entry.py) and the profiling
              tools: (a) entry() on the card, K1-K4 launched 1, 1, 2, 1
              times, its step equal to the same step on the plain versions
              on the card bit for bit and its sum within 1e-5 of the JAX
              entry step's 1100.7751; (b) dryrun_multichip(4), four gloo
              ranks of a 2x2 mesh on the one card (degree and PageRank on
              panel, weighted SSSP on panel, BFS, TCSC_CF PageRank on
              RMAT-10), each rank's launches logged (K1-K4 on every rank
              of the panel programs; the gated K1-K3 on a rank with a
              gated superstep), each program equal to dryrun_multichip(1)
              (BFS and SSSP bit for bit, PageRank within 1e-6); (c)
              tools/bfs_profile.py at RMAT-18 on the BFS panel plan the
              workers built: the gate forced, off and auto agree (and
              equal golden.bfs), their times and the per-phase totals;
              (d) tools/sparse_exchange_bench.py at RMAT-18 on eight
              ranks of a 2x4 mesh on the one card: every K gives K = 0's
              checksum (golden.bfs's), the rows logged.
  12. benches the port's two benchmarks (tools/bench.py,
              tools/bench_suite.py), reading the artifacts the phases
              above built through the benchmarks' cache (PLAN_DIR), so that
              nothing is planned again: (a) tools/bench.py at RMAT-20 on
              panel, 20 iterations, five timed runs, on the main phase's
              COL and ROW tiles, panel meta and golden sum (written to
              the cache after phase 8) and the workers' degree shuffle
              plan: its gate met, every artifact read from the cache,
              K1-K4 and K6-K8 launched, its checksum within 1e-6 of phase
              4's, its JSON line logged; (b) the suite's BFS, CC and SSSP
              rows at RMAT-18 on panel, on the workers' plans (phase 11's
              BFS tiles too), each gated on tests/golden.py, the panel
              kernels launched, CC on its own tiles (more edges than
              BFS's); (c) the suite's comm_model row, PageRank on scan at
              1x8, 2x4 and 8x1 on eight gloo ranks of one launch on the
              one card: every rank's counted exchange bytes of every
              superstep equal ((R-1)*L + (C-1)*L)*4.

Five worker processes, started after the build and stopped at exit, plan
the RMAT-20 v2 (ROW), degree shuffle (COL) and the three TCSC_CF panel
phase plans, then the RMAT-20 CSC panel (ROW) and RMAT-18 CSC v2 plans,
into graphtap_tpu_torch/build/smoke_plans/ while the card runs phases 3
to 5; phases 5, 4b, 8 and 8b read them back. Once phase 4b has
timed its kernels they also plan the panel and v2 plans of the RMAT-18
BFS, CC and SSSP graphs, which phases 6 and 7 read back.

The last line is {"ok": true, "device": {...}}; the line before it lists
the kernels with their launches (from the PageRank paths for K1-K9, from
the staged path for K11-K13 and K2's single-layer form, from the BFS path
for the gated rows, from the probe tables for P1-P3; K10 has none),
errors, times (event and device-only), bounds and library times.
"""

from __future__ import annotations

import collections
import json
import multiprocessing
import os
import shutil
import subprocess
import sys
import time

SCALE = 20
EDGE_FACTOR = 16
SEED = 1
ITERS = 20
WARM_RUNS = 5                # warm ITERS-iteration runs behind each GTEPS
PARITY_SCALE = 14
# BFS, CC and SSSP run at RMAT-18, the scale of BENCH_SUITE.json: the
# port's host planner (its copy of panel_plan.py) finds no x->x_ext route
# for RMAT-20 through bfs_config at any quota rung (RouteInfeasible)
SUITE_SCALE = 18
SUITE_APPS = ("bfs", "cc", "sssp")
CLI_SCALE = 14               # the mains' edge files
GATED = ("route_xr_exp_gated", "route_passa_gated", "route_fold_gated")
OTHER_PATHS = ("shuffle", "shuffle2", "onehot")   # apps beside panel
SHUFFLE = ("expand_stream", "group_stream", "grouped_reduce")
# launches each kernel path must show per superstep
PATH_LAUNCHES = {"shuffle": {"expand_stream": 3, "group_stream": 1,
                             "grouped_reduce": 1},
                 "shuffle2": {"windowed_gather": 6, "grouped_reduce": 1},
                 "onehot": {"segment_reduce_gather": 1},
                 "panel": {"route_xr_exp": 1, "route_passa": 1,
                           "route_fold": 2, "hub_fold": 1}}
# one staged SpMV and K12 on its stack1
STAGED_LAUNCHES = {"route_passa_single": 1, "route_expand": 1,
                   "route_passa": 2, "colsum_chunks": 1, "hub_fold": 1,
                   "route_fold": 1, "fold_stripes": 1}
CF_PHASES = ("first", "middle", "last")
DEVICE = "cuda"
# phase 10: the mesh; its launches' hard timeout (seconds) and the
# sparse exchange's capacities (K); each rank of (a) must launch these
MESH_SHAPE = (2, 2)
MESH_TIMEOUT = 600
MESH_CAPS = (4096, 8)
MESH_KERNELS = ("route_xr_exp", "route_passa", "route_fold", "hub_fold",
                "expand_stream", "group_stream", "grouped_reduce",
                "segment_reduce_gather")
GOLDEN_RTOL = 1e-4
# entry(): the JAX entry step's sum (interpret mode on the CPU), and the
# launches of one step
ENTRY_SUM = 1100.7751
ENTRY_LAUNCHES = {"route_xr_exp": 1, "route_passa": 1, "route_fold": 2,
                  "hub_fold": 1}
FOLD_RTOL = {"float32": 1e-5, "float64": 1e-12}
ROOT = os.path.dirname(os.path.abspath(__file__))
SOURCES = {"panel": "graphtap_tpu_torch/csrc/panel_route.cu",
           "shuffle": "graphtap_tpu_torch/csrc/shuffle.cu",
           "gather": "graphtap_tpu_torch/csrc/gather.cu",
           "onehot": "graphtap_tpu_torch/csrc/onehot.cu",
           "probe": "graphtap_tpu_torch/csrc/probe.cu"}
PROBES = ("copy_blocks", "stream_sum", "route_like")
# the fixed-order float folds (ROADMAP F8): two calls give the same bits
FOLDS = ("route_fold", "route_fold_gated", "grouped_reduce",
         "segment_reduce", "segment_reduce_gather", "colsum_chunks")
# the card's published peaks (NVIDIA H100 SXM data sheet): memory bytes/s,
# and non-tensor-core operations/s by value type
PEAK_BYTES = 3.35e12
PEAK_OPS = {"float32": 67e12, "int32": 67e12, "float64": 34e12}
DUMP = 4096                  # K8 library call: scratch slots for holes
# plans built ahead, in PREBUILD_WORKERS worker processes, while the card
# runs the earlier phases: (plan kind, ordering, tile phase, app) of the
# RMAT-20 PageRank graph ("pr"; the TCSC_CF phases: of the graph in pr.cpp's
# TCSC_CF config, f32), and of the RMAT-SUITE_SCALE graphs of BFS, CC and
# SSSP, each through its own config (int32)
PREBUILD = (("spmv2", "ROW", "main", "pr"), ("shuffle", "COL", "main", "pr"),
            *(("spmv3", "ROW", ph, "pr") for ph in CF_PHASES),
            ("spmv3", "ROW", "main", "csc"), ("spmv2", "ROW", "main", "csc18"))
# the CSC PageRank graphs the csc phase plans ahead ("app" -> scale): the
# panel plan at RMAT-SCALE, and the v2 plan at RMAT-SUITE_SCALE, since
# the v2 plans of an RMAT-20 graph take minutes of host time
CSC_APPS = {"csc": SCALE, "csc18": SUITE_SCALE}
# ... and the suite's, handed to the workers only once the kernel rows of
# the PageRank phases are timed, so that their planners (and the route
# solver processes they start) do not crowd the host while it times
SUITE_PREBUILD = tuple((kind, "ROW", "main", app) for app in SUITE_APPS
                       for kind in ("spmv3", "spmv2"))
PREBUILD_WORKERS = 5
_POOL = []                   # the worker pool, while main() runs
PLAN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "graphtap_tpu_torch", "build", "smoke_plans")
MESH_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "graphtap_tpu_torch", "build", "smoke_mesh")
_SUITE_WANT = {}             # app -> its golden state at RMAT-SUITE_SCALE
_PREBUILT = {}               # PREBUILD entry -> AsyncResult of _prebuild
_SMI = []                    # the card's name and power limit (nvidia-smi)
# the kernel lab, (scale, variants) a table: 6 (onehot, K5) at RMAT-SCALE;
# the plain torch variants 0-2, 7, 8 beside 6 at RMAT-18 (at RMAT-20 their
# host tiles put the smoke near its time limit); 3-5 (shuffle, shuffle2,
# panel), which plan both their phases, at RMAT-16
LAB_SETS = ((SCALE, (6,)), (18, (0, 1, 2, 6, 7, 8)), (16, (3, 4, 5)))
LAB_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "graphtap_tpu_torch", "build", "smoke_lab")
REPLACES = {
    "route_xr_exp": "graphtap_tpu/kernels/panel_kernels.py:217",
    "route_passa": "graphtap_tpu/kernels/panel_kernels.py:435",
    "route_fold": "graphtap_tpu/kernels/panel_kernels.py:331",
    "hub_fold": "graphtap_tpu/kernels/panel_kernels.py:507",
    "route_xr_exp_gated": "graphtap_tpu/kernels/panel_kernels.py:226",
    "route_passa_gated": "graphtap_tpu/kernels/panel_kernels.py:453",
    "route_fold_gated": "graphtap_tpu/kernels/panel_kernels.py:356",
    "expand_stream": "graphtap_tpu/kernels/shuffle_kernels.py:65",
    "group_stream": "graphtap_tpu/kernels/shuffle_kernels.py:132",
    "grouped_reduce": "graphtap_tpu/kernels/shuffle_kernels.py:204",
    "windowed_gather": "graphtap_tpu/kernels/gather_kernels.py:102",
    "windowed_gather64": "graphtap_tpu/kernels/gather_kernels.py:166",
    "segment_reduce": "graphtap_tpu/kernels/pallas_spmv.py:165",
    # and the gather, ⊗ and padding mask of graphtap_tpu/engine/
    # executor.py:203-221 before it
    "segment_reduce_gather": "graphtap_tpu/kernels/pallas_spmv.py:165",
    "route_passa_single": "graphtap_tpu/kernels/panel_kernels.py:435",
    "route_expand": "graphtap_tpu/kernels/panel_kernels.py:407",
    "fold_stripes": "graphtap_tpu/kernels/panel_kernels.py:543",
    "colsum_chunks": "graphtap_tpu/kernels/panel_kernels.py:577",
    # P1 is copy_1d (:55) and copy_2d (:80), one _copy_kernel
    "copy_blocks": "tools_dev/bw_probe.py:55",
    "stream_sum": "tools_dev/bw_probe.py:126",
    "route_like": "tools_dev/route_cost_probe.py:57",
}


def log(msg: str) -> None:
    print(f"[smoke] {msg}", flush=True)


def run(cmd) -> str:
    return subprocess.run(cmd, capture_output=True, text=True, timeout=60,
                          check=True).stdout.strip()


def phase_device(torch) -> None:
    smi = run(["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"])
    _SMI.append(smi)
    print(smi, flush=True)
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    ver = run([nvcc, "--version"]).splitlines()[-1] if os.path.exists(
        nvcc) else "nvcc not found"
    log(f"device: {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}; {ver}")


def phase_build() -> None:
    from graphtap_tpu_torch.kernels import _cuda
    t0 = time.perf_counter()
    path = _cuda.build()
    _cuda.library()
    log(f"build: {path.name} in {time.perf_counter() - t0:.1f} s")
    entry = ""
    for line in _cuda.build_log.splitlines():
        if "Compiling entry" in line:       # mangled name: keep the kernel
            name = line.split("'")[1]
            entry = name.split("_cu_")[-1][8:] if "_cu_" in name else name
        elif "registers" in line:
            log(f"  ptxas {entry}: {line.split(':', 1)[1].strip()}")


def _same(a, b) -> bool:
    import torch
    return a.shape == b.shape and a.dtype == b.dtype and bool(
        torch.equal(a, b))


def _fold_ok(a, b, kind: str, rtol: float) -> bool:
    """A whole SpMV or a library call against the kernels: int bit for
    bit; float sums elementwise within rtol."""
    import torch
    if kind != "sum" or not b.dtype.is_floating_point:
        return _same(a, b)
    return bool(torch.all((a - b).abs() <= rtol * b.abs()))


def _twice(tag, name, kern, first) -> None:
    """A fixed-order fold (FOLDS) launched again on the same inputs gives
    the same bits as its first call ``first`` (ROADMAP F8)."""
    ok = _same(first, kern())
    log(f"{tag} {name}: second call {'bit-identical' if ok else 'DIFFERS'}")
    if not ok:
        raise AssertionError(f"{name}: two calls on the same inputs differ "
                             f"({tag})")


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _bound(nbytes: int, ops: int, dtype) -> tuple:
    """(ms, "bytes" | "operations"): the least time the card could take
    for a call that must move ``nbytes`` and do ``ops`` operations on
    values of ``dtype``, at the published peaks."""
    t_b = nbytes / PEAK_BYTES
    t_o = ops / PEAK_OPS[str(dtype).split(".")[-1]]
    return max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations"


def _kernel_calls(t, meta, sem, st):
    """(name, kernel call, plain call, (bytes, ops)) for each launch of one
    SpMV, on the stage tensors ``st`` of that SpMV (the kernels' own
    inputs). Bytes count each input read once (the whole source table,
    the panels' plan blocks, bases, dst and seg) and each output written
    once; ops count the ⊗ and ⊕ the kernel must do."""
    from graphtap_tpu_torch.kernels import panel_kernels as pk
    from graphtap_tpu_torch.kernels.panel_engine import fold_tables
    fill, kind = sem.identity, sem.reduce_kind
    mul = ("mul" if kind == "sum" else "add_sat") if meta.has_w else "none"
    es = st["x2d"].element_size()
    panel = pk.PROWS * pk.LANES
    folds = fold_tables(t, meta, st["x2d"].dtype)   # as the path keeps them
    xe = (st["x2d"], t["xr_bases"], t["xe_plan"], t.get("w_stream"), fill,
          meta.exp_panels + 1, meta.xr_nwin, mul)
    nxe = meta.exp_panels + 1
    xe_w = (_nbytes(st["x2d"]) + 4 * nxe * meta.xr_nwin
            + nxe * pk.xe_plan_rows(meta.xr_nwin) * pk.LANES
            + nxe * panel * es * (2 if meta.has_w else 1),
            nxe * panel if meta.has_w else 0)
    pa = (st["s0"], t["pa_bases"], t["pa_plan"], fill, meta.pa_panels + 1,
          meta.pa_nwin)
    npa = meta.pa_panels + 1
    _log_passa("kernels", npa, meta.pa_nwin, st["s0"])
    pa_w = (_nbytes(st["s0"]) + 4 * npa * meta.pa_nwin
            + npa * pk.plan_rows(meta.pa_nwin * pk.STRIPE) * pk.LANES
            + npa * panel * es, 0)
    fx = (st["s1"], t["fixr_bases"], t["fixr_plan"], t["fix_dst"],
          t["fixr_seg"], meta.nrb, kind, fill, meta.fix_panels,
          meta.fixr_nwin)
    hb = (st["y_mid"], t["hub_mask"], kind)
    f2 = (st["y_hub"], t["f2_bases"], t["f2_plan"], t["fix2_dst"],
          t["f2_seg"], meta.f2_rows, kind, fill, meta.f2_panels,
          meta.f2_nwin)

    def fold_work(src, npan, nwin, nrows):
        return (_nbytes(src) + 4 * npan * nwin
                + npan * pk.plan_rows(nwin * pk.STRIPE) * pk.LANES
                + 4 * npan * (pk.STRIPE + 1) + nrows * pk.LANES * es,
                npan * panel)
    return [("route_xr_exp", lambda: pk.route_xr_exp(*xe),
             lambda: pk.route_xr_exp_plain(*xe), xe_w),
            ("route_passa", lambda: pk.route_passa(*pa),
             lambda: pk.route_passa_plain(*pa), pa_w),
            ("route_fold", lambda: pk.route_fold(*fx, **folds["fixr"]),
             lambda: pk.route_fold_plain(*fx),
             fold_work(st["s1"], meta.fix_panels, meta.fixr_nwin, meta.nrb)),
            ("hub_fold", lambda: pk.hub_fold(*hb),
             lambda: pk.hub_fold_plain(*hb),
             (2 * _nbytes(st["y_mid"]) + _nbytes(t["hub_mask"]),
              7 * st["y_mid"].numel())),
            ("route_fold", lambda: pk.route_fold(*f2, **folds["fix2"]),
             lambda: pk.route_fold_plain(*f2),
             fold_work(st["y_hub"], meta.f2_panels, meta.f2_nwin,
                       meta.f2_rows))]


def _fold_library(torch, src, bases, plan, dst, seg, nrows, kind, fill,
                  npanels, nwin, plan_idx=None):
    """(one torch.scatter_reduce computing K3 on these inputs, or None;
    the most (row, lane) slots one source slot feeds). K3 routes the
    source, then ⊕-folds each 8-row band into y row dst; one scatter over
    a destination per source slot computes it only if no source slot is
    routed twice. ``plan_idx``: the gated launch's plan map."""
    from graphtap_tpu_torch.kernels import panel_kernels as pk
    from graphtap_tpu_torch.tools import timing
    routed = pk.route_passa_plain(timing.slot_ids(src), bases, plan, -1,
                                  npanels, nwin, plan_idx)
    live = routed >= 0
    mult = int(torch.bincount(routed[live].long()).max()) if bool(
        live.any()) else 0
    if mult > 1:
        return None, mult
    rows = pk._fold_rows(dst[:npanels * pk.STRIPE], seg[:npanels], nrows)
    dest = (rows.repeat_interleave(pk.STRIPE)[:, None] * pk.LANES
            + torch.arange(pk.LANES, device=src.device))
    spread = torch.arange(src.numel(), device=src.device) % DUMP
    to = nrows * pk.LANES + spread            # unrouted slots: scratch
    to[routed[live].long()] = dest[live]
    y0 = torch.full((nrows * pk.LANES + DUMP,), fill, dtype=src.dtype,
                    device=src.device)
    op = {"sum": "sum", "min": "amin", "max": "amax"}[kind]
    return (lambda: torch.scatter_reduce(y0, 0, to, src.reshape(-1), op)[
        :nrows * pk.LANES].view(nrows, pk.LANES)), mult


def _panel_libraries(torch, t, meta, sem, st):
    """The library call of each of _kernel_calls' calls, in its order
    (None where no one PyTorch call computes the function): torch.take for
    K1 (unweighted) and K2, torch.scatter_reduce for K3 when both its
    calls qualify (_fold_library), none for K4, whose butterfly's float
    order is part of its contract."""
    from graphtap_tpu_torch.kernels import panel_kernels as pk
    from graphtap_tpu_torch.tools import timing
    fill, kind = sem.identity, sem.reduce_kind
    k1 = None
    if not meta.has_w:
        idx = pk.route_xr_exp_plain(
            timing.slot_ids(st["x2d"]), t["xr_bases"], t["xe_plan"], None,
            -1, meta.exp_panels + 1, meta.xr_nwin)
        k1 = timing.take_call(st["x2d"], idx, fill)
    idx = pk.route_passa_plain(timing.slot_ids(st["s0"]), t["pa_bases"],
                               t["pa_plan"], -1, meta.pa_panels + 1,
                               meta.pa_nwin)
    k2 = timing.take_call(st["s0"], idx, fill)
    fx, m1 = _fold_library(torch, st["s1"], t["fixr_bases"], t["fixr_plan"],
                           t["fix_dst"], t["fixr_seg"], meta.nrb, kind, fill,
                           meta.fix_panels, meta.fixr_nwin)
    f2, m2 = _fold_library(torch, st["y_hub"], t["f2_bases"], t["f2_plan"],
                           t["fix2_dst"], t["f2_seg"], meta.f2_rows, kind,
                           fill, meta.f2_panels, meta.f2_nwin)
    log(f"kernels: route_fold's source slots each feed at most {m1} (fixr) "
        f"and {m2} (fix2) (row, lane) slots: library call "
        f"{'torch.scatter_reduce' if fx and f2 else 'none'}")
    if not (fx and f2):
        fx = f2 = None
    return [k1, k2, fx, None, f2]


def phase_parity(torch, np) -> None:
    from graphtap_tpu_torch import GraphConfig, Graph
    from graphtap_tpu_torch.ingest import rmat_edges
    from graphtap_tpu_torch.kernels.panel_engine import spmv3_stages
    from graphtap_tpu_torch.kernels.panel_meta import build_spmv3_meta
    from graphtap_tpu_torch.kernels.semiring import (INF_I32, min_plus,
                                                     plus_times)
    from graphtap_tpu_torch.tools.convert import meta_from_numpy
    rng = np.random.default_rng(SEED)
    n = 1 << PARITY_SCALE
    for dtype, sem, weighted in ((np.float32, plus_times(), False),
                                 (np.float64, plus_times(), True),
                                 (np.int32, min_plus(), True)):
        r, c, w = rmat_edges(PARITY_SCALE, EDGE_FACTOR, seed=SEED,
                             weighted=weighted)
        g = Graph.from_edges(r, c, w, GraphConfig(num_vertices=n,
                                                  transpose=True))
        tiles = g.tiled()
        meta = build_spmv3_meta(tiles, value_dtype=dtype)
        t = meta_from_numpy(meta.arrays, DEVICE)
        if dtype == np.int32:
            xv = rng.integers(0, 1000, size=g.part.tile_cols).astype(dtype)
            xv[rng.random(xv.size) < 0.3] = INF_I32
        else:
            xv = rng.random(g.part.tile_cols).astype(dtype)
        x = torch.from_numpy(xv).to(DEVICE)
        st = spmv3_stages(x, t, meta, sem, g.part.tile_rows)
        name_dt = np.dtype(dtype).name
        tag = f"parity {name_dt} {sem.reduce_kind}"
        _log_ring(tag, meta, x.dtype)
        for name, kern, plain, _ in _kernel_calls(t, meta, sem, st):
            _check_call(tag, name, kern(), plain(), kern)
        if dtype == np.float32:
            _gated_fold_f32(torch, np, t, meta, st, tag)
        # the chain as a whole against a dense numpy SpMV of the tiles
        n_e = int(tiles.nnz[0, 0])
        rows = tiles.rows[0, :n_e].astype(np.int64)
        cols = tiles.cols[0, :n_e].astype(np.int64)
        iv = tiles.iv_dense[0]
        if sem.reduce_kind == "sum":
            contrib = xv[cols].astype(np.float64)
            if weighted:
                contrib = contrib * tiles.weights[0, :n_e]
            yc = np.zeros(tiles.NR)
            np.add.at(yc, rows, contrib)
            ref = np.where(iv >= 0, yc[np.maximum(iv, 0)], 0.0)
            got = st["y"].double().cpu().numpy()
            ok = np.allclose(got, ref, rtol=FOLD_RTOL[name_dt] * 10,
                             atol=0)
        else:
            xs = xv[cols].astype(np.int64)
            contrib = np.where(xs >= INF_I32, INF_I32,
                               xs + tiles.weights[0, :n_e])
            yc = np.full(tiles.NR, INF_I32, np.int64)
            np.minimum.at(yc, rows, contrib)
            ref = np.where(iv >= 0, yc[np.maximum(iv, 0)], INF_I32)
            ok = np.array_equal(st["y"].cpu().numpy(), ref.astype(np.int32))
        log(f"parity {name_dt} {sem.reduce_kind} spmv3 vs numpy SpMV: "
            f"{'ok' if ok else 'MISMATCH'}")
        if not ok:
            raise AssertionError(f"spmv3 disagrees with numpy ({name_dt})")


def _gated_fold_f32(torch, np, t, meta, st, tag) -> None:
    """The gated K3 in f32 sum with a third of the fixr panels pointed at
    the fill block: equal to its plain version, twice with the same
    bits."""
    from graphtap_tpu_torch.kernels import panel_kernels as pk
    from graphtap_tpu_torch.kernels.panel_meta import fill_blocks
    fb = fill_blocks(meta)["fixr_plan"]
    q = np.arange(meta.fix_panels, dtype=np.int32)
    q[np.random.default_rng(SEED).random(q.size) < 1 / 3] = fb
    q = torch.from_numpy(q).to(DEVICE)
    fx = (st["s1"], t["fixr_bases"], t["fixr_plan"], t["fix_dst"],
          t["fixr_seg"], meta.nrb, "sum", 0.0, meta.fix_panels,
          meta.fixr_nwin)

    def kern():
        return pk.route_fold(*fx, plan_idx=q, fill_block=fb)
    _check_call(tag, "route_fold_gated", kern(),
                pk.route_fold_plain(*fx, plan_idx=q), kern)


def _gated_work(src, bases, plan_idx, fill_block, nwin, prows, out_bytes,
                w_block_bytes=0, extra_per_panel=0):
    """(bytes, ops) a gated route call needs on this run's maps: the plan
    (and weight) blocks of the distinct plan indices, the distinct source
    windows and the bases of the panels not pointed at the fill block,
    plan_idx itself, and the output."""
    import torch
    npan = plan_idx.numel()
    live = plan_idx != fill_block
    nlive = int(live.sum())
    blocks = int(torch.unique(plan_idx).numel())
    wins = bases.view(npan, nwin)[live]
    nwins = int(torch.unique(wins).numel()) if nlive else 0
    es = src.element_size()
    return (blocks * (prows * 128 + w_block_bytes) + 4 * npan
            + 4 * nlive * nwin + nwins * 8 * 128 * es
            + nlive * extra_per_panel + out_bytes, 0)


def _gated_calls(t, meta, sem, st, maps):
    """(name, kernel call, plain call, (bytes, ops)) for the gated K1-K3
    of one SpMV on its stage tensors ``st`` and gating maps ``maps``."""
    from graphtap_tpu_torch.kernels import panel_kernels as pk
    from graphtap_tpu_torch.kernels.panel_engine import fold_tables
    from graphtap_tpu_torch.kernels.panel_meta import fill_blocks
    fill, kind = sem.identity, sem.reduce_kind
    mul = "add_sat" if meta.has_w else "none"
    xe_b, xe_q, pa_b, pa_q, fx_b, fx_q = maps
    fixr = fold_tables(t, meta, st["s1"].dtype)["fixr"]
    fb = fill_blocks(meta)
    es = st["x2d"].element_size()
    panel = pk.PROWS * pk.LANES
    nxe, npa = meta.exp_panels + 1, meta.pa_panels + 1
    _log_passa(f"gated ({int((pa_q[:npa] != fb['pa_plan']).sum())} panels "
               f"not at the fill block)", npa, meta.pa_nwin, st["s0"])
    work = [
        _gated_work(st["x2d"], xe_b, xe_q[:nxe], fb["xe_plan"],
                    meta.xr_nwin, pk.xe_plan_rows(meta.xr_nwin),
                    nxe * panel * es, panel * es if meta.has_w else 0),
        _gated_work(st["s0"], pa_b, pa_q[:npa], fb["pa_plan"], meta.pa_nwin,
                    pk.plan_rows(meta.pa_nwin * pk.STRIPE),
                    npa * panel * es),
        _gated_work(st["s1"], fx_b, fx_q[:meta.fix_panels], fb["fixr_plan"],
                    meta.fixr_nwin, pk.plan_rows(meta.fixr_nwin * pk.STRIPE),
                    meta.nrb * pk.LANES * es,
                    extra_per_panel=4 * (pk.STRIPE + 1))]
    xe = (st["x2d"], xe_b, t["xe_plan"], t.get("w_stream"), fill,
          meta.exp_panels + 1, meta.xr_nwin, mul)
    pa = (st["s0"], pa_b, t["pa_plan"], fill, meta.pa_panels + 1,
          meta.pa_nwin)
    fx = (st["s1"], fx_b, t["fixr_plan"], t["fix_dst"], t["fixr_seg"],
          meta.nrb, kind, fill, meta.fix_panels, meta.fixr_nwin)
    return [("route_xr_exp_gated",
             lambda: pk.route_xr_exp(*xe, plan_idx=xe_q,
                                     fill_block=fb["xe_plan"]),
             lambda: pk.route_xr_exp_plain(*xe, plan_idx=xe_q), work[0]),
            ("route_passa_gated",
             lambda: pk.route_passa(*pa, plan_idx=pa_q,
                                    fill_block=fb["pa_plan"]),
             lambda: pk.route_passa_plain(*pa, plan_idx=pa_q), work[1]),
            ("route_fold_gated",
             lambda: pk.route_fold(*fx, plan_idx=fx_q,
                                   fill_block=fb["fixr_plan"], **fixr),
             lambda: pk.route_fold_plain(*fx, plan_idx=fx_q), work[2])]


def _gated_libraries(torch, t, meta, sem, st, maps):
    """The library call of each of _gated_calls' calls, in its order:
    torch.take over the index precomputed from the gated maps for K1
    (unweighted) and K2, one torch.scatter_reduce for K3 where no source
    slot is routed twice (_fold_library), else None."""
    from graphtap_tpu_torch.kernels import panel_kernels as pk
    from graphtap_tpu_torch.tools import timing
    fill, kind = sem.identity, sem.reduce_kind
    xe_b, xe_q, pa_b, pa_q, fx_b, fx_q = maps
    k1 = None
    if not meta.has_w:
        idx = pk.route_xr_exp_plain(
            timing.slot_ids(st["x2d"]), xe_b, t["xe_plan"], None, -1,
            meta.exp_panels + 1, meta.xr_nwin, plan_idx=xe_q)
        k1 = timing.take_call(st["x2d"], idx, fill)
    idx = pk.route_passa_plain(timing.slot_ids(st["s0"]), pa_b,
                               t["pa_plan"], -1, meta.pa_panels + 1,
                               meta.pa_nwin, plan_idx=pa_q)
    k2 = timing.take_call(st["s0"], idx, fill)
    k3, mult = _fold_library(torch, st["s1"], fx_b, t["fixr_plan"],
                             t["fix_dst"], t["fixr_seg"], meta.nrb, kind,
                             fill, meta.fix_panels, meta.fixr_nwin,
                             plan_idx=fx_q)
    log(f"kernels: gated route_fold's source slots each feed at most {mult}"
        f" (row, lane) slots: library call "
        f"{'torch.scatter_reduce' if k3 else 'none'}")
    return [k1, k2, k3]


def phase_gated_parity(torch, np) -> None:
    from graphtap_tpu_torch import Graph
    from graphtap_tpu_torch.apps import bfs_config, sssp_config
    from graphtap_tpu_torch.ingest import rmat_edges
    from graphtap_tpu_torch.kernels.panel_engine import spmv3_stages
    from graphtap_tpu_torch.kernels.panel_meta import (build_spmv3_meta,
                                                       fill_blocks)
    from graphtap_tpu_torch.kernels.semiring import min_plus, min_select
    from graphtap_tpu_torch.tools.convert import meta_from_numpy
    rng = np.random.default_rng(SEED)
    n = 1 << PARITY_SCALE
    for weighted, cfg_fn, sem in ((True, sssp_config, min_plus()),
                                  (False, bfs_config, min_select())):
        r, c, w = rmat_edges(PARITY_SCALE, EDGE_FACTOR, seed=SEED,
                             weighted=weighted)
        g = Graph.from_edges(r, c, w, cfg_fn(n))
        meta = build_spmv3_meta(g.tiled(), value_dtype=np.int32)
        t = meta_from_numpy(meta.arrays, DEVICE)
        nc, inf = g.part.tile_cols, sem.identity
        _log_ring(f"gated parity {'weighted' if weighted else 'unweighted'}",
                  meta, torch.int32)
        for share in (0.02, 0.30, 0.0):
            xv = np.full(nc, inf, np.int32)
            k = int(nc * share)
            lo = (nc - k) // 2
            xv[lo:lo + k] = rng.integers(0, 1000, k)
            x = torch.from_numpy(xv).to(DEVICE)
            st = spmv3_stages(x, t, meta, sem, g.part.tile_rows, gate=True)
            static = spmv3_stages(x, t, meta, sem, g.part.tile_rows)
            maps = st["maps"]
            fb = fill_blocks(meta)
            # real panels gated off (the fill panels point at themselves)
            off = [int((q[:n] == fb[nm]).sum()) for q, nm, n in zip(
                maps[1::2], ("xe_plan", "pa_plan", "fixr_plan"),
                (meta.exp_panels, meta.pa_panels, meta.fix_panels))]
            tag = (f"{'weighted' if weighted else 'unweighted'} "
                   f"{share:.0%} frontier")
            for name, kern, plain, _ in _gated_calls(t, meta, sem, st,
                                                     maps):
                _check_call(f"gated parity {tag}", name, kern(), plain(),
                            kern)
            ok = _same(st["y"], static["y"])
            log(f"gated parity {tag}: gated spmv3 vs static "
                f"{'ok' if ok else 'MISMATCH'}; panels gated off (xe, pa, "
                f"fixr) {off}")
            if not ok:
                raise AssertionError(f"gated spmv3 != static ({tag})")


def _shuffle_calls(torch, t, meta, sem, st):
    """(name, kernel call, plain call, (bytes, ops), library call or None)
    for each launch group of one shuffle SpMV on its stage tensors ``st``:
    K6 three times (the stream expand, the dense expansion's A and B
    windows), K7 (one gather through its passes' composed index), K8. Bytes
    count what this run's data needs: K6 reads ev everywhere and slot,
    lane (and w) where ev is set, the whole table, and writes every slot;
    K7 reads its int32 index and each live source value once, and writes
    the whole stream; K8 reads ev everywhere, lr and the value
    where ev is set, chunk_block, and writes y. The library calls (one
    PyTorch call each, on indices precomputed here): ``torch.take`` for
    K6 (unweighted only) and for K7 (over the passes' composed index, as
    int64), ``torch.scatter_reduce`` for K8."""
    from graphtap_tpu_torch.kernels import shuffle_kernels as sk
    from graphtap_tpu_torch.kernels.shuffle_engine import mul_kind
    from graphtap_tpu_torch.kernels.shuffle_plan import LANES, SUB, WROWS
    from graphtap_tpu_torch.tools import timing
    fill, kind = sem.identity, sem.reduce_kind
    mul = mul_kind(meta, sem)
    es = st["x3d"].element_size()

    def expand(tab, grp, slot, lane, ev, w, mk):
        args = (tab, grp, slot, lane, ev, w, fill, mk)
        valid = ev != 0
        nvalid = int(valid.sum())
        work = (_nbytes(tab) + _nbytes(grp) + _nbytes(ev)
                + nvalid * (2 + (es if w is not None else 0))
                + slot.numel() * es, nvalid if w is not None else 0)
        lib = None
        if w is None:
            ext = torch.cat([tab.reshape(-1), tab.new_full((1,), fill)])
            win = grp.long().repeat_interleave(SUB)[:, None]
            src = torch.where(valid, (win * WROWS + slot.long()) * LANES
                              + lane.long(), ext.numel() - 1)
            lib = lambda: torch.take(ext, src)          # noqa: E731
        return (lambda: sk.expand_stream(*args),
                lambda: sk.expand_stream_plain(*args), work, lib)

    calls = [("expand_stream", *expand(
        st["x3d"], t["grp"], t["slot"], t["lane"], t["ev_x"],
        t.get("w_stream"), mul))]
    for half in ("a", "b"):
        calls.append(("expand_stream", *expand(
            st["ytab"], t[f"mexp_grp_{half}"], t[f"mexp_slot_{half}"],
            t["mexp_lane"], t[f"mexp_ev_{half}"], None, "none")))
    # K7: one gather through the passes' composed index, kept in t as the
    # path keeps it
    gsrc = sk.group_tables(t, meta)["src"]
    gargs = (st["contrib"], t["frag_dst"], t["frag_idx"],
             meta.rows_per_super, meta.npasses, fill)
    gbytes = (_nbytes(gsrc) + int((gsrc >= 0).sum()) * es
              + _nbytes(st["contrib"]))
    calls.append(("group_stream", lambda: sk.group_stream(*gargs, src=gsrc),
                  lambda: sk.group_stream_plain(*gargs), (gbytes, 0),
                  timing.take_call(st["contrib"], gsrc, fill)))
    rargs = (st["grouped"], t["lr"], t["ev_r"], t["chunk_block"],
             meta.nblocks, kind, fill)
    valid = t["ev_r"] != 0
    nvalid = int(valid.sum())
    blk = t["chunk_block"].long().repeat_interleave(8 * LANES).view(
        -1, LANES)
    # holes go to DUMP scratch slots past y, spread so that they do not
    # all contend for one address
    spread = torch.arange(valid.numel(), device=valid.device).view(
        valid.shape) % DUMP
    flat = torch.where(valid, blk * LANES + t["lr"].long(),
                       meta.nblocks * LANES + spread).reshape(-1)
    y0 = torch.full((meta.nblocks * LANES + DUMP,), fill,
                    dtype=st["grouped"].dtype, device=flat.device)
    op = {"sum": "sum", "min": "amin", "max": "amax"}[kind]
    folds = sk.reduce_tables(t, meta.nblocks, st["grouped"].dtype)
    calls.append(("grouped_reduce",
                  lambda: sk.grouped_reduce(*rargs, **folds),
                  lambda: sk.grouped_reduce_plain(*rargs),
                  (_nbytes(t["ev_r"]) + nvalid * (1 + es)
                   + _nbytes(t["chunk_block"])
                   + meta.nblocks * LANES * es, nvalid),
                  lambda: torch.scatter_reduce(y0, 0, flat,
                                               st["grouped"].reshape(-1),
                                               op)))
    return calls


def phase_shuffle_parity(torch, np) -> None:
    from graphtap_tpu_torch import GraphConfig, Graph
    from graphtap_tpu_torch.apps import bfs_config, sssp_config
    from graphtap_tpu_torch.ingest import rmat_edges
    from graphtap_tpu_torch.kernels.semiring import (INF_I32, min_plus,
                                                     min_select, plus_times)
    from graphtap_tpu_torch.kernels.shuffle_engine import (
        build_shuffle_plans, spmv_stages)
    from graphtap_tpu_torch.tools.convert import meta_from_numpy
    rng = np.random.default_rng(SEED)
    n = 1 << PARITY_SCALE
    for tag, dtype, sem, weighted, cfg in (
            ("f32 sum", np.float32, plus_times(), False,
             GraphConfig(num_vertices=n, transpose=True)),
            ("f64 sum weighted", np.float64, plus_times(), True,
             GraphConfig(num_vertices=n, transpose=True)),
            ("int32 min weighted (sssp_config)", np.int32, min_plus(), True,
             sssp_config(n)),
            ("int32 min (bfs_config)", np.int32, min_select(), False,
             bfs_config(n))):
        r, c, w = rmat_edges(PARITY_SCALE, EDGE_FACTOR, seed=SEED,
                             weighted=weighted)
        g = Graph.from_edges(r, c, w, cfg)
        t0 = time.perf_counter()
        meta = build_shuffle_plans(g.tiled(), value_dtype=dtype)
        plan_s = time.perf_counter() - t0
        t = meta_from_numpy(meta.arrays, DEVICE)
        if dtype == np.int32:
            xv = rng.integers(0, 1000, size=g.part.tile_cols).astype(dtype)
            xv[rng.random(xv.size) < 0.3] = INF_I32
        else:
            xv = rng.random(g.part.tile_cols).astype(dtype)
        x = torch.from_numpy(xv).to(DEVICE)
        st = spmv_stages(x, t, meta, sem, g.part.tile_rows)
        log(f"shuffle parity {tag}: plans {plan_s:.2f} s, {meta.nsupers} "
            f"supers, {meta.npasses} passes, SMAX {meta.SMAX}")
        for name, kern, plain, _, _ in _shuffle_calls(torch, t, meta, sem,
                                                       st):
            _check_call(f"shuffle parity {tag}", name, kern(), plain(), kern)
        # the whole SpMV against the plain pipeline (the CPU wrappers)
        want = spmv_stages(x.cpu(), meta_from_numpy(meta.arrays, "cpu"),
                           meta, sem, g.part.tile_rows)["y"]
        ok = _fold_ok(st["y"].cpu(), want, sem.reduce_kind,
                      FOLD_RTOL.get(np.dtype(dtype).name, 0))
        log(f"shuffle parity {tag}: spmv_local vs plain pipeline "
            f"{'ok' if ok else 'MISMATCH'}")
        if not ok:
            raise AssertionError(f"shuffle spmv_local disagrees with the "
                                 f"plain pipeline ({tag})")


def _gather_call(torch, name, kern, plain, src, plan, nsub, fill, w=None,
                 mk="none"):
    """(name, kernel call, plain call, (bytes, ops), library call or None)
    of one K9 or K10 call on source ``src`` with the stage plan ``plan``
    (wsel, base, nact, cidx, meta). Bytes: the source table, meta, wsel,
    base and nact whole, one cidx byte per live slot, the weights, and the
    output written once; ops: one ⊗ per slot when weighted. The library
    call (unweighted only): torch.take over the precomputed source index."""
    from graphtap_tpu_torch.kernels.gather_kernels import gather_index
    from graphtap_tpu_torch.tools import timing
    args = (src, *plan) + ((w, fill, nsub, mk) if name == "windowed_gather"
                           else (fill, nsub))
    idx = gather_index(*plan, nsub)
    es = src.element_size()
    work = (_nbytes(src) + sum(_nbytes(a) for a in plan[:3])
            + _nbytes(plan[4]) + int((idx >= 0).sum())
            + (_nbytes(w) if w is not None else 0) + idx.numel() * es,
            idx.numel() if w is not None else 0)
    lib = timing.take_call(src, idx, fill) if w is None else None
    return (name, lambda: kern(*args), lambda: plain(*args), work, lib)


def _v2_calls(torch, t, meta, sem, st):
    """K9's six stage calls of one v2 SpMV on its stage tensors ``st``."""
    from graphtap_tpu_torch.kernels import gather_kernels as gk
    from graphtap_tpu_torch.kernels.gather_engine import STAGES, stage_plan
    from graphtap_tpu_torch.kernels.shuffle_engine import mul_kind
    srcs = dict(zip(STAGES, ("x2d", "exp", "p0", "p1", "p2", "y_blocks")))
    for k in STAGES:
        log(f"kernels windowed_gather stage {k}: "
            f"{stage_plan(t, k)[4].shape[0]} steps of 8 rows, nsub "
            f"{meta.nsub[k]}, ⊗ "
            f"{mul_kind(meta, sem) if k == 'exp' else 'none'}")
    return [_gather_call(torch, "windowed_gather", gk.windowed_gather,
                         gk.windowed_gather_plain, st[srcs[k]],
                         stage_plan(t, k), meta.nsub[k], sem.identity,
                         t.get("w_stream") if k == "exp" else None,
                         mul_kind(meta, sem) if k == "exp" else "none")
            for k in STAGES]


def _k10_call(torch, np, t, meta, sem, st, tag):
    """K10 on the first stage of a v2 plan (mx, exp, p0 .. p3) whose
    source index re-plans with 64-row steps (build_gather_plan raises
    where a step needs more than 30 subops)."""
    from graphtap_tpu_torch.kernels import gather_kernels as gk
    from graphtap_tpu_torch.kernels.gather_engine import (stage_plan,
                                                          stage_src_rows)
    from graphtap_tpu_torch.kernels.gather_plan import build_gather_plan
    srcs = {"mx": "y_blocks", "exp": "x2d", "p0": "exp", "p1": "p0",
            "p2": "p1", "p3": "p2"}
    for k, src in srcs.items():
        src_of = gk.gather_index(*stage_plan(t, k), meta.nsub[k]).view(
            -1).cpu().numpy()
        rows = gk.seg_round_rows64(meta.out_rows[k])
        src_of = np.concatenate([src_of, np.full(rows * 128 - src_of.size,
                                                 -1, np.int64)])
        t0 = time.perf_counter()
        try:
            plan = build_gather_plan(stage_src_rows(meta, k), rows, src_of,
                                     block_rows=gk.BLK64)
        except ValueError as e:
            log(f"{tag}: stage {k} does not re-plan with 64-row steps ({e})")
            continue
        log(f"{tag}: K10 on stage {k} re-planned with 64-row steps in "
            f"{time.perf_counter() - t0:.1f} s: {rows // gk.BLK64} steps, "
            f"nsub {plan.nsub}")
        dev = st[src].device
        p = tuple(torch.from_numpy(a).to(dev) for a in (
            plan.wsel, plan.base, plan.nact, plan.cidx, plan.meta))
        call = _gather_call(torch, "windowed_gather64", gk.windowed_gather64,
                            gk.windowed_gather64_plain, st[src], p,
                            plan.nsub, sem.identity)
        got = call[1]()
        valid = torch.from_numpy(src_of >= 0).to(dev)
        want = st[src].reshape(-1)[torch.from_numpy(src_of).to(dev)[valid]]
        if not _same(got.reshape(-1)[valid], want):
            raise AssertionError(f"{tag}: K10 does not gather the stage's "
                                 f"source slots")
        # the same plan over f64 and int32 sources
        gen = torch.Generator(device=dev).manual_seed(SEED)
        for dt, fill in ((torch.float64, 0.0), (torch.int32, -1)):
            s2 = (torch.rand(st[src].shape, dtype=dt, device=dev,
                             generator=gen) if dt.is_floating_point else
                  torch.randint(0, 1 << 30, st[src].shape, dtype=dt,
                                device=dev, generator=gen))
            args = (s2, *p, fill, plan.nsub)
            _check_call(f"{tag} {dt}", "windowed_gather64",
                        gk.windowed_gather64(*args),
                        gk.windowed_gather64_plain(*args))
        return call
    raise AssertionError(f"{tag}: no stage re-plans with 64-row steps")


def _k5_call(torch, t, plan, nr, sem, contrib):
    """(name, kernel call, plain call, (bytes, ops), library call, f64
    plain call, f64 library call) of K5 on ``contrib``: bytes read every
    contribution and its int32 row (the kernel cannot know the padding),
    chunk_block, and write y; ops one ⊕ per contribution; the library
    call torch.scatter_reduce over the precomputed destination slot; the
    last two the plain version and the library call on the contributions
    in f64."""
    from graphtap_tpu_torch.kernels import onehot_spmv as oh
    args = (contrib, t["oh_lrows"], t["oh_chunk_block"], plan.nblocks, nr,
            sem.reduce_kind, sem.identity)
    es = contrib.element_size()
    work = (_nbytes(contrib) + _nbytes(t["oh_lrows"])
            + _nbytes(t["oh_chunk_block"]) + plan.nblocks * oh.RB * es,
            contrib.numel())
    dst = (t["oh_chunk_block"].long().repeat_interleave(oh.CHUNK) * oh.RB
           + t["oh_lrows"].long())
    y0 = torch.full((plan.nblocks * oh.RB,), sem.identity,
                    dtype=contrib.dtype, device=contrib.device)
    op = {"sum": "sum", "min": "amin", "max": "amax"}[sem.reduce_kind]
    f64 = (contrib.double(), *args[1:])
    folds = oh.fold_tables(t, plan, contrib.dtype)   # as the path keeps them
    return ("segment_reduce", lambda: oh.segment_reduce(*args, **folds),
            lambda: oh.segment_reduce_plain(*args), work,
            lambda: torch.scatter_reduce(y0, 0, dst, contrib, op)[:nr],
            lambda: oh.segment_reduce_plain(*f64),
            lambda: torch.scatter_reduce(y0.double(), 0, dst, f64[0],
                                         op)[:nr])


def _k5_gather_call(torch, t, plan, nr, sem, x):
    """(name, kernel call, plain call, (bytes, ops), library call) of K5
    from the plan on x: bytes read every slot's col, row and ev byte (and
    weight), chunk_block and x once, and write y; ops one ⊗ (where
    weighted) and one ⊕ per slot; the "library" call is what the kernel
    replaces, the contributions built in torch and K5, which must give
    the same bits."""
    from graphtap_tpu_torch.kernels import onehot_spmv as oh
    from graphtap_tpu_torch.kernels.shuffle_engine import mul_kind
    folds = oh.fold_tables(t, plan, x.dtype)
    w = oh.plan_weights(t, x.dtype)
    args = (x, t["oh_cols"], t["oh_evalid"], w, t["oh_lrows"],
            t["oh_chunk_block"], plan.nblocks, nr, plan.col_bound,
            sem.reduce_kind, mul_kind(plan, sem), sem.identity)
    slot = 9 + (0 if w is None else w.element_size())
    work = (plan.Ep * slot + _nbytes(t["oh_chunk_block"]) + _nbytes(x)
            + plan.nblocks * oh.RB * x.element_size(),
            plan.Ep * (1 if w is None else 2))
    return ("segment_reduce_gather",
            lambda: oh.segment_reduce_gather(*args, **folds),
            lambda: oh.segment_reduce_gather_plain(*args), work,
            lambda: oh.segment_reduce(
                oh.onehot_contrib(x, t, sem), t["oh_lrows"],
                t["oh_chunk_block"], plan.nblocks, nr, sem.reduce_kind,
                sem.identity, **folds))


def _check_call(tag, name, a, b, kern=None) -> None:
    """A kernel's output ``a`` against its plain version's ``b``, bit for
    bit (the float folds K3, K5 and K8 too: their plain versions fold in
    the kernels' order); a fold (FOLDS) is launched again with ``kern``
    and must give the same bits."""
    ok = _same(a, b)
    err = float((a.double() - b.double()).abs().max()) if a.numel() else 0.0
    log(f"{tag} {name}: {'ok' if ok else 'MISMATCH'} (max |diff| {err!r})")
    if not ok:
        raise AssertionError(f"{name} disagrees with its plain version "
                             f"({tag})")
    if name in FOLDS and kern is not None:
        _twice(tag, name, kern, a)


def phase_gather_parity(torch, np) -> None:
    from graphtap_tpu_torch import GraphConfig, Graph
    from graphtap_tpu_torch.apps import bfs_config, sssp_config
    from graphtap_tpu_torch.ingest import rmat_edges
    from graphtap_tpu_torch.kernels import onehot_spmv as oh
    from graphtap_tpu_torch.kernels import shuffle_kernels as sk
    from graphtap_tpu_torch.kernels.gather_engine import (build_spmv2_meta,
                                                          spmv2_stages)
    from graphtap_tpu_torch.kernels.semiring import (INF_I32, min_plus,
                                                     min_select, plus_times)
    from graphtap_tpu_torch.kernels.spmv import expand_compact
    from graphtap_tpu_torch.tools.convert import meta_from_numpy
    rng = np.random.default_rng(SEED)
    n = 1 << PARITY_SCALE
    k10 = None
    for tag, dtype, sem, weighted, cfg in (
            ("f32 sum", np.float32, plus_times(), False,
             GraphConfig(num_vertices=n, transpose=True)),
            ("f64 sum weighted", np.float64, plus_times(), True,
             GraphConfig(num_vertices=n, transpose=True)),
            ("int32 min weighted (sssp_config)", np.int32, min_plus(), True,
             sssp_config(n)),
            ("int32 min (bfs_config)", np.int32, min_select(), False,
             bfs_config(n))):
        r, c, w = rmat_edges(PARITY_SCALE, EDGE_FACTOR, seed=SEED,
                             weighted=weighted)
        g = Graph.from_edges(r, c, w, cfg)
        tiles = g.tiled()
        t0 = time.perf_counter()
        meta = build_spmv2_meta(tiles, value_dtype=dtype)
        plan_s = time.perf_counter() - t0
        t = meta_from_numpy(meta.arrays, DEVICE)
        if dtype == np.int32:
            xv = rng.integers(0, 1000, size=g.part.tile_cols).astype(dtype)
            xv[rng.random(xv.size) < 0.3] = INF_I32
        else:
            xv = rng.random(g.part.tile_cols).astype(dtype)
        x = torch.from_numpy(xv).to(DEVICE)
        st = spmv2_stages(x, t, meta, sem, g.part.tile_rows)
        log(f"gather parity {tag}: v2 plans {plan_s:.2f} s, nsub "
            f"{meta.nsub}, stage rows {meta.out_rows}")
        for name, kern, plain, _, _ in _v2_calls(torch, t, meta, sem, st):
            _check_call(f"gather parity {tag}", name, kern(), plain())
        rargs = (st["p3"], t["lr"], t["ev_r"], t["chunk_block"],
                 meta.nblocks, sem.reduce_kind, sem.identity)
        folds = sk.reduce_tables(t, meta.nblocks, st["p3"].dtype)
        _check_call(f"gather parity {tag}", "grouped_reduce",
                    sk.grouped_reduce(*rargs, **folds),
                    sk.grouped_reduce_plain(*rargs),
                    lambda: sk.grouped_reduce(*rargs, **folds))
        if k10 is None:
            k10 = _k10_call(torch, np, t, meta, sem, st,
                            f"gather parity {tag}")
            _check_call(f"gather parity {tag}", k10[0], k10[1](), k10[2]())
        # the whole SpMV against the plain pipeline (the CPU wrappers)
        want = spmv2_stages(x.cpu(), meta_from_numpy(meta.arrays, "cpu"),
                            meta, sem, g.part.tile_rows)["y"]
        ok = _fold_ok(st["y"].cpu(), want, sem.reduce_kind,
                      FOLD_RTOL.get(np.dtype(dtype).name, 0))
        log(f"gather parity {tag}: spmv2_local vs plain pipeline "
            f"{'ok' if ok else 'MISMATCH'}")
        if not ok:
            raise AssertionError(f"spmv2_local disagrees with the plain "
                                 f"pipeline ({tag})")
        # K5 on the one-hot plan of the same graph, and the whole SpMV
        plan = oh.build_onehot_plan(tiles)
        th = meta_from_numpy(plan.arrays, DEVICE)
        call = _k5_call(torch, th, plan, tiles.NR, sem,
                        oh.onehot_contrib(x, th, sem))
        _check_call(f"onehot parity {tag}", call[0], call[1](), call[2](),
                    call[1])
        iv = torch.from_numpy(tiles.iv_dense[0]).to(DEVICE)
        got = expand_compact(oh.spmv_onehot(x, th, plan, sem, tiles.NR), iv,
                             sem)
        want = expand_compact(
            oh.spmv_onehot(x.cpu(), meta_from_numpy(plan.arrays, "cpu"),
                           plan, sem, tiles.NR), iv.cpu(), sem)
        ok = _fold_ok(got.cpu(), want, sem.reduce_kind,
                      FOLD_RTOL.get(np.dtype(dtype).name, 0))
        log(f"onehot parity {tag}: {plan.nchunks} chunks of {oh.CHUNK}, "
            f"{plan.nblocks} row blocks; one-hot SpMV vs plain "
            f"{'ok' if ok else 'MISMATCH'}")
        if not ok:
            raise AssertionError(f"the one-hot SpMV disagrees with the "
                                 f"plain one ({tag})")


def _pagerank_graph(scale, comp="TCSC"):
    """(r, c, graph) of the RMAT PageRank graph: transposed, in the
    compression named ``comp`` (TCSC; TCSC_CF, pr.cpp's config; CSC, the
    kernel lab's)."""
    from graphtap_tpu_torch import Compression, GraphConfig, Graph
    from graphtap_tpu_torch.ingest import rmat_edges
    r, c, _ = rmat_edges(scale, EDGE_FACTOR, seed=SEED)
    return r, c, Graph.from_edges(r, c, None, GraphConfig(
        num_vertices=1 << scale, transpose=True,
        compression=Compression[comp]))


def _suite_graph(app):
    """(r, c, w, graph) of BFS, CC or SSSP at RMAT-SUITE_SCALE, each
    through its own config (SSSP weighted)."""
    from graphtap_tpu_torch import Graph
    from graphtap_tpu_torch.apps import bfs_config, cc_config, sssp_config
    from graphtap_tpu_torch.ingest import rmat_edges
    r, c, w = rmat_edges(SUITE_SCALE, EDGE_FACTOR, seed=SEED,
                         weighted=app == "sssp")
    cfg = {"bfs": bfs_config, "cc": cc_config,
           "sssp": sssp_config}[app](1 << SUITE_SCALE)
    return r, c, w, Graph.from_edges(r, c, w, cfg)


def _plan_key(app):
    """(scale, value dtype, weighted) of ``app``'s plans."""
    import numpy as np
    if app in CSC_APPS:
        return CSC_APPS[app], np.float32, False
    return ((SCALE, np.float32, False) if app == "pr"
            else (SUITE_SCALE, np.int32, app == "sssp"))


def _prebuild(kind, ordering, phase, app, plan_dir):
    """Worker process: build ``app``'s ``kind`` plans in ``ordering`` into
    ``plan_dir``, of its graph's main tiles or (PageRank in the TCSC_CF
    config) of the TCSC_CF ``phase``, or of the CSC PageRank graph at its
    scale (``CSC_APPS``); returns the seconds it took (tiles included)."""
    from graphtap_tpu_torch import Ordering
    from graphtap_tpu_torch.tools import artifact_cache as ac
    g = (_pagerank_graph(SCALE, "TCSC" if phase == "main" else "TCSC_CF")[2]
         if app == "pr" else _pagerank_graph(CSC_APPS[app], "CSC")[2]
         if app in CSC_APPS else _suite_graph(app)[3])
    scale, dtype, _ = _plan_key(app)
    t0 = time.perf_counter()
    build = {"spmv2": ac.cached_spmv2_meta, "spmv3": ac.cached_spmv3_meta,
             "shuffle": ac.cached_shuffle_plans}[kind]
    o = Ordering[ordering]
    tiles = g.tiled(o) if phase == "main" else g.tiled_cf(o)[phase]
    build(tiles, scale, EDGE_FACTOR, SEED, g.config, o, dtype,
          cache_dir=plan_dir, phase=phase)
    return time.perf_counter() - t0


def _submit(jobs) -> None:
    """Hand PREBUILD entries to the worker pool."""
    _PREBUILT.update({job: _POOL[0].apply_async(_prebuild, (*job, PLAN_DIR))
                      for job in jobs})


def _prebuilt(kind, ordering, config, phase="main", app="pr"):
    """The plans _prebuild made (waiting for its worker), read back from
    PLAN_DIR."""
    from graphtap_tpu_torch import Ordering
    from graphtap_tpu_torch.tools import artifact_cache as ac
    secs = _PREBUILT[kind, ordering, phase, app].get(timeout=1200)
    scale, dtype, weighted = _plan_key(app)
    key = ac.meta_key(scale, EDGE_FACTOR, SEED, config, Ordering[ordering],
                      dtype, weighted, kind, phase)
    t0 = time.perf_counter()
    load = {"spmv2": ac.load_spmv2_meta, "spmv3": ac.load_spmv3_meta,
            "shuffle": ac.load_shuffle_plans}[kind]
    meta = load(os.path.join(PLAN_DIR, key + ".npz"))
    log(f"plans: RMAT-{scale} {app} {kind} ({ordering}, {phase}) built in a "
        f"worker process in {secs:.1f} s (tiles included), read back in "
        f"{time.perf_counter() - t0:.1f} s")
    return meta


def _ms(fn, torch, reps: int) -> float:
    """Mean device time of one call (CUDA events over ``reps`` calls)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _golden():
    """tests/golden.py, the NumPy golden models (loaded by path)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "golden", os.path.join(ROOT, "tests", "golden.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_main(torch, np):
    from graphtap_tpu_torch.apps import run_pagerank
    from graphtap_tpu_torch.kernels import panel_kernels as pk
    from graphtap_tpu_torch.kernels import shuffle_kernels as sk
    t0 = time.perf_counter()
    r, c, g = _pagerank_graph(SCALE)
    n = 1 << SCALE
    log(f"main: edges RMAT-{SCALE} E={r.size} in "
        f"{time.perf_counter() - t0:.1f} s")
    pk.reset_launches()
    sk.reset_launches()
    t0 = time.perf_counter()
    ex = run_pagerank(g, ITERS, torch.float32, kernel="panel",
                      device=DEVICE, degree_kernel="shuffle")
    wall = time.perf_counter() - t0
    launches = {**pk.LAUNCHES, **sk.LAUNCHES}
    deg, tm = ex.degree_phase, ex.timings
    dm = deg.timings
    log(f"main: degree phase (shuffle) tiles {dm['tiles']:.1f} s, plans "
        f"{dm['plans']:.2f} s ({deg.device_bytes} bytes on the device: "
        f"{deg.device_bytes / 2**30:.3f} GiB), upload {dm['upload']:.2f} s, "
        f"SpMV {dm['execute'] * 1e3:.3f} ms")
    log(f"main: PageRank tiles {tm['tiles']:.1f} s, plans "
        f"{tm['plans']:.1f} s, upload {tm['upload']:.2f} s")
    log(f"main: run_pagerank wall {wall:.1f} s")
    log(f"main: launches {launches}")
    _need_launches("main", launches, {
        "route_xr_exp": ITERS, "route_passa": ITERS,
        "route_fold": 2 * ITERS, "hub_fold": ITERS,
        "expand_stream": 3, "group_stream": 1, "grouped_reduce": 1})
    golden = _golden()
    want = golden.degree(r, c, n + 1)
    got = deg.state_vector()["degree"]
    ok = (got.dtype == np.float32
          and np.array_equal(got.astype(np.int64), want)
          and np.array_equal(got, want.astype(np.float32)))
    log(f"main: degrees (shuffle) vs golden.degree "
        f"{'equal' if ok else 'DIFFER'}; sum {float(got.sum())!r}")
    if not ok:
        raise AssertionError("degree phase differs from golden.degree")
    checksum, reach = ex.checksum()
    gsum = float(golden.pagerank(r, c, n + 1, ITERS).sum())
    rel = abs(checksum - gsum) / abs(gsum)
    log(f"main: checksum {checksum!r} (reachable {reach}) vs f64 golden "
        f"{gsum!r}: rel err {rel:.3e}")
    if not rel < GOLDEN_RTOL:
        raise AssertionError(f"checksum rel err {rel} >= {GOLDEN_RTOL}")
    nnz = ex.tiles.nnz_total
    first = tm["execute"]
    log(f"main: {ITERS} iterations {first:.4f} s first "
        f"({nnz * ITERS / first / 1e9:.4f} GTEPS), nnz {nnz}")
    ref = {"degree": want, "checksum": gsum, "pr_checksum": checksum,
           "gteps": _warm_gteps("main", ex), "edges": (r, c)}
    return g, ex, launches, ref


def _warm_gteps(tag, ex) -> float:
    """The median GTEPS (nnz x ITERS / seconds) of WARM_RUNS warm
    ITERS-iteration runs of ``ex``, each run listed."""
    nnz = ex.tiles.nnz_total
    secs = []
    for _ in range(WARM_RUNS):
        ex.execute(ITERS)
        secs.append(ex.timings["execute"])
    rates = sorted(nnz * ITERS / s / 1e9 for s in secs)
    runs = ", ".join(f"{s:.4f} s ({nnz * ITERS / s / 1e9:.4f})" for s in secs)
    log(f"{tag}: {WARM_RUNS} warm runs of {ITERS} iterations: {runs}; "
        f"median {rates[WARM_RUNS // 2]:.4f} GTEPS, nnz {nnz}")
    return rates[WARM_RUNS // 2]


def _log_passa(tag, npanels, nwin, src, out_rows=64, two_layer=True):
    """One K2 call's shape and the form its kernel takes on the card."""
    from graphtap_tpu_torch.kernels import panel_kernels as pk
    log(f"{tag} route_passa: npanels {npanels}, nwin {nwin}, "
        f"{'two' if two_layer else 'single'}-layer {out_rows} rows, "
        f"{src.dtype}: form "
        f"{pk.passa_form(nwin, out_rows, two_layer, src.element_size())}")


def _log_ring(tag, meta, dtype) -> None:
    """The plan rings of K1 and K3 (fixr, fix2) on ``meta`` for values of
    torch ``dtype``: npanels, nwin, ring depth, shared memory and the
    blocks an SM holds at once (the card's occupancy query); and the
    distinct source windows of a panel, the bytes its gathers touch."""
    import numpy as np
    import torch
    from graphtap_tpu_torch.kernels import panel_kernels as pk
    es = torch.tensor([], dtype=dtype).element_size()
    for name, npan, nwin, bases in (
            ("route_xr_exp", meta.exp_panels + 1, meta.xr_nwin, "xr_bases"),
            ("route_fold fixr", meta.fix_panels, meta.fixr_nwin,
             "fixr_bases"),
            ("route_fold fix2", meta.f2_panels, meta.f2_nwin, "f2_bases")):
        kern = name.split()[0]
        depth, smem = ((pk.XE_STAGES, pk.xr_exp_smem(nwin, es))
                       if kern == "route_xr_exp" else
                       (pk.fold_stages(nwin), pk.fold_smem(nwin)))
        b = np.sort(meta.arrays[bases][0][:npan * nwin].reshape(npan, nwin),
                    axis=1)
        distinct = float((np.diff(b, axis=1) != 0).sum(axis=1).mean() + 1)
        log(f"{tag} {name}: npanels {npan}, nwin {nwin}, {dtype}: ring "
            f"depth {depth}, {smem} bytes of shared memory, "
            f"{pk.ring_blocks_per_sm(kern, dtype, nwin)} blocks an SM; "
            f"{distinct:.2f} distinct windows a panel "
            f"({distinct * pk.STRIPE * pk.LANES * es / 1024:.1f} KB)")


def _converge32(tag, ex, deg, conv) -> None:
    """f32 PageRank to convergence (execute(0)) on ``ex``, re-initialized
    from the degree executor ``deg``: the absolute vote must settle under
    the executor's cap (ROADMAP F8). Records (iterations, checksum) in
    ``conv[tag]``, which phase_cf holds against the f64 run."""
    from graphtap_tpu_torch.engine import executor
    ex.initialize(other=deg)
    it = ex.execute(0)
    if it >= executor.MAX_CONVERGENCE_ITERS:
        raise AssertionError(f"f8 {tag}: the f32 vote did not settle in "
                             f"{it} iterations")
    checksum, reach = ex.checksum()
    conv[tag] = (it, checksum)
    log(f"f8 {tag}: f32 execute(0) settled in {it} iterations + flush in "
        f"{ex.timings['execute']:.4f} s; checksum {checksum!r} (reachable "
        f"{reach})")


def _profile(tag, ex, deg) -> None:
    """One execute_profiled of ITERS iterations on ``ex``, re-initialized
    from ``deg``: its Iteration lines counted, its PhaseTimer report, and
    the fenced superstep ms beside an unfenced execute's (CUDA events)."""
    ex.initialize(other=deg)
    ex.execute(ITERS)
    plain = [s["ms"] for s in ex.supersteps]
    ex.initialize(other=deg)
    lines = []
    timer = ex.execute_profiled(ITERS, printer=lines.append)
    if lines[:ITERS] != [f"Iteration: {i}" for i in range(1, ITERS + 1)] \
            or lines[ITERS:] != [timer.report()]:
        raise AssertionError(f"profile {tag}: not the Iteration lines and "
                             f"the report")
    for ln in timer.report().splitlines():
        log(f"profile {tag} ({ITERS} supersteps): {ln}")
    fenced = [s["ms"] for s in ex.supersteps]
    log(f"profile {tag}: superstep fenced host ms mean "
        f"{sum(fenced) / ITERS:.4f} (min {min(fenced):.4f}, max "
        f"{max(fenced):.4f}); unfenced execute, CUDA events, mean "
        f"{sum(plain) / ITERS:.4f} ms (min {min(plain):.4f})")


def phase_kernels(torch, ex, launches, best_copy):
    """The panel kernels at the shapes of a PageRank superstep; then K3's
    pass (b) share and the superstep's kernel device time beside its
    eager times."""
    from graphtap_tpu_torch.kernels.panel_engine import (spmv3_local,
                                                         spmv3_stages)
    from graphtap_tpu_torch.tools.convert import meta_from_numpy
    meta, sem = ex.meta, ex.program.semiring
    t = meta_from_numpy(meta.arrays, DEVICE)
    x = ex.program.messenger(ex.state).to(torch.float32)
    st = spmv3_stages(x, t, meta, sem, ex.part.tile_rows)
    _log_ring(f"kernels RMAT-{SCALE}", meta, x.dtype)
    rows = {}
    for (name, kern, plain, work), lib in zip(
            _kernel_calls(t, meta, sem, st),
            _panel_libraries(torch, t, meta, sem, st)):
        a, b = kern(), plain()
        err = float((a.double() - b.double()).abs().max())
        _check_call(f"kernels RMAT-{SCALE}", name, a, b, kern)
        if lib is not None and not (
                _fold_ok(lib(), a, sem.reduce_kind, FOLD_RTOL["float32"])
                if name == "route_fold" else _same(lib(), a)):
            raise AssertionError(f"{name}: the library call computes "
                                 f"another function")
        _time_row(torch, rows, name, kern, plain, err, launches[name],
                  _bound(*work, x.dtype), lib)
    _fold_pass_b(t, meta, rows["route_fold"], best_copy)
    kern_dev = [r["device_ms"] for r in rows.values()]
    spmv = _ms(lambda: spmv3_local(x, t, meta, sem, ex.part.tile_rows),
               torch, 10)
    ex.execute(ITERS)
    step = sum(s["ms"] for s in ex.supersteps) / ITERS
    if None not in kern_dev:
        dev = sum(kern_dev)
        log(f"panel superstep RMAT-{SCALE}: its five kernel launches (K1, "
            f"K2, K3 x2, K4) take {dev:.4f} ms of device time (CUDA-graph "
            f"replay); the eager SpMV {spmv:.4f} ms and the eager superstep "
            f"{step:.4f} ms (CUDA events, mean of {ITERS}): "
            f"{step - dev:.4f} ms ({(step - dev) / step:.1%}) of the "
            f"superstep is not kernel device time")
    return list(rows.values())


def _fold_pass_b(t, meta, row, best_copy) -> None:
    """K3's pass (b) (the fixed-order row folds, common.cuh) estimated
    from its bytes at the measured copy rate (no switch launches it
    alone): it reads the band partials and the run partials once, writes
    the runs and y once, and reads its three lists; beside K3's device
    time (fixr + fix2)."""
    es = 4                                       # f32 PageRank
    nbytes = 0
    for pre, npan, nrows in (("fixr", meta.fix_panels, meta.nrb),
                             ("fix2", meta.f2_panels, meta.f2_rows)):
        ngroups = t[pre + "_fgptr"].numel() - 1
        nbytes += (npan * 8 * 128 * es + 2 * ngroups * 128 * es
                   + nrows * 128 * es + 4 * (npan * 8 + ngroups + nrows + 2))
    ms = nbytes / (best_copy * 1e9) * 1e3
    dev = row["device_ms"]
    share = "not measured" if dev is None else f"{ms / dev:.1%}"
    log(f"kernels route_fold: pass (b) moves {nbytes} bytes (fixr + fix2): "
        f"{ms:.4f} ms at the measured copy rate ({best_copy:.1f} GB/s), an "
        f"estimate, {share} of K3's device time {_fmt(dev)}")


def _scaled_ok(a, b, kind, rtol) -> bool:
    """Float sums held as phase 5 holds K3 at RMAT-20 (max |diff| <= rtol x
    max |b|: hub rows sum ~1e5 terms in no fixed order); the rest bit for
    bit."""
    if kind != "sum" or not b.dtype.is_floating_point:
        return _same(a, b)
    return bool((a.double() - b.double()).abs().max()
                <= rtol * b.double().abs().max())


def _staged_checks(torch, tag, st, fused, folded, t, sem) -> None:
    """K11's s0 equals K1's bit for bit; the staged y_mid and y equal the
    fused ones (int32 bit for bit, f32 within K3's tolerance); K12's rows
    scattered by chunk_dst with ⊕ equal K13's y_mid."""
    kind, fill = sem.reduce_kind, sem.identity
    rtol = FOLD_RTOL["float32"]
    rows = t["chunk_dst"].long()[:, None].expand(-1, folded.shape[1])
    op = {"sum": "sum", "min": "amin", "max": "amax"}[kind]
    scattered = torch.full(st["y_mid"].shape, fill, dtype=folded.dtype,
                           device=folded.device).scatter_reduce_(
        0, rows, folded, op)
    pairs = {"s0 (K11) vs K1's": (st["s0"], fused["s0"]),
             "y_mid vs fused": (st["y_mid"], fused["y_mid"]),
             "y vs fused": (st["y"], fused["y"]),
             "K12 scattered vs K13": (scattered, st["y_mid"])}
    for what, (x, y) in pairs.items():
        ok = (_same(x, y) if what.startswith("s0")
              else _scaled_ok(x, y, kind, rtol))
        diff = float((x.double() - y.double()).abs().max())
        log(f"{tag}: {what} {'ok' if ok else 'MISMATCH'} (max |diff| "
            f"{diff!r})")
        if not ok:
            raise AssertionError(f"{tag}: {what} disagrees")


def _staged_calls(torch, t, meta, sem, st):
    """(name, kernel call, plain call, (bytes, ops), library call) of K2's
    single-layer form, K11, K12 and K13 on the staged stage tensors
    ``st``. Bytes: each input read once (the whole source table, the
    panels' plan blocks, bases, chunk_dst), each output written once; ops:
    the ⊗ (none unweighted) and ⊕ the call must do. Library calls:
    torch.take over the index precomputed from the plan (K2, K11;
    unweighted), view(-1, 8, 128) reduced over dim 1 (K12), one
    scatter_reduce over repeat_interleave(chunk_dst, 8) (K13; K13's
    bytes count its row -> chunks lists, which it reads for chunk_dst)."""
    from graphtap_tpu_torch.kernels import panel_kernels as pk
    from graphtap_tpu_torch.kernels.panel_engine import CHUNK_LISTS
    from graphtap_tpu_torch.tools import timing
    fill, kind = sem.identity, sem.reduce_kind
    es = st["x2d"].element_size()
    nxe = meta.exp_panels + 1
    xr_rows = pk.plan_rows(meta.xr_nwin * pk.STRIPE, pk.XROWS, False)
    xr = (st["x2d"], t["xr_bases"], t["xr_plan"], fill, nxe, meta.xr_nwin)
    one = dict(out_rows=pk.XROWS, two_layer=False)
    _log_passa("staged x->x_ext", nxe, meta.xr_nwin, st["x2d"], **one)
    _log_passa("staged corner turn", meta.pa_panels + 1, meta.pa_nwin,
               st["s0"])
    _log_passa("staged fixr", meta.fix_panels, meta.fixr_nwin, st["s1"])
    idx = pk.route_passa_plain(timing.slot_ids(st["x2d"]), *xr[1:3], -1,
                               *xr[4:], **one)
    calls = [("route_passa_single", lambda: pk.route_passa(*xr, **one),
              lambda: pk.route_passa_plain(*xr, **one),
              (_nbytes(st["x2d"]) + 4 * nxe * meta.xr_nwin
               + nxe * xr_rows * pk.LANES + _nbytes(st["x_ext"]), 0),
              timing.take_call(st["x2d"], idx, fill))]
    w = t.get("w_stream")
    mk = ("mul" if kind == "sum" else "add_sat") if meta.has_w else "none"
    ex = (st["x_ext"], t["exp_plan"], w, fill, nxe, mk)
    lib = None
    if w is None:
        idx = pk.route_expand_plain(timing.slot_ids(st["x_ext"]),
                                    t["exp_plan"], None, -1, nxe)
        lib = timing.take_call(st["x_ext"], idx, fill)
    calls.append(("route_expand", lambda: pk.route_expand(*ex),
                  lambda: pk.route_expand_plain(*ex),
                  (_nbytes(st["x_ext"]) + _nbytes(t["exp_plan"][
                      :nxe * pk.plan_rows(pk.XROWS)])
                   + (_nbytes(w[:nxe * pk.PROWS]) if w is not None else 0)
                   + _nbytes(st["s0"]),
                   st["s0"].numel() if w is not None else 0), lib))
    stack1, npan = st["stack1"], meta.fix_panels
    red = {"sum": lambda v: v.sum(1), "min": lambda v: v.amin(1),
           "max": lambda v: v.amax(1)}[kind]
    calls.append(("fold_stripes",
                  lambda: pk.fold_stripes(stack1, kind, npan),
                  lambda: pk.fold_stripes_plain(stack1, kind, npan),
                  (_nbytes(stack1) + _nbytes(stack1) // pk.STRIPE,
                   stack1.numel() * 7 // 8),
                  lambda: red(stack1.view(-1, pk.STRIPE, pk.LANES))))
    cs = (stack1, t["chunk_dst"], meta.nrb, kind, fill)
    lists = tuple(t[k] for k in CHUNK_LISTS)    # as the path keeps them
    dest = (t["chunk_dst"].long().repeat_interleave(pk.STRIPE)[:, None]
            * pk.LANES + torch.arange(pk.LANES, device=stack1.device)
            ).reshape(-1)
    y0 = torch.full((meta.nrb * pk.LANES,), fill, dtype=stack1.dtype,
                    device=stack1.device)
    op = {"sum": "sum", "min": "amin", "max": "amax"}[kind]
    calls.append(("colsum_chunks",
                  lambda: pk.colsum_chunks(*cs, lists=lists),
                  lambda: pk.colsum_chunks_plain(*cs),
                  (_nbytes(stack1) + sum(_nbytes(a) for a in lists)
                   + meta.nrb * pk.LANES * es, stack1.numel()),
                  lambda: torch.scatter_reduce(y0, 0, dest,
                                               stack1.reshape(-1), op
                                               ).view(meta.nrb, pk.LANES)))
    return calls


def _staged_row(torch, rows, call, launches, dtype) -> None:
    """Check one staged call against its plain version (K12 elementwise
    within rtol 1e-6, the rest bit for bit; K13, a fixed-order fold
    (FOLDS), twice with the same bits) and its library call (the take
    calls against the kernel bit for bit, K12 against the plain version
    at its tolerance, K13's atomic scatter_reduce as K3's fold is held),
    then time it."""
    name, kern, plain, work, lib = call
    a, b = kern(), plain()
    err = float((a.double() - b.double()).abs().max())
    if name == "fold_stripes" and b.dtype.is_floating_point:
        ok = bool(torch.all((a.double() - b.double()).abs()
                            <= 1e-6 * b.double().abs()))
        log(f"kernels staged {name}: {'ok' if ok else 'MISMATCH'} (max "
            f"|diff| {err!r})")
        if not ok:
            raise AssertionError(f"{name} disagrees with its plain version")
    else:
        _check_call("kernels staged", name, a, b, kern)
    if lib is not None:
        got = lib()
        ok = (bool(torch.all((got.double() - b.double()).abs()
                             <= 1e-6 * b.double().abs()))
              if name == "fold_stripes" and b.dtype.is_floating_point else
              _scaled_ok(got, b, "sum", FOLD_RTOL["float32"])
              if name == "colsum_chunks" else _same(got, a))
        if not ok:
            raise AssertionError(f"{name}: the library call computes "
                                 f"another function")
    _time_row(torch, rows, name, kern, plain, err, launches,
              _bound(*work, dtype), lib)


def phase_staged(torch, ex):
    """The staged SpMV on the main path's RMAT-20 panel meta and PageRank
    x, K12 on its stack1; then the rows of K2 single-layer, K11-K13."""
    from graphtap_tpu_torch.kernels import panel_kernels as pk
    from graphtap_tpu_torch.kernels.panel_engine import (
        spmv3_staged_stages, spmv3_stages, staged_tables)
    from graphtap_tpu_torch.tools.convert import meta_from_numpy
    meta, sem = ex.meta, ex.program.semiring
    t0 = time.perf_counter()
    t = staged_tables(meta_from_numpy(meta.arrays, DEVICE), meta)
    torch.cuda.synchronize()
    log(f"staged: tables (xe_plan halves, chunk_dst, K13's lists) "
        f"uploaded in {time.perf_counter() - t0:.2f} s")
    per_row = t["chunk_ptr"][1:] - t["chunk_ptr"][:-1]
    log(f"staged colsum_chunks lists: {meta.nrb} rows, "
        f"{int(per_row.sum())} chunks, {int((per_row > 1).sum())} rows of "
        f"more than one, {t['chunk_long'].numel()} of more than "
        f"{pk.COLSUM_LONG} ({t['chunk_lpos'].numel()} chunks), the longest "
        f"{int(per_row.max())}")
    x = ex.program.messenger(ex.state).to(torch.float32)
    n = ex.part.tile_rows
    fused = spmv3_stages(x, t, meta, sem, n)
    _reset_all_launches()
    st = spmv3_staged_stages(x, t, meta, sem, n)
    folded = pk.fold_stripes(st["stack1"], sem.reduce_kind, meta.fix_panels)
    launches = _all_launches()
    log(f"staged: launches {({k: v for k, v in launches.items() if v})}")
    _need_launches("staged", launches, STAGED_LAUNCHES)
    _staged_checks(torch, f"staged RMAT-{SCALE} f32", st, fused, folded, t,
                   sem)
    log(f"staged route_expand: npanels {meta.exp_panels + 1}, {x.dtype}: "
        f"ring depth {pk.EX_STAGES}, stages of "
        f"{pk.plan_rows(pk.XROWS) * pk.LANES} plan + "
        f"{pk.XROWS * pk.LANES * x.element_size()} x_ext bytes, "
        f"{pk.expand_smem(x.element_size())} bytes of shared memory, "
        f"{pk.ring_blocks_per_sm('route_expand', x.dtype)} blocks an SM")
    rows = {}
    for call in _staged_calls(torch, t, meta, sem, st):
        _staged_row(torch, rows, call, launches[call[0]], x.dtype)
    return list(rows.values())


def _pass_takes(torch, t, meta, contrib, fill):
    """K7's earlier yardstick, kept for the record: one torch.take per
    radix pass over that pass's int64 inverse index (the plain version's
    pass by pass), as one call of ``npasses`` takes."""
    from graphtap_tpu_torch.kernels import shuffle_kernels as sk
    from graphtap_tpu_torch.kernels.shuffle_plan import LANES
    nsup, _, rps, smax = t["frag_dst"].shape
    bufs, takes = [contrib], []
    for p in range(meta.npasses):
        d = t["frag_dst"][:, p]
        idx = t["frag_idx"][:, p].reshape(nsup, rps, smax, LANES)
        hit = (idx >= 0) & (d >= 0)[..., None]
        bufs.append(sk.group_pass_plain(bufs[-1], t["frag_dst"],
                                        t["frag_idx"], p, rps, fill))
        srow = torch.arange(nsup * rps, device=d.device).view(nsup, rps)
        src = (srow[:, :, None, None] * LANES + idx.long())[hit]
        drow = (torch.arange(nsup, device=d.device)[:, None, None] * rps
                + d.long())
        dst = (drow[..., None] * LANES
               + torch.arange(LANES, device=d.device))[hit]
        inv = torch.full((contrib.numel(),), contrib.numel(),
                         dtype=torch.long, device=d.device)
        inv[dst] = src
        ext = torch.cat([bufs[-2].reshape(-1), bufs[-2].new_full((1,),
                                                                 fill)])
        takes.append((ext, inv))
        del idx, hit, src, dst
    return lambda: [torch.take(e, i) for e, i in takes], bufs[-1]


def phase_shuffle_kernels(torch, np, g, launches):
    """K6-K8 at the shapes of the main path's degree SpMV (its plans built
    again in a worker process: the degree phase freed its own before
    PageRank's upload); K7 also in f64 and int32 on random streams of the
    same plan, and against the per-pass takes; then the degree
    SpMV's warm time, the median of five calls (CUDA events)."""
    from graphtap_tpu_torch.kernels import shuffle_kernels as sk
    from graphtap_tpu_torch.kernels.semiring import INF_I32, plus_times
    from graphtap_tpu_torch.kernels.shuffle_engine import spmv_stages
    from graphtap_tpu_torch.tools import ring_times, timing
    from graphtap_tpu_torch.tools.convert import meta_from_numpy
    meta = _prebuilt("shuffle", "COL", g.config)
    log(f"kernels: degree shuffle plans: {meta.nsupers} supers of "
        f"{meta.rows_per_super} rows, {meta.npasses} passes, SMAX "
        f"{meta.SMAX}, {meta.nblocks} y blocks")
    t = meta_from_numpy(meta.arrays, DEVICE)
    for tag, grp, ev in (("stream", t["grp"], t["ev_x"]),
                         ("mexp A", t["mexp_grp_a"], t["mexp_ev_a"]),
                         ("mexp B", t["mexp_grp_b"], t["mexp_ev_b"])):
        f = sk.expand_figures(grp, ev)
        log(f"kernels: expand_stream {tag} plan: {f['steps']} steps, "
            f"{f['slots']} slots, {f['valid']} valid "
            f"({f['valid'] / max(f['slots'], 1):.4f}), {f['windows']} "
            f"windows, {f['runs']} runs of one window (mean "
            f"{f['mean_run']:.2f}, median {f['median_run']:g} steps), "
            f"all-invalid 4-slot groups {f['empty4']:.4f}")
    _log_chunks("grouped_reduce", t["lr"], t["ev_r"] != 0, 8 * 128,
                t["chunk_block"], meta.nblocks, True)
    sem = plus_times()
    x = torch.ones(g.part.tile_cols, dtype=torch.float32, device=DEVICE)
    st = spmv_stages(x, t, meta, sem, g.part.tile_rows)
    rows = {}
    for name, kern, plain, work, lib in _shuffle_calls(torch, t, meta, sem,
                                                        st):
        a, b = kern(), plain()
        err = float((a.double() - b.double()).abs().max())
        _check_call(f"kernels RMAT-{SCALE} degree", name, a, b, kern)
        if not _same(lib().view(-1)[:a.numel()].view(a.shape), a):
            raise AssertionError(f"{name}: the library call computes "
                                 f"another function")
        _time_row(torch, rows, name, kern, plain, err, launches[name],
                  _bound(*work, x.dtype), lib)
    gargs = (t["frag_dst"], t["frag_idx"], meta.rows_per_super,
             meta.npasses)
    gsrc = t["group_src"]
    log(f"kernels: group_stream index {gsrc.numel()} slots "
        f"({int((gsrc >= 0).sum())} live), {_nbytes(gsrc)} bytes kept per "
        f"upload")
    takes, want = _pass_takes(torch, t, meta, st["contrib"], sem.identity)
    if not _same(takes()[-1].view(want.shape), st["grouped"]):
        raise AssertionError("group_stream: the per-pass takes compute "
                             "another function")
    log(f"kernels: group_stream, the earlier yardstick: {meta.npasses} per-pass "
        f"torch.take: {_ms(takes, torch, 10):.4f} ms (device "
        f"{_fmt(timing.device_ms(takes, 10, log))})")
    del takes, want
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    shape = st["contrib"].shape
    for dt, fill in ((torch.float64, 0.0), (torch.int32, INF_I32)):
        c = (torch.rand(shape, dtype=dt, device=DEVICE, generator=gen)
             if dt.is_floating_point else
             torch.randint(0, 1 << 30, shape, dtype=dt, device=DEVICE,
                           generator=gen))
        _check_call(f"kernels RMAT-{SCALE} degree {dt}", "group_stream",
                    sk.group_stream(c, *gargs, fill, src=gsrc),
                    sk.group_stream_plain(c, *gargs, fill))
    del c
    med, times = ring_times.degree_spmv(t, meta)
    log(f"kernels: RMAT-{SCALE} degree SpMV on shuffle, warm: median "
        f"{med:.4f} ms of 5 calls (CUDA events; "
        f"{', '.join(f'{v:.4f}' for v in times[1:])}; first "
        f"{times[0]:.4f})")
    del t, st
    return list(rows.values())


def _pagerank_checks(np, tag, ex, ref, launches, need) -> float:
    """The checksum of a 20-iteration RMAT-20 PageRank against the f64
    golden, the launches ``need`` of its kernel path, and its warm GTEPS
    (the same 20 supersteps once more)."""
    log(f"{tag}: launches {launches}")
    _need_launches(tag, launches, need)
    checksum, reach = ex.checksum()
    rel = abs(checksum - ref["checksum"]) / abs(ref["checksum"])
    log(f"{tag}: checksum {checksum!r} (reachable {reach}) vs f64 golden "
        f"{ref['checksum']!r}: rel err {rel:.3e}")
    if not rel < GOLDEN_RTOL:
        raise AssertionError(f"{tag}: checksum rel err {rel} >= "
                             f"{GOLDEN_RTOL}")
    log(f"{tag}: {ITERS} iterations {ex.timings['execute']:.4f} s first")
    gteps = _warm_gteps(tag, ex)
    log(f"{tag}: {gteps:.4f} GTEPS warm (median) vs panel's "
        f"{ref['gteps']:.4f}")
    return gteps


def phase_new_paths(torch, np, g, deg_ex, ref, conv32):
    """RMAT-20 PageRank on shuffle2 (degrees handed over from the main
    phase's shuffle degree executor) and on onehot (run_pagerank, degree
    on onehot); the kernel rows of K9, K10 and K5 at their shapes; f32
    convergence on both and on scan, onehot profiled."""
    from graphtap_tpu_torch import EngineConfig, Ordering
    from graphtap_tpu_torch.apps import PageRankProgram, run_pagerank
    from graphtap_tpu_torch.engine.executor import Executor
    from graphtap_tpu_torch.kernels import onehot_spmv as oh
    from graphtap_tpu_torch.kernels.gather_engine import spmv2_stages
    rows = {}
    plans = _prebuilt("spmv2", "ROW", g.config)
    _reset_all_launches()
    t0 = time.perf_counter()
    ex = Executor(g, PageRankProgram(torch.float32),
                  EngineConfig(stationary=True, ordering=Ordering.ROW),
                  kernel="shuffle2", plans=plans, device=DEVICE)
    ex.initialize(other=deg_ex)
    ex.execute(ITERS)
    wall = time.perf_counter() - t0
    launches = {k: v for k, v in _all_launches().items() if v}
    tm, meta = ex.timings, ex.meta
    log(f"shuffle2: PageRank tiles {tm['tiles']:.1f} s, v2 plans "
        f"validated in {tm['plans']:.1f} s ({ex.device_bytes} bytes on the "
        f"device: "
        f"{ex.device_bytes / 2**30:.3f} GiB; nsub {meta.nsub}, stage rows "
        f"{meta.out_rows}), upload {tm['upload']:.2f} s; wall {wall:.1f} s")
    _pagerank_checks(np, "shuffle2", ex, ref, launches, {
        k: v * ITERS for k, v in PATH_LAUNCHES["shuffle2"].items()})
    sem = ex.program.semiring
    x = ex.program.messenger(ex.state).to(torch.float32)
    st = spmv2_stages(x, ex._dev, meta, sem, ex.part.tile_rows)
    for call in _v2_calls(torch, ex._dev, meta, sem, st) + [
            _k10_call(torch, np, ex._dev, meta, sem, st, "kernels")]:
        _kernel_row(torch, rows, call, launches.get(call[0], 0), x.dtype)
    _converge32("shuffle2", ex, deg_ex, conv32)
    ex.free()
    del ex, st
    _reset_all_launches()
    t0 = time.perf_counter()
    ex = run_pagerank(g, ITERS, torch.float32, kernel="onehot",
                      device=DEVICE, degree_kernel="onehot")
    wall = time.perf_counter() - t0
    launches = {k: v for k, v in _all_launches().items() if v}
    deg, tm = ex.degree_phase, ex.timings
    log(f"onehot: degree plan {deg.timings['plans']:.2f} s, SpMV "
        f"{deg.timings['execute'] * 1e3:.3f} ms; PageRank tiles "
        f"{tm['tiles']:.1f} s, plan {tm['plans']:.2f} s "
        f"({ex.meta.nchunks} chunks of {oh.CHUNK}, {ex.device_bytes} bytes "
        f"on the device), upload {tm['upload']:.2f} s; wall {wall:.1f} s")
    got = deg.state_vector()["degree"]
    ok = (got.dtype == np.float32
          and np.array_equal(got, ref["degree"].astype(np.float32)))
    log(f"onehot: degrees vs golden.degree {'equal' if ok else 'DIFFER'}")
    if not ok:
        raise AssertionError("the one-hot degree phase differs from "
                             "golden.degree")
    ref["gteps_onehot"] = _pagerank_checks(
        np, "onehot", ex, ref, launches,
        {"segment_reduce_gather": ITERS + 1})           # + the degree SpMV
    sem = ex.program.semiring
    x = ex.program.messenger(ex.state).to(torch.float32)
    _log_chunks("segment_reduce", ex._dev["oh_lrows"],
                ex._dev["oh_evalid"] != 0, oh.CHUNK,
                ex._dev["oh_chunk_block"], ex.meta.nblocks, False)
    call = _k5_call(torch, ex._dev, ex.meta, ex.tiles.NR, sem,
                    oh.onehot_contrib(x, ex._dev, sem))
    _kernel_row(torch, rows, call, launches.get("segment_reduce", 0),
                x.dtype)
    call = _k5_gather_call(torch, ex._dev, ex.meta, ex.tiles.NR, sem, x)
    _kernel_row(torch, rows, call, launches.get("segment_reduce_gather", 0),
                x.dtype)
    _converge32("onehot", ex, deg, conv32)
    _profile("onehot", ex, deg)
    ex.free()
    del ex
    # the control: the portable scan kernel (plain torch)
    ex = Executor(g, PageRankProgram(torch.float32),
                  EngineConfig(stationary=True, ordering=Ordering.ROW),
                  kernel="scan", device=DEVICE)
    _converge32("scan", ex, deg_ex, conv32)
    ex.free()
    return list(rows.values())


def _log_chunks(name, lanes, keep, chunk, chunk_block, nblocks,
                live_only) -> None:
    """The chunk figures K5's and K8's fold turns on
    (``ring_times.chunk_figures``), over the entries ``keep`` marks (K5:
    the real edges; K8: the valid slots)."""
    from graphtap_tpu_torch.tools.ring_times import chunk_figures
    f = chunk_figures(lanes, keep, chunk, chunk_block, nblocks, live_only)
    log(f"kernels: {name} chunk plan: {f['chunks']} chunks of {chunk} over "
        f"{f['blocks']} row blocks, {f['entries']} entries kept; longest "
        f"lane of a chunk median {f['median_longest']:g}, max "
        f"{f['max_longest']}, summed {f['sum_longest']}; single-lane "
        f"chunks {f['single_lane']}; largest row {f['max_row']} entries; "
        f"most chunks of a block {f['max_block_chunks']}; chunks with no "
        f"kept entry {f['empty_chunks']}, 4-entry groups with none "
        f"{f['empty4']:.4f}; longest fold list {f['max_list']}")


def _kernel_row(torch, rows, call, launches, dtype) -> None:
    """Check one call against its plain version and its library call,
    then time it into its kernels-line row."""
    name, kern, plain, work, lib = call[:5]
    a, b = kern(), plain()
    err = float((a.double() - b.double()).abs().max())
    _check_call("kernels", name, a, b, kern)
    if name == "segment_reduce":
        # float sums over hub rows of ~1e5 terms: the library call's f32
        # atomic sum rounds in another order on every call (0.014-0.027
        # from the plain fold at max |y| 1804 on RMAT-20), so the same call
        # in f64 is held against the f64 fold at max |diff| <= rtol *
        # max |y|; the kernel is set beside the f64 fold too
        scale = float(b.double().abs().max())
        want = call[5]()
        lib32 = float((lib().double() - b.double()).abs().max())
        lib64 = float((call[6]() - want).abs().max())
        log(f"kernels segment_reduce: against an f64 fold of the same "
            f"contributions max |diff| "
            f"{float((a.double() - want).abs().max())!r} (max |y| "
            f"{scale!r}); the library call {lib32!r} from the plain fold "
            f"in f32, {lib64!r} from the f64 fold in f64")
        ok_lib = lib64 <= FOLD_RTOL["float64"] * scale
    else:
        ok_lib = lib is None or _same(lib(), a)
    if not ok_lib:
        raise AssertionError(f"{name}: the library call computes another "
                             f"function")
    _time_row(torch, rows, name, kern, plain, err, launches,
              _bound(*work, dtype), lib)


def _time_row(torch, rows, name, kern, plain, err, launches, bound,
              library=None) -> None:
    """Add one call's kernel, plain and library times and its bound to the
    kernels-line row ``name``. Each event time is the lesser of two runs
    timed in turns (plain, library, kernel, kernel, library, plain; CUDA
    events over eager calls): the plan workers share the host's cores, and
    a run in which the host stalls and leaves the card idle shows as an
    outlier. Then the kernel's and the library call's device-only times
    (``timing.device_ms``: ten calls replayed as one CUDA graph), which the
    host's enqueue rate does not bound."""
    from graphtap_tpu_torch.tools import timing
    p1 = _ms(plain, torch, 3)
    l1 = _ms(library, torch, 10) if library else None
    k1 = _ms(kern, torch, 10)
    k2 = _ms(kern, torch, 10)
    l2 = _ms(library, torch, 10) if library else None
    p2 = _ms(plain, torch, 3)
    kd = timing.device_ms(kern, 10, log)
    ld = timing.device_ms(library, 10, log) if library else None
    kms, pms = min(k1, k2), min(p1, p2)
    source = SOURCES["shuffle" if name in SHUFFLE else
                     "gather" if name.startswith("windowed") else
                     "onehot" if name.startswith("segment_reduce") else
                     "probe" if name in PROBES else "panel"]
    row = rows.setdefault(name, {
        "name": name, "route": "cuda", "source": source,
        "replaces": REPLACES[name], "launches": launches,
        "max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
        "bound_by": bound[1], "library_ms": 0.0 if library else None,
        "device_ms": 0.0, "library_device_ms": 0.0 if library else None})
    row["max_abs_err"] = max(row["max_abs_err"], err)
    row["ms"] += kms
    row["plain_ms"] += pms
    row["bound_ms"] += bound[0]
    row["device_ms"] = None if kd is None or row["device_ms"] is None \
        else row["device_ms"] + kd
    if bound[1] == "operations":
        row["bound_by"] = "operations"
    lib_txt = ""
    if library:
        if row["library_ms"] is None:
            raise AssertionError(f"{name}: a library time for only some "
                                 f"of its calls")
        row["library_ms"] += min(l1, l2)
        row["library_device_ms"] = None if ld is None or row[
            "library_device_ms"] is None else row["library_device_ms"] + ld
        lib_txt = f", library {min(l1, l2):.4f} ms (device {_fmt(ld)})"
    log(f"kernel {name}: {kms:.4f} ms (runs {k1:.4f}, {k2:.4f}; device "
        f"{_fmt(kd)}) vs plain {pms:.4f} ms{lib_txt}, bound {bound[0]:.4f} "
        f"ms ({bound[1]}), max |diff| {err!r}")


def _fmt(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f} ms"


def _need_launches(path, launches, need) -> None:
    """Fail unless each kernel (or tuple of kernels, summed) of ``need``
    was launched at least that many times on the path."""
    for k, v in need.items():
        got = sum(launches[n] for n in ((k,) if isinstance(k, str) else k))
        if got < v:
            raise AssertionError(f"{path}: {k} launched {got} < {v} times")


def _log_supersteps(path, ex) -> None:
    for i, s in enumerate(ex.supersteps):
        branch = {True: "gated", False: "static"}.get(s["gated"], ex.kernel)
        log(f"{path}: superstep {i} {branch} {s['ms']:.4f} ms")


def phase_bfs(torch, np):
    """BFS on RMAT-SUITE_SCALE to convergence; returns the gated
    kernels' rows of the kernels line."""
    from graphtap_tpu_torch.apps import run_bfs
    from graphtap_tpu_torch.kernels import panel_kernels as pk
    from graphtap_tpu_torch.kernels.panel_engine import spmv3_stages
    t0 = time.perf_counter()
    r, c, _, g = _suite_graph("bfs")
    n = 1 << SUITE_SCALE
    log(f"bfs: edges RMAT-{SUITE_SCALE} E={r.size} (mirrored, no "
        f"self-loops: {g.nedges}) in {time.perf_counter() - t0:.1f} s")
    plans = _suite_plans("bfs", g)
    pk.reset_launches()
    t0 = time.perf_counter()
    ex = run_bfs(g, 0, kernel="panel", device=DEVICE, plans=plans["panel"])
    wall = time.perf_counter() - t0
    launches = dict(pk.LAUNCHES)
    tm = ex.timings
    log(f"bfs: tiles {tm['tiles']:.1f} s, plans {tm['plans']:.1f} s, "
        f"upload {tm['upload']:.2f} s; run_bfs wall {wall:.1f} s, "
        f"{ex.iteration} iterations in {tm['execute']:.4f} s (first)")
    log(f"bfs: launches {launches}")
    _log_supersteps("bfs", ex)
    _need_launches("bfs", launches, {**{k: 1 for k in GATED},
                                     "hub_fold": ex.iteration,
                                     "route_fold": ex.iteration})
    t0 = time.perf_counter()
    parent, hops = _golden().bfs(r.astype(np.int64), c.astype(np.int64),
                                 n + 1, 0)
    _SUITE_WANT["bfs"] = {"hops": hops, "parent": parent}
    sv = ex.state_vector()
    ok = (np.array_equal(sv["hops"], hops)
          and np.array_equal(sv["parent"], parent))
    log(f"bfs: hops and parents vs golden.bfs "
        f"{'equal' if ok else 'DIFFER'} (golden {time.perf_counter() - t0:.1f}"
        f" s); checksum {ex.checksum()}")
    if not ok:
        raise AssertionError("BFS hops/parents differ from golden.bfs")
    nnz = ex.tiles.nnz_total
    ex.initialize()                      # warm re-run, as bench_suite.py
    iters = ex.execute(0)
    warm = ex.timings["execute"]
    if not np.array_equal(ex.state_vector()["hops"], hops):
        raise AssertionError("BFS warm re-run differs from golden.bfs")
    log(f"bfs: warm re-run {iters} iterations in {warm:.4f} s, "
        f"{nnz * iters / warm / 1e9:.4f} GTEPS (nnz x iterations / s), "
        f"nnz {nnz}")
    _log_supersteps("bfs warm", ex)
    # the gated kernels at the shapes of BFS's first superstep
    ex.initialize()
    x = ex._messages(ex.state, ex.changed)
    st = spmv3_stages(x, ex._dev, ex.meta, ex.program.semiring,
                      ex.part.tile_rows, gate=True)
    _log_ring(f"kernels bfs RMAT-{SUITE_SCALE}", ex.meta, x.dtype)
    rows = {}
    sem = ex.program.semiring
    for (name, kern, plain, work), lib in zip(
            _gated_calls(ex._dev, ex.meta, sem, st, st["maps"]),
            _gated_libraries(torch, ex._dev, ex.meta, sem, st, st["maps"])):
        a, b = kern(), plain()
        _check_call(f"kernels bfs RMAT-{SUITE_SCALE}", name, a, b, kern)
        if lib is not None and not _same(lib(), a):
            raise AssertionError(f"{name}: the library call computes "
                                 f"another function")
        err = float((a.double() - b.double()).abs().max())
        _time_row(torch, rows, name, kern, plain, err, launches[name],
                  _bound(*work, x.dtype), lib)
    panel_iters, panel_warm = iters, warm
    ex.free()
    del ex, st
    for kernel in OTHER_PATHS:
        _run_on_kernel(torch, np, "bfs", kernel, lambda: run_bfs(
            g, 0, kernel=kernel, device=DEVICE, plans=plans.get(kernel)),
            {"hops": hops, "parent": parent}, panel_iters, panel_warm)
    return list(rows.values())


def _suite_plans(app, g):
    """The panel and shuffle2 plans of ``app``'s graph ``g``, built ahead
    in worker processes (PREBUILD): kernel -> plans."""
    return {"panel": _prebuilt("spmv3", "ROW", g.config, app=app),
            "shuffle2": _prebuilt("spmv2", "ROW", g.config, app=app)}


def _kernel_modules():
    """Every module that counts kernel launches."""
    from graphtap_tpu_torch.kernels import gather_kernels as gk
    from graphtap_tpu_torch.kernels import onehot_spmv as oh
    from graphtap_tpu_torch.kernels import panel_kernels as pk
    from graphtap_tpu_torch.kernels import shuffle_kernels as sk
    from graphtap_tpu_torch.tools import bw_probe, route_cost_probe
    return pk, sk, gk, oh, bw_probe, route_cost_probe


def _reset_all_launches() -> None:
    for mod in _kernel_modules():
        mod.reset_launches()


def _all_launches() -> dict:
    return {k: v for mod in _kernel_modules() for k, v in mod.LAUNCHES.items()}


def _run_on_kernel(torch, np, app, kernel, run, want, panel_iters,
                   panel_warm):
    """Run ``app`` to convergence on ``kernel`` ('shuffle', 'shuffle2' or
    'onehot'): its state equals the golden ``want`` bit for bit, in the
    panel run's iteration count, with the kernel's launches per superstep
    (PATH_LAUNCHES); then warm, re-initialized, beside the panel run's
    warm seconds."""
    _reset_all_launches()
    t0 = time.perf_counter()
    ex = run()
    wall = time.perf_counter() - t0
    launches = {k: v for k, v in _all_launches().items() if v}
    _need_launches(f"{app} {kernel}", _all_launches(), {
        k: v * ex.iteration for k, v in PATH_LAUNCHES[kernel].items()})
    sv = ex.state_vector()
    ok = all(np.array_equal(sv[k], v) for k, v in want.items())
    tm = ex.timings
    log(f"{app} {kernel}: tiles {tm['tiles']:.1f} s, plans "
        f"{tm['plans']:.2f} s ({ex.device_bytes} bytes on the device), "
        f"upload {tm['upload']:.2f} s; {ex.iteration} iterations in "
        f"{tm['execute']:.4f} s (first), wall {wall:.1f} s; launches "
        f"{launches}; state vs golden {'equal' if ok else 'DIFFER'}")
    if not ok:
        raise AssertionError(f"{app} on {kernel} differs from golden")
    if ex.iteration != panel_iters:
        raise AssertionError(f"{app}: {ex.iteration} iterations on "
                             f"{kernel}, {panel_iters} on panel")
    _log_supersteps(f"{app} {kernel}", ex)
    ex.initialize()
    iters = ex.execute(0)
    warm = ex.timings["execute"]
    if not all(np.array_equal(ex.state_vector()[k], v)
               for k, v in want.items()):
        raise AssertionError(f"{app} {kernel} warm re-run differs")
    _log_supersteps(f"{app} {kernel} warm", ex)
    nnz = ex.tiles.nnz_total
    log(f"{app}: seconds to convergence, warm: {kernel} {warm:.4f} s "
        f"({nnz * iters / warm / 1e9:.4f} GTEPS) vs panel "
        f"{panel_warm:.4f} s, {iters} iterations")
    ex.free()


def phase_cc_sssp(torch, np) -> None:
    from graphtap_tpu_torch.apps import run_cc, run_sssp
    from graphtap_tpu_torch.kernels import panel_kernels as pk
    golden = _golden()
    n = 1 << SUITE_SCALE
    for app in ("cc", "sssp"):
        t0 = time.perf_counter()
        weighted = app == "sssp"
        r, c, w, g = _suite_graph(app)
        edges_s = time.perf_counter() - t0
        plans = _suite_plans(app, g)
        pk.reset_launches()
        t0 = time.perf_counter()
        ex = (run_sssp(g, 0, kernel="panel", device=DEVICE,
                       plans=plans["panel"]) if weighted
              else run_cc(g, kernel="panel", device=DEVICE,
                          plans=plans["panel"]))
        wall = time.perf_counter() - t0
        launches = dict(pk.LAUNCHES)
        _need_launches(app, launches, {
            "hub_fold": ex.iteration, "route_fold": ex.iteration,
            ("route_xr_exp", "route_xr_exp_gated"): ex.iteration,
            ("route_passa", "route_passa_gated"): ex.iteration})
        tm = ex.timings
        log(f"{app}: RMAT-{SUITE_SCALE} edges {edges_s:.1f} s, tiles "
            f"{tm['tiles']:.1f} s, plans {tm['plans']:.1f} s, upload "
            f"{tm['upload']:.2f} s; {ex.iteration} iterations in "
            f"{tm['execute']:.4f} s (first), wall {wall:.1f} s")
        log(f"{app}: launches {launches}")
        _log_ring(app, ex.meta, torch.int32)
        _log_supersteps(app, ex)
        t0 = time.perf_counter()
        r64, c64 = r.astype(np.int64), c.astype(np.int64)
        if weighted:
            want = golden.sssp(r64, c64, w.astype(np.int64), n + 1, 0)
            got = ex.state_vector()["distance"]
        else:
            want = golden.cc(r64, c64, n + 1)
            got = ex.state_vector()["label"]
        ok = np.array_equal(got, want)
        _SUITE_WANT[app] = {"distance" if weighted else "label": want}
        log(f"{app}: state vs golden.{app} {'equal' if ok else 'DIFFER'} "
            f"(golden {time.perf_counter() - t0:.1f} s); checksum "
            f"{ex.checksum()}")
        if not ok:
            raise AssertionError(f"{app} differs from golden.{app}")
        if weighted:
            _staged_int32(torch, np, ex)
        nnz = ex.tiles.nnz_total
        ex.initialize()
        iters = ex.execute(0)
        warm = ex.timings["execute"]
        log(f"{app}: warm re-run {iters} iterations in {warm:.4f} s, "
            f"{nnz * iters / warm / 1e9:.4f} GTEPS, nnz {nnz}")
        ex.free()
        del ex
        key = "distance" if weighted else "label"
        for kernel in OTHER_PATHS:
            _run_on_kernel(torch, np, app, kernel, (
                lambda: run_sssp(g, 0, kernel=kernel, device=DEVICE,
                                 plans=plans.get(kernel)))
                if weighted else (lambda: run_cc(
                    g, kernel=kernel, device=DEVICE,
                    plans=plans.get(kernel))),
                {key: want}, iters, warm)


def _staged_int32(torch, np, ex) -> None:
    """The staged SpMV on an SSSP panel meta (int32 min, add_sat ⊗) and a
    random x (30% at INF) against the fused one, bit for bit; K12's rows
    scattered by chunk_dst against K13's y_mid."""
    from graphtap_tpu_torch.kernels import panel_kernels as pk
    from graphtap_tpu_torch.kernels.panel_engine import (
        spmv3_staged_stages, spmv3_stages, staged_tables)
    from graphtap_tpu_torch.kernels.semiring import INF_I32
    meta, sem = ex.meta, ex.program.semiring
    t = staged_tables(ex._dev, meta)
    rng = np.random.default_rng(SEED)
    xv = rng.integers(0, 1000, size=ex.part.tile_cols).astype(np.int32)
    xv[rng.random(xv.size) < 0.3] = INF_I32
    x = torch.from_numpy(xv).to(DEVICE)
    n = ex.part.tile_rows
    fused = spmv3_stages(x, t, meta, sem, n)
    st = spmv3_staged_stages(x, t, meta, sem, n)
    folded = pk.fold_stripes(st["stack1"], sem.reduce_kind, meta.fix_panels)
    _staged_checks(torch, f"staged RMAT-{SUITE_SCALE} sssp int32 min", st,
                   fused, folded, t, sem)


def _phase_ms(ex) -> str:
    """The superstep times of the last execute, by tile phase."""
    by = {}
    for rec in ex.supersteps:
        by.setdefault(rec["phase"], []).append(rec["ms"])
    return "; ".join(f"{ph} {len(v)} x {sum(v) / len(v):.4f} ms (min "
                     f"{min(v):.4f}, max {max(v):.4f})"
                     for ph, v in by.items())


def phase_cf(torch, np, g, ref, main_meta, conv32) -> None:
    """RMAT-20 PageRank in pr.cpp's config (TCSC_CF, f32): the degree
    phase on shuffle, 20 iterations on onehot and on panel; convergence
    runs on onehot, f32 and f64, the f64 TCSC_CF run against the TCSC
    one; every f32 convergence run (``conv32``) against the f64 run of
    its compression."""
    from graphtap_tpu_torch import (Compression, EngineConfig, Graph,
                                    GraphConfig, Ordering)
    from graphtap_tpu_torch.apps import DegreeProgram, PageRankProgram
    from graphtap_tpu_torch.engine.executor import Executor
    r, c = ref["edges"]
    gcf = Graph.from_edges(r, c, None, GraphConfig(
        num_vertices=1 << SCALE, transpose=True,
        compression=Compression.TCSC_CF))
    # the degree phase runs the main tiles, which TCSC_CF renumbers as
    # TCSC does (byte for byte: tests/test_torch_cf.py), so the worker's
    # COL shuffle plans of the TCSC graph are this graph's too
    t0 = time.perf_counter()
    deg = Executor(gcf, DegreeProgram(torch.float32),
                   EngineConfig(stationary=True, ordering=Ordering.COL),
                   kernel="shuffle", plans=_prebuilt("shuffle", "COL",
                                                     g.config),
                   device=DEVICE)
    deg.initialize()
    deg.execute(1)
    deg.free()
    got = deg.state_vector()["degree"]
    if not np.array_equal(got, ref["degree"].astype(np.float32)):
        raise AssertionError("cf: degrees differ from golden.degree")
    log(f"cf: degree phase (shuffle) equal to golden.degree; tiles "
        f"{deg.timings['tiles']:.1f} s, wall "
        f"{time.perf_counter() - t0:.1f} s")
    pr_cfg = EngineConfig(stationary=True, ordering=Ordering.ROW)

    def run(kernel, **kw):
        _reset_all_launches()
        t0 = time.perf_counter()
        ex = Executor(gcf, PageRankProgram(torch.float32), pr_cfg,
                      kernel=kernel, device=DEVICE, **kw)
        ex.initialize(other=deg)
        ex.execute(ITERS)
        wall = time.perf_counter() - t0
        tm = ex.timings
        log(f"cf {kernel}: main tiles {tm['tiles']:.1f} s, plans "
            f"{tm.get('plans', 0.0):.1f} s; CF tiles {tm['cf_tiles']:.1f} "
            f"s, phase plans {tm['cf_plans']:.1f} s, upload "
            f"{tm['cf_upload']:.2f} s ({ex.device_bytes} bytes on the "
            f"device, main and phases); wall {wall:.1f} s")
        log(f"cf {kernel}: phase nnz first {ex._phases['first'][0].nnz_total}"
            f", middle {ex._phases['middle'][0].nnz_total}, last "
            f"{ex._phases['last'][0].nnz_total} of {ex.tiles.nnz_total}")
        log(f"cf {kernel}: supersteps {_phase_ms(ex)}")
        _pagerank_checks(np, f"cf {kernel}", ex, ref,
                         {k: v for k, v in _all_launches().items() if v},
                         {k: v * ITERS
                          for k, v in PATH_LAUNCHES[kernel].items()})
        log(f"cf {kernel}: warm supersteps {_phase_ms(ex)}")
        return ex

    ex = run("onehot")
    # f32 ranks near 1800 have an ulp of 1.2e-4 > tol 1e-5: the vote
    # settles only because every float fold runs in a fixed order (F8)
    _converge32("cf onehot", ex, deg, conv32)
    log(f"cf onehot convergence f32: supersteps {_phase_ms(ex)}")
    ex.free()
    conv = {}
    for tag, graph in (("cf", gcf), ("tcsc", g)):
        e = Executor(graph, PageRankProgram(torch.float64), pr_cfg,
                     kernel="onehot", device=DEVICE)
        e.initialize(other=deg)
        conv[tag] = (e.execute(0), e)
        log(f"{tag} onehot convergence f64: {conv[tag][0]} iterations + "
            f"flush in {e.timings['execute']:.4f} s; supersteps "
            f"{_phase_ms(e)}")
    (it_cf, ecf), (it_t, etc) = conv["cf"], conv["tcsc"]
    diff = float(np.abs(ecf.state_vector()["rank"]
                        - etc.state_vector()["rank"]).max())
    log(f"cf onehot convergence vs TCSC (f64): {it_cf} vs {it_t} "
        f"iterations, max |rank diff| {diff!r} (limit 2e-05)")
    if not diff <= 2e-5:
        raise AssertionError(f"cf convergence differs from TCSC by {diff}")
    for tag, (it, checksum) in conv32.items():
        it64, e64 = conv["cf" if tag.startswith("cf") else "tcsc"]
        want = e64.checksum()[0]
        rel = abs(checksum - want) / abs(want)
        log(f"f8 {tag}: f32 {it} iterations vs f64 {it64}; checksum "
            f"{checksum!r} vs f64 {want!r}: rel err {rel:.3e}")
        if not rel < GOLDEN_RTOL:
            raise AssertionError(f"f8 {tag}: f32 converged checksum rel err "
                                 f"{rel} >= {GOLDEN_RTOL}")
    ecf.free()
    etc.free()
    del ex, ecf, etc, conv
    plans = {ph: _prebuilt("spmv3", "ROW", gcf.config, ph)
             for ph in CF_PHASES}
    for ph in CF_PHASES:
        _log_ring(f"cf panel {ph}", plans[ph], torch.float32)
    run("panel", plans=main_meta, phase_plans=plans).free()

def _csc_run(torch, np, tag, g, kernel, deg, ref, plans=None):
    """PageRank, ITERS iterations in f32 on ``kernel``, on the CSC graph
    ``g`` handed ``deg``'s degrees: its launches per superstep
    (PATH_LAUNCHES), its checksum against the f64 golden ``ref`` and its
    warm GTEPS (``_pagerank_checks``); returns (executor, GTEPS)."""
    from graphtap_tpu_torch import EngineConfig, Ordering
    from graphtap_tpu_torch.apps import PageRankProgram
    from graphtap_tpu_torch.engine.executor import Executor
    _reset_all_launches()
    t0 = time.perf_counter()
    ex = Executor(g, PageRankProgram(torch.float32),
                  EngineConfig(stationary=True, ordering=Ordering.ROW),
                  kernel=kernel, plans=plans, device=DEVICE)
    ex.initialize(other=deg)
    ex.execute(ITERS)
    wall = time.perf_counter() - t0
    tm = ex.timings
    log(f"{tag}: NR {ex.tiles.NR} (C*L {ex.part.tile_rows}, raw local "
        f"rows), tiles {tm['tiles']:.1f} s, plans {tm.get('plans', 0.0):.1f}"
        f" s ({ex.device_bytes} bytes on the device), upload "
        f"{tm['upload']:.2f} s; wall {wall:.1f} s")
    gteps = _pagerank_checks(
        np, tag, ex, ref, {k: v for k, v in _all_launches().items() if v},
        {k: v * ITERS for k, v in PATH_LAUNCHES[kernel].items()})
    return ex, gteps


def _csc_device_ms(torch, tag, calls):
    """Each (name, kernel call, plain call, ...) of ``calls`` against its
    plain version, bit for bit (a fold twice); returns the calls' summed
    device-only ms (``timing.device_ms``), None if any is not measured."""
    from graphtap_tpu_torch.tools import timing
    total = 0.0
    for name, kern, plain, *_ in calls:
        _check_call(tag, name, kern(), plain(), kern)
        ms = timing.device_ms(kern, 10, log)
        log(f"{tag} {name}: device {_fmt(ms)}")
        total = None if ms is None or total is None else total + ms
    return total


def phase_csc(torch, np, ref, kernels) -> None:
    """RMAT-SCALE PageRank in the kernel lab's CSC config (transposed,
    f32; raw local rows, so NR = C*L): the degree phase on onehot (the
    shuffle kernel takes no CSC), then ITERS iterations on onehot and on
    panel (its plan built by a worker), each held to the golden and to
    its launches, warm GTEPS beside TCSC's; K5's and the panel
    superstep's kernels' device ms on the CSC shapes beside TCSC's
    (``kernels``' rows). Then shuffle2 on CSC at RMAT-SUITE_SCALE."""
    from graphtap_tpu_torch import Compression, Graph, GraphConfig, Ordering
    from graphtap_tpu_torch.apps.degree import run_degree
    from graphtap_tpu_torch.kernels import onehot_spmv as oh
    from graphtap_tpu_torch.kernels.panel_engine import spmv3_stages
    rows = {r["name"]: r for r in kernels}
    g = Graph.from_edges(*ref["edges"], None, GraphConfig(
        num_vertices=1 << SCALE, transpose=True,
        compression=Compression.CSC))
    _reset_all_launches()
    deg = run_degree(g, torch.float32, Ordering.COL, "onehot", DEVICE)
    deg.free()
    _need_launches("csc degree", _all_launches(),
                   {"segment_reduce_gather": 1})
    if not np.array_equal(deg.state_vector()["degree"],
                          ref["degree"].astype(np.float32)):
        raise AssertionError("csc: onehot degrees differ from golden.degree")
    log(f"csc: degree phase (onehot, COL) equal to golden.degree; NR "
        f"{deg.tiles.NR}, {deg.timings['plans']:.1f} s plan")
    ex, gteps = _csc_run(torch, np, "csc onehot", g, "onehot", deg, ref)
    log(f"csc onehot: {gteps:.4f} GTEPS warm (median) vs TCSC onehot's "
        f"{ref['gteps_onehot']:.4f}")
    sem = ex.program.semiring
    x = ex.program.messenger(ex.state).to(torch.float32)
    log(f"csc onehot: {ex.meta.nchunks} chunks over {ex.meta.nblocks} row "
        f"blocks")
    k5 = _csc_device_ms(torch, "kernels csc", [_k5_call(
        torch, ex._dev, ex.meta, ex.tiles.NR, sem,
        oh.onehot_contrib(x, ex._dev, sem))])
    log(f"csc: K5 device {_fmt(k5)} on the CSC one-hot plan vs "
        f"{_fmt(rows['segment_reduce']['device_ms'])} on TCSC's")
    ex.free()
    ex, _ = _csc_run(torch, np, "csc panel", g, "panel", deg, ref,
                     _prebuilt("spmv3", "ROW", g.config, app="csc"))
    meta = ex.meta
    log(f"csc panel: exp {meta.exp_panels}, pa {meta.pa_panels}, fix "
        f"{meta.fix_panels}, f2 {meta.f2_panels} panels, dense rows "
        f"{meta.dense_rows}")
    _log_ring(f"kernels csc RMAT-{SCALE}", meta, torch.float32)
    x = ex.program.messenger(ex.state).to(torch.float32)
    st = spmv3_stages(x, ex._dev, meta, ex.program.semiring,
                      ex.part.tile_rows)
    dev = _csc_device_ms(torch, "kernels csc",
                         _kernel_calls(ex._dev, meta, ex.program.semiring,
                                       st))
    tcsc = [rows[k]["device_ms"] for k in ("route_xr_exp", "route_passa",
                                           "route_fold", "hub_fold")]
    log(f"csc: the panel superstep's five launches take {_fmt(dev)} of "
        f"device time on CSC vs "
        f"{_fmt(None if None in tcsc else sum(tcsc))} on TCSC")
    ex.free()
    del ex, st
    # shuffle2 at RMAT-SUITE_SCALE: its v2 plans of an RMAT-20 graph take
    # minutes of host time, more than this phase's share of the smoke
    r, c, g = _pagerank_graph(SUITE_SCALE, "CSC")
    n = 1 << SUITE_SCALE
    golden = _golden()
    ref18 = {"checksum": float(golden.pagerank(r, c, n + 1, ITERS).sum()),
             "gteps": ref["gteps"]}
    deg = run_degree(g, torch.float32, Ordering.COL, "onehot", DEVICE)
    deg.free()
    if not np.array_equal(deg.state_vector()["degree"],
                          golden.degree(r, c, n + 1).astype(np.float32)):
        raise AssertionError("csc RMAT-18: degrees differ from golden")
    log(f"csc shuffle2 at RMAT-{SUITE_SCALE}: the v2 plans of an "
        f"RMAT-{SCALE} graph take minutes of host time; GTEPS below are "
        f"set beside RMAT-{SCALE} TCSC panel's")
    ex, _ = _csc_run(torch, np, f"csc shuffle2 RMAT-{SUITE_SCALE}", g,
                     "shuffle2", deg, ref18,
                     _prebuilt("spmv2", "ROW", g.config, app="csc18"))
    ex.free()


def phase_lab(torch, np, ref) -> None:
    """The kernel lab (``tools/kernel_lab.py``) through ``tools/
    lab_table.py``: each (scale, variants) of LAB_SETS, ITERS iterations
    each, on one RMAT binary of each scale written once; the rows printed
    as the markdown table; at each scale the cross-variant gates
    (operations equal, checksums within 1e-5 relative) and every checksum
    within 1e-4 of the f64 golden; variant 6 must launch K5."""
    from graphtap_tpu_torch.tools import artifact_cache as ac
    from graphtap_tpu_torch.tools import lab_table
    golden = _golden()
    log(f"lab: variants 3-5 each plan their degree (COL) and PageRank (ROW) "
        f"phases, minutes of host time a plan at RMAT-{SCALE}, and their "
        f"kernels run at RMAT-{SCALE} in phases 4, 4b and 8; the plain "
        f"variants' host tiles run at RMAT-18 (the smoke's time limit)")
    for scale, variants in LAB_SETS:
        r, c, _ = ac.cached_rmat(scale, EDGE_FACTOR, SEED, LAB_DIR)
        path = os.path.join(LAB_DIR, f"rmat{scale}_ef{EDGE_FACTOR}_s{SEED}"
                                     f".bin")
        n = 1 << scale
        want = (ref["checksum"] if scale == SCALE else
                float(golden.pagerank(r, c, n + 1, ITERS).sum()))
        rows = []
        for which in variants:
            _reset_all_launches()
            rows += lab_table.run_rows(path, n, ITERS, [which], DEVICE,
                                       printer=log)
            launches = {k: v for k, v in _all_launches().items() if v}
            log(f"lab RMAT-{scale} {which}: launches {launches}")
            if which == 6:
                _need_launches("lab 6", launches,
                               {"segment_reduce_gather": 1 + 2 * ITERS})
        for ln in lab_table.render(scale, rows, f"{_SMI[0]}; ITERS "
                                   f"{ITERS}, f32").splitlines():
            log(f"lab RMAT-{scale} | {ln}")
        lab_table.gates(rows)
        for r_ in rows:
            rel = abs(r_["checksum"] - want) / abs(want)
            if not rel < GOLDEN_RTOL:
                raise AssertionError(f"lab {r_['which']}: checksum rel err "
                                     f"{rel} >= {GOLDEN_RTOL}")
        log(f"lab RMAT-{scale}: operations equal, checksums within "
            f"{lab_table.CHECKSUM_RTOL} of each other and within "
            f"{GOLDEN_RTOL} of the f64 golden {want!r}")


def _mesh_launch(spec, nranks, tag) -> str:
    """Run ``spec`` (tools/mesh_run.py) on ``nranks`` ranks; log every
    rank's lines; return its output directory. A rank's failure or the
    timeout raises (parallel/launch.py kills the other ranks)."""
    from graphtap_tpu_torch.parallel.launch import launch
    spec["out"] = os.path.join(MESH_DIR, tag)
    path = os.path.join(MESH_DIR, f"{tag}.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    t0 = time.perf_counter()
    results = launch([sys.executable, "-m",
                      "graphtap_tpu_torch.tools.mesh_run", path], nranks,
                     MESH_TIMEOUT, env=dict(os.environ, PYTHONPATH=ROOT),
                     cwd=ROOT)
    for res in results:
        for ln in res.stdout.splitlines():
            log(f"mesh {tag}: {ln}")
    log(f"mesh {tag}: {nranks} rank(s) done in "
        f"{time.perf_counter() - t0:.1f} s")
    return spec["out"]


def _mesh_result(np, out, name):
    """(state in vertex order, meta) that rank 0 of a mesh run wrote."""
    with np.load(os.path.join(out, f"{name}.npz")) as z:
        state = {k: z[k] for k in z.files}
    with open(os.path.join(out, f"{name}.json")) as f:
        return state, json.load(f)


def _median(xs):
    xs = sorted(x for x in xs if x is not None)
    return xs[len(xs) // 2] if xs else float("nan")


def phase_mesh(torch, np, ref) -> None:
    """(a), (b) and (c) of phase 10 (see the module docstring)."""
    from graphtap_tpu_torch.ingest import rmat_edges
    from graphtap_tpu_torch.ingest.io import write_binary
    shutil.rmtree(MESH_DIR, ignore_errors=True)
    os.makedirs(MESH_DIR)
    label = (f"one card time-shared by the ranks, exchanges staged through "
             f"host memory; {_SMI[0]}")
    # (a) RMAT-20 on 2x2: degree on shuffle, PageRank on panel and onehot
    pr20 = os.path.join(MESH_DIR, f"rmat{SCALE}.bin")
    write_binary(pr20, *ref["edges"])
    runs = [{"name": "degree", "graph": "pr", "app": "degree",
             "kernel": "shuffle", "dtype": "float32"}]
    runs += [{"name": f"pr_{k}", "graph": "pr", "app": "pagerank",
              "kernel": k, "dtype": "float32", "iters": ITERS,
              "degree_kernel": "shuffle"} for k in ("panel", "onehot")]
    runs.append(dict(runs[-1], name="pr_onehot_profiled", profiled=True))
    out = _mesh_launch({"shape": list(MESH_SHAPE), "backend": "gloo",
                        "device": DEVICE, "runs": runs, "graphs": {
                            "pr": {"path": pr20, "nv": 1 << SCALE,
                                   "config": "pr"}}},
                       MESH_SHAPE[0] * MESH_SHAPE[1], "a")
    state, meta = _mesh_result(np, out, "degree")
    got = state["degree"]
    if not (got.dtype == np.float32 and np.array_equal(
            got.astype(np.int64), ref["degree"])):
        raise AssertionError("mesh: the 2x2 degrees differ from "
                             "golden.degree")
    log(f"mesh a: 2x2 degrees (shuffle) equal to golden.degree; exchange "
        f"{meta['exchange']}")
    launches = [dict() for _ in meta["ranks"]]
    for name in ("degree", "pr_panel", "pr_onehot"):
        state, meta = _mesh_result(np, out, name)
        for b, rk in enumerate(meta["ranks"]):
            for k, v in rk["launches"].items():
                launches[b][k] = launches[b].get(k, 0) + v
            tm = rk["timings"]
            log(f"mesh a {name}: rank {b}: tiles {tm.get('tiles', 0):.2f} "
                f"s, plans {tm.get('plans', 0):.2f} s, upload "
                f"{tm.get('upload', 0):.2f} s, superstep median "
                f"{_median(s['ms'] for s in rk['supersteps']):.3f} ms over "
                f"{len(rk['supersteps'])} ({label})")
        if name == "degree":
            continue
        cs = meta["checksum"]
        rel_g = abs(cs - ref["checksum"]) / ref["checksum"]
        rel_1 = abs(cs - ref["pr_checksum"]) / ref["pr_checksum"]
        log(f"mesh a {name}: checksum {cs!r} (reachable "
            f"{meta['reachable']}): rel err {rel_g:.3e} vs the f64 golden, "
            f"{rel_1:.3e} vs phase 4's 1x1 {ref['pr_checksum']!r}")
        if not (rel_g < GOLDEN_RTOL and rel_1 < FOLD_RTOL["float32"]):
            raise AssertionError(f"mesh {name}: checksum {cs}")
    # the superstep's split: each exchange, combine and apply fenced
    want, _ = _mesh_result(np, out, "pr_onehot")
    state, meta = _mesh_result(np, out, "pr_onehot_profiled")
    if not all(np.array_equal(state[k], v) for k, v in want.items()):
        raise AssertionError("mesh: execute_profiled differs from execute")
    for b, rk in enumerate(meta["ranks"]):
        ph = rk["phases"]
        total = sum(ms for ms, _ in ph.values())
        log(f"mesh a pr_onehot_profiled: rank {b}: " + ", ".join(
            f"{k} {ms:.3f} ms / {n}" for k, (ms, n) in ph.items())
            + f"; exchange {100 * ph['exchange'][0] / total:.1f}% of the "
            f"fenced phases, bit for bit with pr_onehot ({label})")
    for b, got in enumerate(launches):
        log(f"mesh a: rank {b} launches {got}")
        _need_launches(f"mesh rank {b}", {k: got.get(k, 0)
                                          for k in MESH_KERNELS},
                       {k: 1 for k in MESH_KERNELS})
    _mark("mesh a")
    # (b) BFS, CC and SSSP at RMAT-18 with the sparse exchange
    files = {}
    for tag, weighted in (("", False), ("w", True)):
        files[tag] = os.path.join(MESH_DIR, f"rmat{SUITE_SCALE}{tag}.bin")
        write_binary(files[tag], *rmat_edges(SUITE_SCALE, EDGE_FACTOR,
                                             seed=SEED, weighted=weighted))
    graphs = {app: {"path": files["w" if app == "sssp" else ""],
                    "nv": 1 << SUITE_SCALE, "config": app}
              for app in SUITE_APPS}
    runs = [{"name": f"{app}_{k}_k{K}", "graph": app, "app": app,
             "kernel": k, "capacity": K} for app in SUITE_APPS
            for k in ("onehot", "shuffle2") for K in MESH_CAPS]
    out = _mesh_launch({"shape": list(MESH_SHAPE), "backend": "gloo",
                        "device": DEVICE, "graphs": graphs, "runs": runs},
                       MESH_SHAPE[0] * MESH_SHAPE[1], "b")
    for app in SUITE_APPS:
        for k in ("onehot", "shuffle2"):
            seen = set()
            for K in MESH_CAPS:
                state, meta = _mesh_result(np, out, f"{app}_{k}_k{K}")
                ok = all(np.array_equal(state[key], v)
                         for key, v in _SUITE_WANT[app].items())
                steps = [rk["supersteps"] for rk in meta["ranks"]]
                seen |= {st["sparse"] for rk in steps for st in rk}
                ms = _median(st["ms"] for rk in steps for st in rk)
                log(f"mesh b {app} {k} K={K}: {meta['iteration']} "
                    f"iterations, state vs golden "
                    f"{'equal' if ok else 'DIFFER'}; rank 0 branches (x, "
                    f"y) {[(st['sparse'], st['sparse_y']) for st in steps[0]]}"
                    f", launches {meta['ranks'][0]['launches']}; superstep "
                    f"median {ms:.3f} ms ({label})")
                if not ok:
                    raise AssertionError(f"mesh {app} {k} K={K} differs "
                                         f"from golden")
            if seen != {True, False}:
                raise AssertionError(f"mesh {app} {k}: sparse branches "
                                     f"seen {seen}")
    _mark("mesh b")
    # (c) one rank in an NCCL group against the group-free run
    out = _mesh_launch({"shape": [1, 1], "backend": "nccl",
                        "device": DEVICE, "graphs": {"pr": {
                            "path": files[""], "nv": 1 << SUITE_SCALE,
                            "config": "pr"}},
                        "runs": [{"name": "pr", "graph": "pr",
                                  "app": "pagerank", "kernel": "onehot",
                                  "dtype": "float32", "iters": ITERS,
                                  "degree_kernel": "onehot",
                                  "plain": True}]}, 1, "c")
    (sa, ma), (sb, mb) = (_mesh_result(np, out, n) for n in ("pr", "pr_1x1"))
    same = all(np.array_equal(sa[k], sb[k]) for k in sb)
    log(f"mesh c: PageRank on onehot through {ma['exchange']} (1x1 "
        f"group) vs group-free ({mb['exchange']}): "
        f"{'bit for bit' if same else 'DIFFER'}; checksum {ma['checksum']!r}")
    if ma["exchange"] != "nccl" or mb["exchange"] is not None or not same:
        raise AssertionError("mesh c: the NCCL 1x1 run differs from the "
                             "group-free run")
    shutil.rmtree(MESH_DIR, ignore_errors=True)


def _entry_step(torch) -> None:
    """(a) of phase 11: entry() on the card against the same step on the
    plain versions on the card."""
    from graphtap_tpu_torch import graft_entry
    step, args = graft_entry.entry(DEVICE)
    pstep, pargs = graft_entry.entry(DEVICE, plain=True)
    _reset_all_launches()
    out = step(*args)
    torch.cuda.synchronize()
    launches = {k: v for k, v in _all_launches().items() if v}
    want = pstep(*pargs)
    total = float(out.sum())
    rel = abs(total - ENTRY_SUM) / ENTRY_SUM
    log(f"entry: {tuple(out.shape)} sum {total!r} (rel err {rel:.3e} vs "
        f"{ENTRY_SUM}); launches {launches}; vs the plain step on the card "
        f"{'bit for bit' if _same(out, want) else 'DIFFER'}; one step "
        f"{_ms(lambda: step(*args), torch, 10):.4f} ms (CUDA events)")
    if launches != ENTRY_LAUNCHES:
        raise AssertionError(f"entry: launches {launches}, expected "
                             f"{ENTRY_LAUNCHES}")
    if not (_same(out, want) and rel <= 1e-5):
        raise AssertionError("entry: the step differs from its plain "
                             "version or from the reference sum")


def _dryrun(np) -> None:
    """(b) of phase 11: dryrun_multichip(4) on the one card against the
    port's own 1x1 run of each program."""
    from graphtap_tpu_torch import graft_entry
    t0 = time.perf_counter()
    got = graft_entry.dryrun_multichip(4, DEVICE, timeout=MESH_TIMEOUT)
    t1 = time.perf_counter()
    one = graft_entry.dryrun_multichip(1, DEVICE, timeout=MESH_TIMEOUT)
    log(f"dryrun: 4 ranks in {t1 - t0:.1f} s, 1 rank in "
        f"{time.perf_counter() - t1:.1f} s")
    for name, r in got.items():
        want = one[name]
        exact = name in ("bfs", "sssp")
        same = (all(np.array_equal(r["state"][k], v)
                    for k, v in want["state"].items()) if exact else
                abs(r["checksum"] - want["checksum"])
                <= 1e-6 * abs(want["checksum"]))
        log(f"dryrun {name}: 2x2 checksum {r['checksum']!r} (reachable "
            f"{r['reachable']}, {r['iteration']} iterations, exchange "
            f"{r['exchange']}) vs 1x1 {want['checksum']!r}: "
            f"{'equal' if same else 'DIFFER'}"
            f"{' bit for bit' if exact and same else ''}")
        if not same or r["exchange"] != "gloo-host" or \
                len(r["ranks"]) != 4:
            raise AssertionError(f"dryrun {name}: the 2x2 run differs "
                                 f"from the 1x1 run")
        for b, rk in enumerate(r["ranks"]):
            gated = sum(bool(st["gated"]) for st in rk["supersteps"])
            log(f"dryrun {name}: rank {b} launches {rk['launches']}; "
                f"{gated} of {len(rk['supersteps'])} supersteps gated")
            if r["ranks"][0]["supersteps"][0]["gated"] is None:
                continue                    # scan: no kernel to launch
            # K1-K3 static or gated (a rank whose frontier is sparse, or
            # empty, takes the gated launches), K4 on every superstep
            got = collections.defaultdict(int, rk["launches"])
            _need_launches(f"dryrun {name} rank {b}", got, {
                **{(k, k + "_gated"): 1 for k in MESH_KERNELS[:3]},
                "hub_fold": 1})
            if gated:
                _need_launches(f"dryrun {name} rank {b} (gated)", got,
                               {k: 1 for k in GATED})


def phase_entry(torch, np) -> None:
    """Phase 11 (see the module docstring): (a) entry(), (b) the
    dryrun, (c) the BFS gate A/B, (d) the sparse-exchange sweep."""
    from graphtap_tpu_torch.tools import bfs_profile, sparse_exchange_bench
    _entry_step(torch)
    _mark("entry a")
    _dryrun(np)
    _mark("entry b")
    # (c) on the RMAT-SUITE_SCALE BFS panel plan the workers built
    _PREBUILT["spmv3", "ROW", "main", "bfs"].get(timeout=1200)
    n = 1 << SUITE_SCALE
    res = bfs_profile.profile(SUITE_SCALE, DEVICE, cache=PLAN_DIR, nv=n,
                              log=log)
    t = [res["gates"][gate]["seconds"] for gate in bfs_profile.GATES]
    ok = all(np.array_equal(res["state"][k], v)
             for k, v in _SUITE_WANT["bfs"].items())
    log(f"bfs_profile RMAT-{SUITE_SCALE}: gate forced/off/auto "
        f"{t[0]:.4f} / {t[1]:.4f} / {t[2]:.4f} s (best of "
        f"{bfs_profile.REPS}, {res['gates']['auto']['iters']} iterations; "
        f"auto's branches {res['gates']['auto']['gated']}), equal results; "
        f"state vs golden.bfs {'equal' if ok else 'DIFFER'} ({_SMI[0]})")
    for name, xs in res["phases"].items():
        log(f"bfs_profile per-phase: {name} total {sum(xs) * 1e3:.3f} ms, "
            f"per iteration (ms) {' '.join(f'{x * 1e3:.3f}' for x in xs)}")
    if not ok:
        raise AssertionError("bfs_profile: BFS differs from golden.bfs")
    _mark("entry c")
    # (d) eight ranks on the one card
    rec = sparse_exchange_bench.sweep(SUITE_SCALE, DEVICE)
    hops = _SUITE_WANT["bfs"]["hops"]
    want = float(hops[hops < _golden().INF].sum())
    for r in rec["detail"]["rows"]:
        log(f"sparse exchange RMAT-{SUITE_SCALE} K={r['K']}: "
            f"{r['seconds']:.4f} s / {r['iters']} iterations (best of "
            f"{sparse_exchange_bench.REPS}; {rec['detail']['mesh']})")
    log(f"sparse exchange: every K gives K=0's checksum "
        f"{rec['detail']['checksum']!r} / {rec['detail']['reachable']} "
        f"(golden {want!r}); {json.dumps(rec)}")
    if rec["detail"]["checksum"] != want:
        raise AssertionError("sparse exchange: the checksum differs from "
                             "golden.bfs")


def _stash_bench(np, g, main_meta, ref) -> None:
    """Write the main phase's RMAT-SCALE artifacts where tools/bench.py
    reads them in PLAN_DIR (the edge file, the COL and ROW tiles, the
    panel meta, the golden sum), so that phase 12 plans nothing again;
    the workers' degree shuffle plan is there already."""
    from graphtap_tpu_torch import Ordering
    from graphtap_tpu_torch.ingest.io import write_binary
    from graphtap_tpu_torch.tools import artifact_cache as ac
    from graphtap_tpu_torch.tools import bench
    t0 = time.perf_counter()
    if g.config != bench.graph_config(SCALE):
        raise AssertionError(f"the main graph's config {g.config} is not "
                             f"the bench's")
    r, c = ref["edges"]
    write_binary(os.path.join(PLAN_DIR, f"rmat{SCALE}_ef{EDGE_FACTOR}_"
                              f"s{SEED}.bin"), r, c, None)
    for o in (Ordering.COL, Ordering.ROW):
        ac.save_tileset(g.tiled(o), bench.tiles_path(PLAN_DIR, SCALE,
                                                     g.config, o))
    ac.save_spmv3_meta(main_meta, bench.plans_path(
        PLAN_DIR, g.tiled(Ordering.ROW), SCALE, g.config, Ordering.ROW,
        "panel", np.float32))
    with open(bench.golden_path(PLAN_DIR, SCALE, ITERS), "w") as f:
        f.write(repr(ref["checksum"]))
    log(f"benches: the main phase's RMAT-{SCALE} edges, tiles, panel meta "
        f"and golden sum written to the benchmarks' cache in "
        f"{time.perf_counter() - t0:.1f} s")


def _panel_need(iters: int) -> dict:
    """The panel launches of ``iters`` supersteps, each static or gated."""
    return {("route_xr_exp", "route_xr_exp_gated"): iters,
            ("route_passa", "route_passa_gated"): iters,
            ("route_fold", "route_fold_gated"): 2 * iters,
            "hub_fold": iters}


def phase_benches(np, ref) -> None:
    """Phase 12 (see the module docstring): (a) tools/bench.py at
    RMAT-SCALE, (b) the suite's BFS, CC and SSSP rows at RMAT-SUITE_SCALE,
    (c) its comm_model row."""
    from graphtap_tpu_torch.tools import bench, bench_suite
    # (a) the bench on the main phase's artifacts
    _reset_all_launches()
    rec = bench.run(SCALE, ITERS, "panel", WARM_RUNS, DEVICE, PLAN_DIR, log)
    launches = {k: v for k, v in _all_launches().items() if v}
    d = rec["detail"]
    log(f"benches: bench {json.dumps(rec)}")
    log(f"benches: bench launches {launches}")
    a = d["artifact_seconds"]
    if not all(a[f"{k}_cached_{o}"] for k in ("tiles", "plans")
               for o in ("COL", "ROW")):
        raise AssertionError(f"bench: an artifact was built again: {a}")
    _need_launches("benches bench", _all_launches(), {
        **_panel_need(ITERS * (WARM_RUNS + 1)), "expand_stream": 3,
        "group_stream": 1, "grouped_reduce": 1})
    rel = abs(d["checksum"] - ref["pr_checksum"]) / abs(ref["pr_checksum"])
    log(f"benches: bench RMAT-{SCALE} panel: {rec['value']:.4f} GTEPS "
        f"(median of {WARM_RUNS}, range {d['gteps_range'][0]:.4f}-"
        f"{d['gteps_range'][1]:.4f}), device superstep "
        f"{_fmt(d['device_superstep_ms'])}, {d['device_bytes']} device "
        f"bytes; checksum {d['checksum']!r}, rel err {d['golden_rel_err']:.3e}"
        f" vs golden, {rel:.3e} vs phase 4's ({d['name']}, "
        f"{d['power_limit']})")
    if not rel <= 1e-6:
        raise AssertionError(f"bench: checksum {d['checksum']} vs phase 4's "
                             f"{ref['pr_checksum']}")
    _mark("benches a")
    # (b) BFS, CC and SSSP on the workers' panel plans
    for app in bench_suite.APPS:
        _PREBUILT["spmv3", "ROW", "main", app].get(timeout=1200)
    edges = {}
    for app in bench_suite.APPS:
        _reset_all_launches()
        row = bench_suite.app_row(app, SUITE_SCALE, "panel", DEVICE,
                                  PLAN_DIR, log)
        d = row["detail"]
        log(f"benches: suite {json.dumps(row)}")
        if not d["artifact_seconds"]["plans_cached"]:
            raise AssertionError(f"suite {app}: its plans were built again")
        _need_launches(f"benches suite {app}", _all_launches(),
                       _panel_need(d["iterations"]))
        edges[app] = d["edges"]
    if not edges["cc"] > edges["bfs"]:
        raise AssertionError(f"suite: CC's edges {edges['cc']} do not exceed "
                             f"BFS's {edges['bfs']}")
    _mark("benches b")
    # (c) eight ranks on the one card
    row = bench_suite.comm_model(device=DEVICE, cache=PLAN_DIR, log=log)
    log(f"benches: suite {json.dumps(row)}")


def phase_probes(torch):
    """P1-P3: the quick copy-rate table and the per-panel table, their
    launches counted; then each kernel against its plain version at the
    tables' shapes, bit for bit, and its kernels-line row. Returns (the
    rows, the measured ceiling: the table's best copy rate in GB/s, P1's
    or Tensor.copy_'s)."""
    from graphtap_tpu_torch.tools import bw_probe as bw
    from graphtap_tpu_torch.tools import route_cost_probe as rc
    npanels, nwin = 2048, 20
    _reset_all_launches()
    t0 = time.perf_counter()
    rows_bw = bw.table(quick=True)
    rows_rc = rc.table(npanels)
    launches = {k: v for k, v in _all_launches().items() if v}
    log(f"probes: tables in {time.perf_counter() - t0:.1f} s; launches "
        f"{launches}")
    _need_launches("probes", launches, {k: 1 for k in PROBES})
    log(f"probes: {bw.card()} ({torch.cuda.get_device_name(0)})")
    for ln in bw.format_table(rows_bw).splitlines():
        log(f"probes P1/P2: {ln}")
    for label, shape, dtype, bm, bn, _ in bw.copy_shapes(quick=True):
        es = torch.tensor([], dtype=dtype).element_size()
        ch = bw.copy_chunks(shape[0], shape[1] * es, bm, bn * es)
        log(f"probes P1 {label}: {shape} {dtype}: chunks of "
            f"{ch.chunk_rows} rows x {ch.pieces} piece(s) of "
            f"{ch.piece_bytes} bytes, one block a chunk, ring depth "
            f"{bw.copy_blocks_per_sm(ch)} chunks in flight an SM")
    for ln in rc.format_table(rows_rc, npanels).splitlines():
        log(f"probes P3: {ln}")
    copies = [(gbs, name) for name, gbs in rows_bw
              if name.startswith("cuda copy") or name == "torch Tensor.copy_"]
    best, which = max(copies)
    log(f"probes: best P1 copy rate "
        f"{max(g for g, n in copies if n.startswith('cuda')):.1f} GB/s; the "
        f"measured ceiling is the table's best copy, {which}: {best:.1f} "
        f"GB/s (read+write), {best / (PEAK_BYTES / 1e9):.3f} of the "
        f"published 3350 GB/s")
    rows = {}
    x = torch.rand((bw.TARGET_BYTES // 4096, 1024), device=DEVICE)
    y = torch.empty_like(x)
    calls = [("copy_blocks", lambda: bw.copy_blocks(x, 256, 1024),
              lambda: bw.copy_blocks_plain(x, 256, 1024),
              (2 * _nbytes(x), 0), lambda: y.copy_(x))]
    xs = [torch.rand((bw.TARGET_BYTES // (1024 * 4 * 2) // 64 * 64, 1024),
                     device=DEVICE) for _ in range(2)]
    calls.append(("stream_sum", lambda: bw.stream_sum(xs),
                  lambda: bw.stream_sum_plain(xs),
                  (3 * _nbytes(xs[0]), xs[0].numel()),
                  lambda: torch.add(xs[0], xs[1])))
    tab = torch.rand((rc.XBLOCKS * rc.STRIPE, rc.LANES), device=DEVICE)
    bases = rc.make_inputs(npanels, nwin, "random", DEVICE)[1]
    nwins = int(torch.unique(bases).numel())
    calls.append(("route_like", lambda: rc.route_like(tab, bases, npanels,
                                                      nwin),
                  lambda: rc.route_like_plain(tab, bases, npanels, nwin),
                  (nwins * rc.STRIPE * rc.LANES * 4 + _nbytes(bases)
                   + npanels * rc.PROWS * rc.LANES * 4,
                   npanels * (nwin - 1) * rc.STRIPE * rc.LANES),
                  lambda: rc.route_like_library(tab, bases, npanels, nwin)))
    for name, kern, plain, work, lib in calls:
        a = kern()
        _check_call("probes", name, a, plain())
        if not _fold_ok(lib(), a, "sum", FOLD_RTOL["float32"]):
            raise AssertionError(f"{name}: the library call computes "
                                 f"another function")
        _time_row(torch, rows, name, kern, plain, 0.0, launches[name],
                  _bound(*work, torch.float32), lib)
    return list(rows.values()), best


def phase_cli(torch, np) -> None:
    """The pr, pr1, bfs, cc and sssp mains as subprocesses on the card, on
    RMAT-14 binary edge files (weighted for sssp): the balance line and
    the five oracle lines; each checksum against the golden model's."""
    from graphtap_tpu_torch.ingest import rmat_edges
    from graphtap_tpu_torch.ingest.io import write_binary
    golden = _golden()
    n = 1 << CLI_SCALE
    r, c, _ = rmat_edges(CLI_SCALE, EDGE_FACTOR, seed=SEED)
    rw, cw, w = rmat_edges(CLI_SCALE, EDGE_FACTOR, seed=SEED, weighted=True)
    paths = {k: os.path.join(os.path.dirname(PLAN_DIR),
                             f"rmat{CLI_SCALE}{k}.bin") for k in ("", "w")}
    write_binary(paths[""], r, c)
    write_binary(paths["w"], rw, cw, w)
    r64, c64 = r.astype(np.int64), c.astype(np.int64)
    inf = golden.INF

    def reached(v):
        v = v[v != inf]
        return float(v.sum()), int(v.size)
    pr_sum = float(golden.pagerank(r, c, n + 1, ITERS).sum())
    # app -> (third argument, edge file, golden (checksum, reachable) or
    # the golden checksum alone, held at GOLDEN_RTOL)
    mains = {
        "pr": (ITERS, paths[""], pr_sum),
        "pr1": (ITERS, paths[""], pr_sum),
        "bfs": (0, paths[""], reached(golden.bfs(r64, c64, n + 1, 0)[1])),
        "cc": (None, paths[""], reached(golden.cc(r64, c64, n + 1))),
        "sssp": (0, paths["w"], reached(golden.sssp(
            rw.astype(np.int64), cw.astype(np.int64), w.astype(np.int64),
            n + 1, 0)))}
    names = ["end-to-end time", "Execute time", "Iterations",
             "Value checksum", "Reachable vertices"]
    procs = {}
    try:
        for app, (third, path, _) in mains.items():
            procs[app] = subprocess.Popen(
                [sys.executable, "-m", f"graphtap_tpu_torch.apps.{app}", path,
                 str(n)] + ([] if third is None else [str(third)]),
                cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True, env=dict(os.environ, PYTHONPATH=ROOT))
        for app, p in procs.items():
            out, err = p.communicate(timeout=600)
            if p.returncode:
                raise AssertionError(f"cli {app}: exit {p.returncode}: "
                                     f"{err[-3000:]}")
            lines = out.strip().splitlines()
            for ln in lines:
                log(f"cli {app}: {ln}")
            heads = [ln.split(":")[0] for ln in lines[-5:]]
            if (heads != [f"{app} {names[0]}"] + names[1:] or len(lines) < 6
                    or not lines[-6].startswith("Edge balance: edges=")):
                raise AssertionError(f"cli {app}: not the balance line and "
                                     f"the five oracle lines")
            checksum = float(lines[-2].split(":")[1])
            reach = int(lines[-1].split(":")[1])
            want = mains[app][2]
            if app in ("pr", "pr1"):
                rel = abs(checksum - want) / want
                ok = (rel < GOLDEN_RTOL and lines[-3].split(":")[1].strip()
                      == str(ITERS))
                log(f"cli {app}: checksum vs f64 golden {want!r}: rel err "
                    f"{rel:.3e}")
            else:
                ok = (checksum, reach) == want
                log(f"cli {app}: checksum and reachable vs golden.{app} "
                    f"{want}: {'equal' if ok else 'DIFFER'}")
            if not ok:
                raise AssertionError(f"cli {app}: checksum {checksum} "
                                     f"(reachable {reach}) vs golden {want}")
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
        for path in paths.values():
            os.remove(path)


T_START = time.perf_counter()


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    import numpy as np
    sys.path.insert(0, ROOT)
    phase_device(torch)
    phase_build()
    shutil.rmtree(PLAN_DIR, ignore_errors=True)
    shutil.rmtree(LAB_DIR, ignore_errors=True)
    pool = multiprocessing.get_context("spawn").Pool(PREBUILD_WORKERS)
    _POOL.append(pool)
    try:
        _submit(PREBUILD)
        return _phases(torch, np)
    finally:
        pool.terminate()
        pool.join()
        shutil.rmtree(PLAN_DIR, ignore_errors=True)
        shutil.rmtree(LAB_DIR, ignore_errors=True)


def _mark(phase) -> None:
    log(f"{phase}: done at {time.perf_counter() - T_START:.1f} s of the "
        f"smoke wall")


def _phases(torch, np) -> int:
    kernels, best_copy = phase_probes(torch)
    _mark("probes")
    phase_parity(torch, np)
    phase_gated_parity(torch, np)
    phase_shuffle_parity(torch, np)
    phase_gather_parity(torch, np)
    _mark("parity")
    from graphtap_tpu_torch.tools import timing
    # a tracer gives every superstep its ms, which these phases log
    with timing.tracing():
        g, ex, launches, ref = phase_main(torch, np)
        kernels += phase_kernels(torch, ex, launches, best_copy)
        kernels += phase_staged(torch, ex)
        conv32 = {}
        _converge32("panel", ex, ex.degree_phase, conv32)
        _profile("panel", ex, ex.degree_phase)
        main_meta = ex.meta
        ex.free()
        deg_ex = ex.degree_phase
        del ex
        _mark("main, kernels, staged")
        kernels += phase_shuffle_kernels(torch, np, g, launches)
        kernels += phase_new_paths(torch, np, g, deg_ex, ref, conv32)
        del deg_ex
        _mark("paths")
        _submit(SUITE_PREBUILD)
        phase_cf(torch, np, g, ref, main_meta, conv32)
        _stash_bench(np, g, main_meta, ref)
        del g, main_meta
        _mark("cf")
        phase_csc(torch, np, ref, kernels)
        _mark("csc")
        phase_lab(torch, np, ref)
        _mark("lab")
        kernels += phase_bfs(torch, np)
        _mark("bfs")
        phase_cc_sssp(torch, np)
        _mark("cc/sssp")
    phase_cli(torch, np)
    _mark("cli")
    phase_mesh(torch, np, ref)
    _mark("mesh")
    phase_entry(torch, np)
    _mark("entry")
    phase_benches(np, ref)
    _mark("benches")
    log("ms per call group of one SpMV: route_fold sums its fixr and fix2 "
        "calls, expand_stream its three calls, "
        "windowed_gather its six stage calls; the static panel rows at a "
        "PageRank superstep, the shuffle rows at the degree SpMV "
        f"(RMAT-{SCALE}), windowed_gather at the shuffle2 and "
        "segment_reduce and segment_reduce_gather at the onehot PageRank "
        "superstep, windowed_gather64 "
        f"on one RMAT-{SCALE} v2 stage re-planned with 64-row steps, the "
        f"gated rows at BFS's first superstep (RMAT-{SUITE_SCALE}); "
        "bound_ms from the published peaks (3.35 TB/s; 67/34 TOP/s "
        "f32-int32/f64 outside the tensor cores)")
    for row in kernels:
        if row["bound_by"] == "bytes":
            log(f"bound at the measured copy rate ({best_copy:.1f} GB/s): "
                f"{row['name']} "
                f"{row['bound_ms'] * PEAK_BYTES / (best_copy * 1e9):.4f} ms "
                f"(published {row['bound_ms']:.4f} ms, kernel "
                f"{row['ms']:.4f} ms)")
    log(f"smoke wall {time.perf_counter() - T_START:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
