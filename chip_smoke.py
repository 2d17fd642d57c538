"""Card smoke of the main path: the cells' apps on the one-hot path at the
cells' scales, every K5-from-the-plan call of each run held against its
plain version bit for bit, then the kernel timed on that run's inputs.

    python3 chip_smoke.py

Four runs, each from RMAT edges (edge factor 16, seed 1) through the
app's entry point on the card with kernel "onehot":

  pagerank  f32 PageRank, 20 fixed supersteps, RMAT-21, transposed TCSC,
            the degree phase on "scan" (``run_pagerank``): K5's f32 sum;
  bfs       BFS from vertex 0 to convergence, RMAT-21 (``bfs_config``,
            ``run_bfs``): K5's int32 min;
  sssp      f32 SSSP from vertex 0, RMAT-20, undirected and deduplicated,
            weighted by ``benchmark/g500_weights.py`` (``run_sssp``): K5's
            f32 min-plus;
  sssp_i32  int32 SSSP from vertex 0, RMAT-20 (``sssp_config``, the
            generator's weights): K5's int32 min-plus, saturating.

The launch counts are reset just before each run
(``timing.reset_launches``); after it they must show K5 from the plan
(``segment_reduce_gather``) once a call recorded and no other hand
kernel, and at least once a superstep. Each call's inputs and
output are recorded, and the output must equal
``segment_reduce_gather_plain`` of the same inputs bit for bit. The run's
last call is then timed beside the PyTorch composition it replaces (the
contributions built in torch, then K5), which must give the same bits:
eager ms by CUDA events over ten calls, device-only ms by
``timing.device_ms``, and ``bound_ms``, the call's bytes at the card's
published 3.35 TB/s or its ⊗ and ⊕ at 67 TOP/s, whichever is longer.
Prints a JSON line a run, then ``{"kernels": [...]}`` (a row a run) and
``{"ok": true, "device": ...}``. Needs a card.
"""

from __future__ import annotations

import json
import sys
import time

import torch

from graphtap_tpu_torch import Graph, GraphConfig
from graphtap_tpu_torch.apps import (bfs_config, run_bfs, run_pagerank,
                                     run_sssp, sssp_config)
from graphtap_tpu_torch.ingest import rmat_edges
from graphtap_tpu_torch.kernels import onehot_spmv as oh
from graphtap_tpu_torch.tools import timing
from graphtap_tpu_torch.tools.ring_times import check

RUNS = {"pagerank": 21, "bfs": 21, "sssp": 20, "sssp_i32": 20}
PEAK_BYTES, PEAK_OPS = 3.35e12, 67e12


def app_run(name: str, scale: int, device="cuda"):
    """The executor of run ``name`` at RMAT-``scale``, run to its end."""
    nv = 1 << scale
    r, c, w = rmat_edges(scale, 16, seed=1, weighted=name == "sssp_i32")
    if name == "pagerank":
        g = Graph.from_edges(r, c, None, GraphConfig(num_vertices=nv,
                                                     transpose=True))
        return run_pagerank(g, 20, torch.float32, kernel="onehot",
                            device=device, degree_kernel="scan")
    if name == "bfs":
        return run_bfs(Graph.from_edges(r, c, None, bfs_config(nv)), 0,
                       kernel="onehot", device=device)
    if name == "sssp_i32":
        return run_sssp(Graph.from_edges(r, c, w, sssp_config(nv)), 0,
                        kernel="onehot", device=device)
    from benchmark.g500_weights import pair_weights
    w = pair_weights(torch.from_numpy(r), torch.from_numpy(c)).numpy()
    g = Graph.from_edges(r, c, w, GraphConfig(
        num_vertices=nv, directed=False, self_loops=False,
        parallel_edges=False, has_weight=True))
    return run_sssp(g, 0, kernel="onehot", device=device,
                    value_dtype=torch.float32)


def recorded_run(name: str, scale: int, device="cuda"):
    """(executor, calls, launches, seconds) of run ``name``: ``calls`` the
    (args, kwargs, output) of each K5-from-the-plan call it made, x and
    the output copied at the call; ``launches`` counted from a reset just
    before the run."""
    calls, kernel = [], oh.segment_reduce_gather

    def record(*args, **kw):
        y = kernel(*args, **kw)
        calls.append(((args[0].clone(),) + args[1:], kw, y.clone()))
        return y
    oh.segment_reduce_gather = record
    try:
        timing.reset_launches()
        t0 = time.perf_counter()
        ex = app_run(name, scale, device)
        secs = time.perf_counter() - t0
        launches = timing.launches()
    finally:
        oh.segment_reduce_gather = kernel
    return ex, calls, launches, secs


def _ms(fn, reps: int = 10) -> float:
    """Mean time of one eager call, CUDA events over ``reps`` calls."""
    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def composition(sem, args, kw):
    """The PyTorch composition that K5 from the plan replaces, as a call
    on the recorded ``args``/``kw``: the contributions built in torch by
    the semiring ``sem``'s own ⊗, then K5."""
    x, cols, evalid, w, lrows, chunk_block, nblocks, nr = args[:8]
    reduce_kind, identity = args[9], args[11]
    return lambda: oh.segment_reduce(
        oh.gather_contrib(x, cols, evalid, w, sem.mul, identity), lrows,
        chunk_block, nblocks, nr, reduce_kind, identity, lists=kw["lists"],
        scratch=kw["scratch"])


def kernel_row(name: str, ex, args, kw, launches: int) -> dict:
    """The kernels-line row of run ``name``'s call ``args``/``kw``."""
    x, cols, _, w, _, chunk_block, nblocks = args[:7]
    reduce_kind, mul_kind = args[9], args[10]
    kern = lambda: oh.segment_reduce_gather(*args, **kw)   # noqa: E731
    lib = composition(ex.program.semiring, args, kw)
    check(name, kern, lambda: oh.segment_reduce_gather_plain(*args), lib)
    ep, es = cols.numel(), x.element_size()
    nbytes = (ep * (9 + (0 if w is None else w.element_size()))
              + chunk_block.numel() * 4 + x.numel() * es
              + nblocks * oh.RB * es)
    ops = ep * (1 if w is None else 2)
    t_b, t_o = nbytes / PEAK_BYTES, ops / PEAK_OPS
    return {"name": "segment_reduce_gather", "run": name,
            "dtype": str(x.dtype).split(".")[-1], "reduce": reduce_kind,
            "mul": mul_kind, "slots": ep, "launches": launches,
            "ms": _ms(kern), "device_ms": timing.device_ms(kern),
            "library_ms": _ms(lib), "library_device_ms":
            timing.device_ms(lib), "bound_ms": max(t_b, t_o) * 1e3,
            "bound_by": "bytes" if t_b >= t_o else "operations",
            "bytes": nbytes}


def smoke(name: str, scale: int) -> dict:
    """Run ``name`` at RMAT-``scale`` on the card and check it (see the
    module's docstring); returns its kernels-line row."""
    ex, calls, launches, secs = recorded_run(name, scale)
    n = len(calls)
    if launches != {"segment_reduce_gather": n} or n < ex.iteration:
        raise AssertionError(f"{name}: launches {launches}, {n} calls "
                             f"recorded, {ex.iteration} supersteps")
    for i, (args, kw, y) in enumerate(calls):
        if not torch.equal(y, oh.segment_reduce_gather_plain(*args)):
            raise AssertionError(f"{name}: call {i} of {n} differs from "
                                 f"segment_reduce_gather_plain")
    tm = ex.timings
    print(json.dumps({"run": name, "scale": scale, "seconds": secs,
                      "supersteps": ex.iteration, "launches": launches,
                      "calls_equal_plain": n, "nnz": ex.tiles.nnz_total,
                      "tiles_s": tm["tiles"], "plans_s": tm["plans"],
                      "upload_s": tm["upload"],
                      "execute_s": tm["execute"]}), flush=True)
    args, kw, _ = calls[-1]
    row = kernel_row(name, ex, args, kw, n)
    ex.free()
    return row


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; it checks the card",
              file=sys.stderr)
        return 1
    from graphtap_tpu_torch.tools.bw_probe import card
    print(card(), flush=True)
    kernels = [smoke(name, scale) for name, scale in RUNS.items()]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
