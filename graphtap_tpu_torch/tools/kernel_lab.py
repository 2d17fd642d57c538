"""Single-device kernel lab: compare the SpMV implementations on one graph.

Counterpart of ``graphtap_tpu/tools/kernel_lab.py`` (the analog of the
reference's ``src/singlenode/`` harness, main.cpp: format/kernel variants
running the same PageRank and printing memory / time / op count /
checksum for cross-checking). The variants are the port's kernels behind
one API:

  0  scan      — torch segmented reduce over TCSC (portable)
  1  segment   — torch scatter-reduce over TCSC (portable)
  2  scan-csc  — the scan kernel over plain CSC (no renumbering)
  3  shuffle   — the v1 static-shuffle pipeline (K6-K8)
  4  shuffle2  — the v2 windowed-gather pipeline (K9 + K8)
  5  panel     — the v3 panel-route pipeline (K1-K4)
  6  onehot    — the blocked one-hot reduce from the plan (K5, which
                 gathers x and applies the ⊗ itself)
  7  scan-cf   — TCSC_CF phase execution (first/middle/last subsets)
  8  scan-dcsc — DCSC: compact nnz-col ids, x gathered through the JC
                 table (reference: dcsc_spmv.hpp:216-230)

Each variant runs its degree phase (COL ordering) and PageRank (ROW) on
its own kernel; TCSC_CF's degree phase takes the TCSC tiles of the same
graph (``Executor(tiles=...)``). Cross-checks (reference:
csc_spmv.hpp:222-228 — op counts and checksums must agree across
formats): ``operations`` = stored nnz x iterations from each variant's OWN
tileset, so a format that dropped or duplicated edges breaks the
equality; ``slots`` counts the padded slots the variant streams (its work
amplification), which may differ. The plans are the JAX package's byte
for byte, so ``operations``, ``slots`` and ``memory_gb`` equal its lab's
exactly (``tests/test_torch_lab.py``).

Usage: python -m graphtap_tpu_torch.tools.kernel_lab <which 0-8> <file>
<nvertices> <niters> [--device cuda|cpu] (mirrors ``bin/main <which>
<file> <nvertices> <niters>``, singlenode/main.cpp:26); ``--device`` is
``cuda`` unless the caller asks for ``cpu``.
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from graphtap_tpu_torch.apps.degree import DegreeProgram
from graphtap_tpu_torch.apps.pagerank import PageRankProgram
from graphtap_tpu_torch.config import (Compression, EngineConfig,
                                       GraphConfig, Ordering)
from graphtap_tpu_torch.engine.executor import Executor
from graphtap_tpu_torch.ingest.graph import Graph
from graphtap_tpu_torch.kernels.panel_plan import PROWS, XROWS

VARIANTS = {0: ("scan", "tcsc"), 1: ("segment", "tcsc"),
            2: ("scan", "csc"), 3: ("shuffle", "tcsc"),
            4: ("shuffle2", "tcsc"), 5: ("panel", "tcsc"),
            6: ("onehot", "tcsc"), 7: ("scan", "tcsc_cf"),
            8: ("scan", "dcsc")}

LANES = 128


def _slots_per_iter(ex) -> int:
    """Padded slots the variant streams per iteration (work volume)."""
    k, m = ex.kernel, ex.meta
    if k in ("scan", "segment"):
        return ex.tiles.Ep
    if k == "onehot":
        return m.Ep
    if k == "shuffle":
        return m.total_rows * (m.npasses + 1) * LANES
    if k == "shuffle2":
        return sum(m.out_rows.values()) * LANES
    return ((m.exp_panels + 1) * XROWS + m.exp_panels * PROWS
            + m.pa_panels * PROWS + m.fix_panels * PROWS
            + m.f2_panels * PROWS + m.dense_rows) * LANES


def run_variant(which: int, path: str, nvertices: int, niters: int,
                value_dtype=None, device="cuda") -> dict:
    """Degree then ``niters`` PageRank iterations of variant ``which`` on
    the edge-list file ``path``, on ``device`` ('cuda' unless the caller
    asks for 'cpu'): one warm-up run, then the timed run (ending with a
    device synchronize). ``value_dtype`` defaults to ``torch.float32``."""
    if value_dtype is None:
        value_dtype = torch.float32
    kernel, comp = VARIANTS[which]
    compression = {"tcsc": Compression.TCSC, "csc": Compression.CSC,
                   "tcsc_cf": Compression.TCSC_CF,
                   "dcsc": Compression.DCSC}[comp]
    g = Graph.load(path, GraphConfig(num_vertices=nvertices, directed=True,
                                     transpose=True,
                                     compression=compression))

    deg_ex = Executor(g, DegreeProgram(value_dtype=value_dtype),
                      EngineConfig(stationary=True, ordering=Ordering.COL),
                      tiles=g.tiled(Ordering.COL,
                                    compression=Compression.TCSC
                                    if comp == "tcsc_cf" else None),
                      kernel=kernel, device=device)
    deg_ex.initialize()
    deg_ex.execute(1)
    deg_ex.free()          # its state stays for the handoff

    pr_ex = Executor(g, PageRankProgram(value_dtype=value_dtype),
                     EngineConfig(stationary=True, ordering=Ordering.ROW),
                     kernel=kernel, device=device)
    pr_ex.initialize(other=deg_ex)
    pr_ex.execute(niters)  # warm-up
    pr_ex.initialize(other=deg_ex)
    t0 = time.perf_counter()
    pr_ex.execute(niters)
    dt = time.perf_counter() - t0

    nnz = pr_ex.tiles.nnz_total
    checksum, reachable = pr_ex.checksum()
    mem = sum(a.nbytes for a in
              (pr_ex.tiles.rows, pr_ex.tiles.cols, pr_ex.tiles.ja))
    slots = _slots_per_iter(pr_ex) * niters
    pr_ex.free()
    return {
        "variant": f"{kernel}/{comp}",
        "memory_gb": mem / 1e9,
        "seconds": dt,
        "operations": nnz * niters,
        "slots": slots,
        "pad_factor": slots / max(1, nnz * niters),
        "gteps": nnz * niters / dt / 1e9,
        "checksum": checksum,
        "reachable": reachable,
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="graphtap_tpu_torch.tools.kernel_lab")
    p.add_argument("which", type=int, choices=sorted(VARIANTS))
    p.add_argument("file")
    p.add_argument("nvertices", type=int)
    p.add_argument("niters", type=int)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)
    r = run_variant(args.which, args.file, args.nvertices, args.niters,
                    device=args.device)
    print(f"{r['variant']} kernel unit test stats:")
    print(f"Utilized Memory: {r['memory_gb']:.6g} GB")
    print(f"Elapsed time   : {r['seconds']:.6g} Sec")
    print(f"Num Operations : {r['operations']}")
    print(f"Slots Streamed : {r['slots']} (pad x{r['pad_factor']:.2f})")
    print(f"GTEPS          : {r['gteps']:.4f}")
    print(f"Final value    : {r['checksum']:.6g}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
