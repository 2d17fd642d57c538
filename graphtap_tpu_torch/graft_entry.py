"""Top-level entry points: one PageRank superstep, and the mesh's programs.

Counterpart of the JAX package's ``__graft_entry__.py``:

``entry(device)``      one PageRank superstep through the v3 panel SpMV
                       (K1-K4 on the card; their plain versions on the
                       CPU), as a function plus its example arguments.
``dryrun_multichip(n)`` the four program kinds of a mesh run on an
                       ``integer_factorize(n)`` mesh of n
                       ``torch.distributed`` ranks (``parallel/launch.py``
                       starting ``tools/mesh_run.py``): degree then
                       PageRank on panel, weighted SSSP on panel
                       (nonstationary, gated where the frontier is
                       sparse), BFS to convergence (the vote and the
                       flush), and TCSC_CF phased PageRank.

    python -m graphtap_tpu_torch.graft_entry [--device cpu] [--dryrun N]

runs one step and prints ``entry ok: <shape> <sum>``; ``--dryrun N``
then runs the mesh's programs on N ranks and prints rank 0's checksums.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
from typing import Callable, Dict, Tuple

import numpy as np
import torch

from graphtap_tpu_torch.config import Compression
from graphtap_tpu_torch.engine.executor import _device
from graphtap_tpu_torch.format.tiles import build_tileset
from graphtap_tpu_torch.ingest.io import write_binary
from graphtap_tpu_torch.ingest.rmat import rmat_edges
from graphtap_tpu_torch.kernels.panel_engine import spmv3_local, spmv3_plain
from graphtap_tpu_torch.kernels.panel_meta import build_spmv3_meta
from graphtap_tpu_torch.kernels.semiring import plus_times
from graphtap_tpu_torch.parallel.launch import launch
from graphtap_tpu_torch.parallel.layout import Partition, integer_factorize
from graphtap_tpu_torch.tools.convert import meta_from_numpy

ALPHA = 0.15
# the mesh programs, in the JAX dryrun's order: name -> its mesh_run case
DRYRUN_RUNS = (
    # degree on the COL ordering, then one PageRank superstep, on panel
    {"name": "pagerank", "graph": "pr", "app": "pagerank", "kernel": "panel",
     "degree_kernel": "panel", "dtype": "float32", "iters": 1},
    # weighted SSSP on panel: the nonstationary masked messenger
    {"name": "sssp", "graph": "sssp", "app": "sssp", "kernel": "panel",
     "root": 0},
    # BFS to convergence: the vote and the post-convergence flush
    {"name": "bfs", "graph": "bfs", "app": "bfs", "kernel": "scan",
     "root": 0},
    # TCSC_CF: the degree phase, then first / middle / last
    {"name": "cf_pagerank", "graph": "cf", "app": "pagerank",
     "kernel": "scan", "degree_kernel": "scan", "dtype": "float32",
     "iters": 3},
)
DRYRUN_ALIGN = {"segment_align": 128, "edge_align": 256}


def _small_graph(scale: int = 12, seed: int = 3):
    r, c, _ = rmat_edges(scale=scale, edge_factor=16, seed=seed)
    return r, c, 1 << scale


def entry(device="cuda", plain: bool = False
          ) -> Tuple[Callable, Tuple[torch.Tensor, torch.Tensor]]:
    """(step, (rank0, degree)): one PageRank superstep on one device
    through the v3 panel SpMV, on RMAT-12 (seed 3) tiled as the transpose.
    ``step(rank, degree)`` is the messenger, the SpMV, ``0.15 + 0.85 y``,
    masked to the vertices with in-edges. On the card the SpMV runs K1-K4;
    ``plain`` runs their plain versions there instead (the yardstick)."""
    dev = _device(device)
    src, dst, n = _small_graph()
    part = Partition.build(nv=n + 1, R=1, C=1, segment_align=1024)
    # PageRank pulls along in-edges: tile the transpose
    ts = build_tileset(dst, src, None, part, compression=Compression.TCSC)
    sem = plus_times()
    meta = build_spmv3_meta(ts, value_dtype=np.float32)
    t = meta_from_numpy(meta.arrays, dev)
    i_own = torch.from_numpy(np.asarray(ts.i_own[0])).to(dev)
    spmv = spmv3_plain if plain else spmv3_local
    alpha = torch.tensor(ALPHA, dtype=torch.float32, device=dev)

    outdeg = np.bincount(src, minlength=part.n_pad).astype(np.float32)
    has_in = np.zeros(part.n_pad, bool)
    has_in[dst] = True
    degree = torch.from_numpy(np.where(has_in, outdeg, 0.0)
                              .astype(np.float32)).to(dev)
    rank0 = torch.full((part.n_pad,), ALPHA, dtype=torch.float32,
                       device=dev)

    def step(rank: torch.Tensor, degree: torch.Tensor) -> torch.Tensor:
        pos = degree > 0
        m = torch.where(pos, rank / torch.where(pos, degree, 1.0), 0.0)
        y = spmv(m, t, meta, sem, part.tile_rows)
        return torch.where(i_own, alpha + (1 - alpha) * y, rank)

    return step, (rank0, degree)


def _dryrun_spec(n_devices: int, edge_dir: str, out: str,
                device="cuda") -> dict:
    """The ``tools/mesh_run.py`` spec of ``dryrun_multichip``: RMAT-10
    (seed 3) written to ``edge_dir`` (plain and SSSP-weighted), the four
    programs of ``DRYRUN_RUNS``, rank 0's results to ``out``."""
    src, dst, n = _small_graph(scale=10)
    wts = (1 + (src * 7 + dst * 13) % 128).astype(np.int32)
    plain = os.path.join(edge_dir, "rmat10.bin")
    weighted = os.path.join(edge_dir, "rmat10w.bin")
    write_binary(plain, src, dst)
    write_binary(weighted, src, dst, wts)
    return {
        "shape": list(integer_factorize(n_devices)), "backend": "gloo",
        "device": str(device), "out": out, "runs": list(DRYRUN_RUNS),
        "graphs": {
            "pr": {"path": plain, "nv": n, "config": "pr",
                   "overrides": DRYRUN_ALIGN},
            "sssp": {"path": weighted, "nv": n, "config": "sssp"},
            "bfs": {"path": plain, "nv": n, "config": "bfs"},
            "cf": {"path": plain, "nv": n, "config": "pr",
                   "overrides": dict(DRYRUN_ALIGN,
                                     compression=Compression.TCSC_CF.value)},
        }}


def dryrun_multichip(n_devices: int, device="cuda",
                     timeout: float = 600.0) -> Dict[str, dict]:
    """Run the mesh's four programs on ``n_devices`` ranks and return
    rank 0's record of each (``tools/mesh_run.py``: checksum, reachable,
    iteration, the exchange's transport and, per rank, each superstep's
    branches and ms and the kernel launches; ``state``, the final state
    in vertex order), by program name. The ranks
    share the one card (or the CPU) over gloo. A rank that fails or
    times out raises ``LaunchError``; a program whose result is not
    finite, reaches nothing or takes no superstep raises
    ``AssertionError``."""
    _device(device)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with tempfile.TemporaryDirectory(prefix="graphtap_dryrun_") as tmp:
        out = os.path.join(tmp, "out")
        spec = _dryrun_spec(n_devices, tmp, out, device)
        path = os.path.join(tmp, "spec.json")
        with open(path, "w") as f:
            json.dump(spec, f)
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            p for p in (root, os.environ.get("PYTHONPATH")) if p))
        launch([sys.executable, "-m", "graphtap_tpu_torch.tools.mesh_run",
                path], n_devices, timeout, env=env, cwd=root)
        res = {}
        for run in DRYRUN_RUNS:
            name = run["name"]
            with open(os.path.join(out, f"{name}.json")) as f:
                res[name] = json.load(f)
            with np.load(os.path.join(out, f"{name}.npz")) as z:
                res[name]["state"] = {k: z[k] for k in z.files}
    for name in ("pagerank", "cf_pagerank"):
        if not (np.isfinite(res[name]["checksum"])
                and res[name]["reachable"] > 0):
            raise AssertionError(f"dryrun {name}: {res[name]['checksum']}, "
                                 f"reachable {res[name]['reachable']}")
    for name in ("sssp", "bfs"):
        if res[name]["iteration"] <= 0:
            raise AssertionError(f"dryrun {name}: no superstep")
    return res


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="graphtap_tpu_torch.graft_entry")
    p.add_argument("--device", default="cuda")
    p.add_argument("--dryrun", type=int, default=0, metavar="N",
                   help="then run dryrun_multichip(N)")
    args = p.parse_args(argv)
    step, ex_args = entry(args.device)
    out = step(*ex_args)
    print("entry ok:", tuple(out.shape), float(out.sum()))
    if args.dryrun:
        for name, r in dryrun_multichip(args.dryrun, args.device).items():
            print(f"dryrun {name}: checksum {r['checksum']!r}, reachable "
                  f"{r['reachable']}, {r['iteration']} iterations")
    return 0


if __name__ == "__main__":
    sys.exit(main())
