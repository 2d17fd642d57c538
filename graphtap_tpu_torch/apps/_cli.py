"""Shared CLI harness for the app mains.

Counterpart of ``graphtap_tpu/apps/_cli.py``: the reference binaries' argv
(reference: README.md:7-10, ``bin/pr <file> <nvertices> [<iters|root>]``)
and their five oracle lines (graphtap.slurm:101-104; formats from
Env::print_time env.hpp:130-133, checksum vertex_program.hpp:1944-1958),
after the load-time edge balance line (reference: Matrix::balance,
matrix.hpp:617-685; ``TileSet.balance_report``):

    Edge balance: edges=<n> mean/dev=<n> max/dev=<n> imbalance=<f>
    <App> end-to-end time: <f> seconds
    Execute time: <f> seconds
    Iterations: <n>
    Value checksum: <v>
    Reachable vertices: <n>

Usage: ``python -m graphtap_tpu_torch.apps.pr <file> <nvertices> [<iters>]``
(``pr1``, ``deg`` and ``cc`` alike; ``bfs`` and ``sssp`` take
``[<root>]``). ``--device`` is ``cuda`` unless the caller
asks for ``cpu``. ``--kernel``: ``auto`` (the default) is the panel
pipeline on the card and the portable scan kernel on the CPU, as the JAX
package's ``auto`` picks its chip's fast kernel; or any name of
``engine.executor.KERNELS``.

Started by a launcher (RANK and WORLD_SIZE set: ``parallel/launch.py``,
the analog of ``mpirun -np N``), every rank joins the process group (gloo)
and runs on the world's near-square mesh, each reading its byte range of
the file; the balance line prints on rank 0 only, the oracle lines on
every rank (the same values: the checksum gathers every rank's state).
"""

from __future__ import annotations

import argparse
import time

from graphtap_tpu_torch.engine.executor import KERNELS
from graphtap_tpu_torch.parallel import multihost
from graphtap_tpu_torch.parallel.layout import make_mesh


def app_main(name: str, run, third_arg: str = "iters", default_third=0,
             argv=None):
    """Parse the reference-style argv, run the app, print the oracle
    lines (the balance line first). ``run(graph_path, nvertices, third,
    kernel, device, mesh)`` must return (the finished Executor, its
    execute seconds); ``mesh``: the launcher's mesh, or None."""
    p = argparse.ArgumentParser(prog=f"graphtap_tpu_torch.apps.{name}")
    p.add_argument("file")
    p.add_argument("nvertices", type=int)
    p.add_argument(third_arg, type=int, nargs="?", default=default_third)
    p.add_argument("--kernel", default="auto", choices=("auto",) + KERNELS)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)
    if args.kernel == "auto":
        args.kernel = "panel" if args.device == "cuda" else "scan"

    rank, world = multihost.initialize()
    mesh = make_mesh() if world > 1 else None

    t0 = time.perf_counter()
    ex, t_exec = run(args.file, args.nvertices, getattr(args, third_arg),
                     args.kernel, args.device, mesh)
    t_total = time.perf_counter() - t0

    checksum, reachable = ex.checksum()
    if rank == 0:
        print(ex.tiles.balance_report())
    print(f"{name} end-to-end time: {t_total:f} seconds")
    print(f"Execute time: {t_exec:f} seconds")
    print(f"Iterations: {ex.iteration}")
    print(f"Value checksum: {checksum:f}")
    print(f"Reachable vertices: {reachable}")
    return ex


def timed(fn, *a, **kw):
    t0 = time.perf_counter()
    out = fn(*a, **kw)
    return out, time.perf_counter() - t0
