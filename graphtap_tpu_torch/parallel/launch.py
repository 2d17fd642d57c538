"""Launch N ranks of a command on this host: the port's ``mpirun -np N``.

Each rank is a process with RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR
(localhost) and MASTER_PORT (a free local port) set, which
``multihost.initialize()`` reads; each runs one thread of torch's CPU
pool (OMP_NUM_THREADS=1, unless the caller's environment sets it). The
ranks' output goes to files, so no pipe fills; when a rank fails or the
hard timeout passes, every rank still running is killed, so a lost rank
never leaves the others waiting in a collective.

    python -m graphtap_tpu_torch.parallel.launch -n 4 [--timeout S] -- \\
        python -m graphtap_tpu_torch.apps.pr <file> <nvertices> 20

prints each rank's output, rank by rank, and exits with the first
nonzero code (a timeout: 124).
"""

from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass
from typing import List, Optional, Sequence


POLL_S = 0.2        # seconds between looks at the ranks


@dataclass
class RankResult:
    rank: int
    returncode: Optional[int]      # negative: killed (by signal -code)
    stdout: str
    stderr: str


class LaunchError(RuntimeError):
    """A rank failed (``failed``: its rank) or the launch timed out
    (``failed`` None); ``results`` holds every rank's exit code and
    output."""

    def __init__(self, msg: str, results: List[RankResult],
                 failed: Optional[int]):
        super().__init__(msg)
        self.results = results
        self.failed = failed


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(cmd: Sequence[str], nprocs: int, timeout: float,
           env: Optional[dict] = None,
           cwd: Optional[str] = None) -> List[RankResult]:
    """Run ``nprocs`` ranks of ``cmd`` and wait for all; returns each
    rank's result, or raises ``LaunchError`` (with every result) when a
    rank exits nonzero or ``timeout`` seconds pass."""
    base = dict(os.environ if env is None else env)
    base.setdefault("OMP_NUM_THREADS", "1")
    base.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()),
                WORLD_SIZE=str(nprocs))
    with tempfile.TemporaryDirectory(prefix="graphtap_launch_") as tmp:
        procs, files = [], []
        try:
            for rank in range(nprocs):
                out = open(os.path.join(tmp, f"{rank}.out"), "w+")
                err = open(os.path.join(tmp, f"{rank}.err"), "w+")
                files.append((out, err))
                procs.append(subprocess.Popen(
                    list(cmd), cwd=cwd, stdout=out, stderr=err,
                    env=dict(base, RANK=str(rank), LOCAL_RANK=str(rank))))
            deadline = time.monotonic() + timeout
            failed = None
            while True:
                codes = [p.poll() for p in procs]
                failed = next((r for r, c in enumerate(codes)
                               if c not in (None, 0)), None)
                if failed is not None or all(c == 0 for c in codes) \
                        or time.monotonic() > deadline:
                    break
                time.sleep(POLL_S)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
            results = []
            for rank, (out, err) in enumerate(files):
                out.seek(0)
                err.seek(0)
                results.append(RankResult(rank, procs[rank].returncode
                                          if rank < len(procs) else None,
                                          out.read(), err.read()))
                out.close()
                err.close()
    if failed is not None:
        r = results[failed]
        raise LaunchError(f"rank {failed} of {nprocs} exited "
                          f"{r.returncode}:\n{r.stderr[-4000:]}", results,
                          failed)
    if any(r.returncode != 0 for r in results):
        raise LaunchError(f"{nprocs} ranks of {list(cmd)} timed out after "
                          f"{timeout} s", results, None)
    return results


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="graphtap_tpu_torch.parallel.launch")
    p.add_argument("-n", "--nprocs", type=int, required=True)
    p.add_argument("--timeout", type=float, default=3600.0)
    p.add_argument("cmd", nargs=argparse.REMAINDER)
    args = p.parse_args(argv)
    cmd = args.cmd[1:] if args.cmd[:1] == ["--"] else args.cmd
    if not cmd:
        p.error("no command")
    try:
        results = launch(cmd, args.nprocs, args.timeout)
        code = 0
    except LaunchError as e:
        results = e.results
        code = 124 if e.failed is None else results[e.failed].returncode
    for r in results:
        for ln in r.stdout.splitlines():
            print(f"[rank {r.rank}] {ln}")
        for ln in r.stderr.splitlines():
            print(f"[rank {r.rank}] {ln}", file=sys.stderr)
    return code


if __name__ == "__main__":
    sys.exit(main())
