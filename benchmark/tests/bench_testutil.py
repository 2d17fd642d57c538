"""Shared helpers of the benchmark's CPU tests: a copy of the benchmark
at a tiny scale in a temporary directory, and one cell run there on the
CPU (the harness's look for a card skipped)."""

from __future__ import annotations

import json
import shutil
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

PR_CELL = "pr-s21-onehot-fixed20"
BFS_CELL = "bfs-s21-onehot-roots"


def tiny_copy(dst: Path, scale: int = 10) -> Path:
    """``BENCHMARK.json`` and ``benchmark/`` (no cache, no tests) under
    ``dst``, every configuration cut to ``scale``."""
    shutil.copytree(REPO / "benchmark", dst / "benchmark",
                    ignore=shutil.ignore_patterns("tests",
                                                  "__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", dst)
    for f in (dst / "benchmark" / "configs").glob("*.json"):
        cfg = json.loads(f.read_text())
        cfg["scale"] = scale
        f.write_text(json.dumps(cfg))
    return dst


def run_tiny(root: Path, cell: str, seed: int = 7, trace: bool = False,
             seconds: float = 0.2):
    """One run of ``cell`` under ``root`` on the CPU."""
    import torch
    from benchmark import harness
    return harness.run_cell(cell, seed, seconds, trace, torch.device("cpu"),
                            time.perf_counter(), lambda m: None, root=root)
