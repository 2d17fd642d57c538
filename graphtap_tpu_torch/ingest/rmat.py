"""RMAT (recursive-matrix) synthetic graph generator.

The reference consumes pre-built RMAT-10..30 files (graphtap.slurm:43-48);
this module synthesizes them so the benchmark configs are reproducible
without the original datasets. Standard Graph500-style RMAT with
(a, b, c, d) = (0.57, 0.19, 0.19, 0.05) by default, vectorized in NumPy.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def rmat_edges(
    scale: int,
    edge_factor: int = 16,
    a: float = 0.57, b: float = 0.19, c: float = 0.19,
    seed: int = 1,
    weighted: bool = False,
    weight_range: Tuple[int, int] = (1, 128),
) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
    """Generate 2^scale-vertex RMAT edges (edge_factor * 2^scale of them).

    Weights follow the reference converter's ``1 + rand() % 128`` range
    (converter.cpp:81,130). Returns (rows, cols, weights|None) int64/int32.
    """
    n_edges = edge_factor << scale
    rng = np.random.default_rng(seed)
    r = np.zeros(n_edges, dtype=np.int64)
    col = np.zeros(n_edges, dtype=np.int64)
    ab = a + b
    a_norm = a / ab if ab > 0 else 0.5
    c_norm = c / (1.0 - ab) if ab < 1 else 0.5
    for bit in range(scale):
        go_south = rng.random(n_edges) >= ab
        p_east = np.where(go_south, c_norm, a_norm)
        go_east = rng.random(n_edges) >= p_east
        r |= go_south.astype(np.int64) << bit
        col |= go_east.astype(np.int64) << bit
    w = None
    if weighted:
        lo, hi = weight_range
        w = rng.integers(lo, hi + 1, size=n_edges, dtype=np.int64).astype(np.int32)
    return r, col, w
