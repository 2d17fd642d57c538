"""Graph500 kernel 3's edge weights, as a function of the edge's unordered
endpoint pair: uniform in [0, 1) and exact in float32.

Graph500 (spec v3, kernel 3) draws one weight per generated edge. Here the
weight of an edge is a hash of its two endpoints, so the program (on the
raw edges it is handed) and the reference (on the stored edges) compute
the same weight for every stored edge without a new input from the
harness: both directions of an undirected edge, and every parallel copy
of one pair, share the pair's weight. The hash is splitmix64 of
``min(u, v) << 32 | max(u, v)``; its top 24 bits times 2**-24 are the
weight. torch's int64 arithmetic wraps as uint64's does, but its right
shift is arithmetic, so each shift is masked to its logical result.
Imports nothing of the program.
"""

from __future__ import annotations

import torch

_GAMMA = 0x9E3779B97F4A7C15
_M1 = 0xBF58476D1CE4E5B9
_M2 = 0x94D049BB133111EB
BITS = 24


def _i64(x: int) -> int:
    """The int64 whose bits are the uint64 ``x``."""
    return x - (1 << 64) if x >= 1 << 63 else x


def _shr(z: torch.Tensor, k: int) -> torch.Tensor:
    """The logical right shift of int64 ``z`` by ``k``."""
    return (z >> k) & ((1 << (64 - k)) - 1)


def splitmix64(x: torch.Tensor) -> torch.Tensor:
    """splitmix64's finalizer of ``x + gamma`` on int64 bit patterns."""
    z = x + _i64(_GAMMA)
    z = (z ^ _shr(z, 30)) * _i64(_M1)
    z = (z ^ _shr(z, 27)) * _i64(_M2)
    return z ^ _shr(z, 31)


def pair_weights(u, v) -> torch.Tensor:
    """float32 weights of the edges (u[i], v[i]) (vertex ids below 2**32),
    on their device: symmetric in u and v, uniform in [0, 1), each a
    multiple of 2**-24."""
    u, v = torch.as_tensor(u).long(), torch.as_tensor(v).long()
    key = torch.minimum(u, v) << 32 | torch.maximum(u, v)
    top = _shr(splitmix64(key), 64 - BITS)
    return top.to(torch.float32) * (2.0 ** -BITS)
