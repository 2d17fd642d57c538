"""The vertex and tile partition of an R x C mesh, and the mesh itself.

Counterpart of ``graphtap_tpu/parallel/layout.py``: the same segment
arithmetic, so the port's tiles and plans are byte-identical to the JAX
package's. Device (i, j) of the mesh holds shard ``b = i*C + j`` (JAX's
row-major device order) and owns vertex segment ``s = j*R + i``; its
tile holds every edge (r, c) with ``seg(c) // R == j`` and
``seg(r) % R == i``.

The JAX package's mesh is a ``jax.sharding.Mesh`` under ``shard_map``;
the port's is ``Mesh``, one ``torch.distributed`` rank per shard (rank =
shard): ``xgroup`` is the rank's mesh column (the JAX ``rows`` axis, over
which x is all-gathered), ``ygroup`` its mesh row (the ``cols`` axis,
over which the partial y is exchanged and folded), ``host_group`` a gloo
group over the mesh for the host-side reductions of ingest, tiling and
planning. Without a process group there is no mesh: the layout is 1x1
and nothing is exchanged.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Optional, Tuple

import numpy as np


def integer_factorize(n: int) -> Tuple[int, int]:
    """Near-square factorization n = a*b, a <= b (reference:
    tiling.hpp:65-73)."""
    a = b = int(math.isqrt(n))
    while a * b != n:
        b += 1
        a = n // b
    return a, b


@dataclass(frozen=True, eq=False)
class Mesh:
    """The R x C mesh as seen from one rank (see the module docstring)."""

    R: int
    C: int
    shard: int          # this rank's shard, b = i*C + j (= its rank)
    backend: str        # the process group's backend: 'gloo' or 'nccl'
    xgroup: Any         # ranks {i*C + j : i}, ascending (JAX 'rows')
    ygroup: Any         # ranks {i*C + k : k}, ascending (JAX 'cols')
    host_group: Any     # gloo group over every rank of the mesh
    world: Any          # the default group: the convergence vote

    @property
    def D(self) -> int:
        return self.R * self.C

    @property
    def shape(self) -> Tuple[int, int]:
        return self.R, self.C


def make_mesh(shape: Optional[Tuple[int, int]] = None) -> Mesh:
    """The mesh over the initialized default process group, one rank per
    shard; ``shape`` (R, C), else the world size's near-square
    factorization. Every rank must call it, in the same order as its
    other group creations (``dist.new_group`` is collective)."""
    import torch.distributed as dist
    if not dist.is_initialized():
        raise ValueError("make_mesh: no process group; without one the "
                         "layout is 1x1 (mesh=None)")
    world, rank = dist.get_world_size(), dist.get_rank()
    R, C = shape if shape is not None else integer_factorize(world)
    if R * C != world:
        raise ValueError(f"mesh shape {(R, C)} != {world} ranks")
    backend = dist.get_backend()
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"process group backend {backend!r}: the mesh "
                         f"runs on gloo or nccl")
    i, j = divmod(rank, C)
    xgroup = ygroup = None
    for jj in range(C):
        g = dist.new_group([ii * C + jj for ii in range(R)])
        if jj == j:
            xgroup = g
    for ii in range(R):
        g = dist.new_group([ii * C + kk for kk in range(C)])
        if ii == i:
            ygroup = g
    host = dist.group.WORLD if backend == "gloo" \
        else dist.new_group(backend="gloo")
    return Mesh(R=R, C=C, shard=rank, backend=backend, xgroup=xgroup,
                ygroup=ygroup, host_group=host, world=dist.group.WORLD)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass(frozen=True)
class Partition:
    """Static description of the vertex/tile partition for one mesh
    shape."""

    nv: int        # logical vertex count (num_vertices + 1, for vertex id 0)
    R: int         # mesh rows
    C: int         # mesh cols
    L: int         # segment length (padded)

    @classmethod
    def build(cls, nv: int, R: int = 1, C: int = 1,
              segment_align: int = 1024) -> "Partition":
        D = R * C
        L = _round_up(max(1, -(-nv // D)), segment_align)
        return cls(nv=nv, R=R, C=C, L=L)

    # -- sizes ------------------------------------------------------------
    @property
    def D(self) -> int:
        return self.R * self.C

    @property
    def n_pad(self) -> int:
        return self.D * self.L

    @property
    def tile_rows(self) -> int:
        """Local row-block length per device (C segments)."""
        return self.C * self.L

    @property
    def tile_cols(self) -> int:
        """Local column-block length per device (R segments)."""
        return self.R * self.L

    # -- shard <-> segment maps ------------------------------------------
    def seg_of_shard(self, b: int) -> int:
        """Vertex segment owned by mesh shard b (row-major device order)."""
        i, j = divmod(b, self.C)
        return j * self.R + i

    def shard_of_seg(self, s: int) -> int:
        j, i = divmod(s, self.R)
        return i * self.C + j

    def shard_perm(self) -> np.ndarray:
        """perm[b] = segment owned by shard b."""
        return np.array([self.seg_of_shard(b) for b in range(self.D)],
                        dtype=np.int64)

    # -- edge -> device assignment (host-side, vectorized) ----------------
    def edge_device(self, r: np.ndarray, c: np.ndarray) -> np.ndarray:
        """Mesh shard index b = i*C + j for each edge (r, c)."""
        i = (r // self.L) % self.R
        j = (c // self.L) // self.R
        return i * self.C + j

    def local_row(self, r: np.ndarray) -> np.ndarray:
        """Row index within the owning device's row-block (length C*L)."""
        return ((r // self.L) // self.R) * self.L + (r % self.L)

    def local_col(self, c: np.ndarray) -> np.ndarray:
        """Col index within the owning device's gathered x block (length R*L)."""
        seg = c // self.L
        j = seg // self.R
        return c - j * self.R * self.L

    def global_row(self, i: int, lr: np.ndarray) -> np.ndarray:
        """Inverse of local_row for mesh row i."""
        k = lr // self.L
        return (k * self.R + i) * self.L + (lr % self.L)

    def global_col(self, j: int, lc: np.ndarray) -> np.ndarray:
        return j * self.R * self.L + lc

    # -- vector layout conversions (host-side) ----------------------------
    def to_vertex_order(self, arr_shards: np.ndarray) -> np.ndarray:
        """(D, L, ...) shard-order array -> (n_pad, ...) in vertex-id order."""
        out = np.empty((self.n_pad,) + arr_shards.shape[2:],
                       dtype=arr_shards.dtype)
        for b in range(self.D):
            s = self.seg_of_shard(b)
            out[s * self.L:(s + 1) * self.L] = arr_shards[b]
        return out

    def from_vertex_order(self, vec: np.ndarray) -> np.ndarray:
        """(n_pad, ...) vertex-order array -> (D, L, ...) shard-order."""
        out = np.empty((self.D, self.L) + vec.shape[1:], dtype=vec.dtype)
        for b in range(self.D):
            s = self.seg_of_shard(b)
            out[b] = vec[s * self.L:(s + 1) * self.L]
        return out

    def owner_vids(self) -> np.ndarray:
        """(D, L) global vertex id held at each shard-local slot."""
        vids = np.empty((self.D, self.L), dtype=np.int32)
        for b in range(self.D):
            s = self.seg_of_shard(b)
            vids[b] = np.arange(s * self.L, (s + 1) * self.L, dtype=np.int32)
        return vids
