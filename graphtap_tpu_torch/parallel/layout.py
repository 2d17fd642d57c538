"""The vertex and tile partition, without a device mesh.

Counterpart of ``graphtap_tpu/parallel/layout.py::Partition``: the same
segment arithmetic, so the port's tiles and plans are byte-identical to
the JAX package's. The port runs on one device, so only the 1x1 layout
(R = C = 1) is accepted; the mesh layouts wait for the port's
``torch.distributed`` exchange.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass(frozen=True)
class Partition:
    """Static description of the vertex/tile partition."""

    nv: int        # logical vertex count (num_vertices + 1, for vertex id 0)
    R: int         # mesh rows
    C: int         # mesh cols
    L: int         # segment length (padded)

    def __post_init__(self):
        if (self.R, self.C) != (1, 1):
            raise NotImplementedError(
                f"mesh {self.R}x{self.C}: the torch port runs on one "
                f"device (1x1) only")

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
        i, j = divmod(b, self.C)
        return j * self.R + i

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

    # -- vector layout conversions (host-side) ----------------------------
    def to_vertex_order(self, arr_shards: np.ndarray) -> np.ndarray:
        """(D, L, ...) shard-order array -> (n_pad, ...) in vertex-id order."""
        out = np.empty((self.n_pad,) + arr_shards.shape[2:],
                       dtype=arr_shards.dtype)
        for b in range(self.D):
            s = self.seg_of_shard(b)
            out[s * self.L:(s + 1) * self.L] = arr_shards[b]
        return out

    def owner_vids(self) -> np.ndarray:
        """(D, L) global vertex id held at each shard-local slot."""
        vids = np.empty((self.D, self.L), dtype=np.int32)
        for b in range(self.D):
            s = self.seg_of_shard(b)
            vids[b] = np.arange(s * self.L, (s + 1) * self.L, dtype=np.int32)
        return vids
