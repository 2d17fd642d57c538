"""Graph: host-side container tying ingest, partitioning and tiling.

Counterpart of ``graphtap_tpu/ingest/graph.py`` without a mesh: the port
runs on one device, so the partition is 1x1. ``tiled(ordering)`` builds
the host ``TileSet`` for the ROW ordering (the stored matrix) or the COL
ordering (its transpose, the degree phase of PageRank, pr.cpp:41-47).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from graphtap_tpu_torch.config import Compression, GraphConfig, Ordering
from graphtap_tpu_torch.format.tiles import TileSet, build_tileset
from graphtap_tpu_torch.ingest.io import apply_transforms
from graphtap_tpu_torch.parallel.layout import Partition


@dataclass
class Graph:
    config: GraphConfig
    part: Partition
    # transformed (stored-orientation) edges, host-side
    r: np.ndarray
    c: np.ndarray
    w: Optional[np.ndarray]

    @property
    def nv(self) -> int:
        """Logical matrix dimension: num_vertices + 1, for vertex id 0
        (reference: graph.hpp:84-85)."""
        return self.config.num_vertices + 1

    @property
    def nedges(self) -> int:
        return int(self.r.size)

    @classmethod
    def from_edges(cls, r, c, w, config: GraphConfig) -> "Graph":
        """Build from an in-memory raw edge list (e.g. the RMAT generator),
        applying the config's read-time transforms."""
        r, c, w = apply_transforms(
            np.asarray(r), np.asarray(c), None if w is None else np.asarray(w),
            directed=config.directed, transpose=config.transpose,
            self_loops=config.self_loops, acyclic=config.acyclic)
        nv = config.num_vertices + 1
        if r.size and max(int(r.max()), int(c.max())) >= nv:
            raise ValueError("edge endpoint exceeds num_vertices")
        part = Partition.build(nv, 1, 1, segment_align=config.segment_align)
        return cls(config=config, part=part, r=r, c=c, w=w)

    def tiled(self, ordering: Ordering = Ordering.ROW,
              compression: Optional[Compression] = None) -> TileSet:
        """The TileSet of the stored matrix (ROW) or its transpose (COL)."""
        comp = compression or self.config.compression
        if ordering == Ordering.COL:
            r, c = self.c, self.r
        else:
            r, c = self.r, self.c
        return build_tileset(
            r, c, self.w, self.part, compression=comp,
            parallel_edges=self.config.parallel_edges,
            edge_align=self.config.edge_align)
