"""Graph: host-side container tying ingest, partitioning and tiling.

Counterpart of ``graphtap_tpu/ingest/graph.py`` without a mesh: the port
runs on one device, so the partition is 1x1. ``load`` reads an edge-list
file (binary or text, ``ingest/io.py``) in one process; ``from_edges``
takes an in-memory list. ``tiled(ordering)`` builds the host ``TileSet``
for the ROW ordering (the stored matrix) or the COL ordering (its
transpose, the degree phase of PageRank, pr.cpp:41-47); ``tiled_cf`` the
TCSC_CF phase tilesets. Both are a pure function of the stored edges and
the config, so each is built once per ordering and kept on the Graph (a
PageRank builds its tiles for the degree phase, the main run and the CF
phases; at RMAT-20 one tileset takes seconds, the CF set about a minute).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np

from graphtap_tpu_torch.config import Compression, GraphConfig, Ordering
from graphtap_tpu_torch.format.tiles import (TileSet, build_cf_tilesets,
                                             build_tileset)
from graphtap_tpu_torch.ingest.io import apply_transforms, read_edge_list
from graphtap_tpu_torch.parallel.layout import Partition


@dataclass
class Graph:
    config: GraphConfig
    part: Partition
    # transformed (stored-orientation) edges, host-side
    r: np.ndarray
    c: np.ndarray
    w: Optional[np.ndarray]
    # built tilesets: (ordering, compression or "cf") -> TileSet / CF dict
    _tiles: Dict = field(default_factory=dict, repr=False, compare=False)

    @property
    def nv(self) -> int:
        """Logical matrix dimension: num_vertices + 1, for vertex id 0
        (reference: graph.hpp:84-85)."""
        return self.config.num_vertices + 1

    @property
    def nedges(self) -> int:
        return int(self.r.size)

    @classmethod
    def load(cls, path: str, config: GraphConfig) -> "Graph":
        """Read an edge-list file (reference: Graph::load, graph.hpp:104-372)
        in one process, then apply the config's read-time transforms."""
        r, c, w = read_edge_list(path, has_weight=config.has_weight)
        return cls.from_edges(r, c, w, config)

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

    def _oriented(self, ordering: Ordering):
        if ordering == Ordering.COL:
            return self.c, self.r
        return self.r, self.c

    def tiled(self, ordering: Ordering = Ordering.ROW,
              compression: Optional[Compression] = None) -> TileSet:
        """The TileSet of the stored matrix (ROW) or its transpose (COL)."""
        comp = compression or self.config.compression
        if (ordering, comp) not in self._tiles:
            r, c = self._oriented(ordering)
            self._tiles[ordering, comp] = build_tileset(
                r, c, self.w, self.part, compression=comp,
                parallel_edges=self.config.parallel_edges,
                edge_align=self.config.edge_align)
        return self._tiles[ordering, comp]

    def tiled_cf(self, ordering: Ordering = Ordering.ROW) -> dict:
        """The TCSC_CF phase tilesets (full/first/middle/last) of the
        stored matrix (ROW) or its transpose (COL) (reference:
        compressed_column.hpp:606-1120)."""
        if (ordering, "cf") not in self._tiles:
            r, c = self._oriented(ordering)
            self._tiles[ordering, "cf"] = build_cf_tilesets(
                r, c, self.w, self.part,
                parallel_edges=self.config.parallel_edges,
                edge_align=self.config.edge_align)
        return self._tiles[ordering, "cf"]
