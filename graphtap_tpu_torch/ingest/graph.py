"""Graph: host-side container tying ingest, partitioning and tiling.

Counterpart of ``graphtap_tpu/ingest/graph.py``. ``load`` reads an
edge-list file (binary or text, ``ingest/io.py``); on a mesh of D > 1
ranks each rank reads its 1/D byte range and the shares are exchanged so
that each rank ends with exactly its shard's edges (reference: parread_*,
graph.hpp:234-240, and Matrix::distribute, matrix.hpp:692-810;
``parallel/multihost.py::exchange_edges``). ``from_edges`` takes an
in-memory list and keeps every edge on every rank, as the JAX package's
does. Without a mesh the partition is 1x1. ``tiled(ordering)`` builds the
host ``TileSet`` for the ROW ordering (the stored matrix) or the COL
ordering (its transpose, the degree phase of PageRank, pr.cpp:41-47);
``tiled_cf`` the TCSC_CF phase tilesets; on a mesh both reduce their
masks and counts across the ranks (``format/tiles.py``), so every rank
holds the (D, ...) tiles of the JAX multi-process layout, its own row
filled. Both are a pure function of the stored edges and the config, so
each is built once per ordering and kept on the Graph (a PageRank builds
its tiles for the degree phase and the main run, and takes the CF phases
from the main run's; at RMAT-20 one tileset takes seconds).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np

from graphtap_tpu_torch.config import Compression, GraphConfig, Ordering
from graphtap_tpu_torch.format.tiles import (SortedEdges, TileSet,
                                             build_cf_subsets,
                                             build_tileset_sorted)
from graphtap_tpu_torch.ingest.io import apply_transforms, read_edge_list
from graphtap_tpu_torch.parallel import multihost
from graphtap_tpu_torch.parallel.layout import Mesh, Partition
from graphtap_tpu_torch.tools import timing


@dataclass
class Graph:
    config: GraphConfig
    part: Partition
    # transformed (stored-orientation) edges, host-side
    r: np.ndarray
    c: np.ndarray
    w: Optional[np.ndarray]
    mesh: Optional[Mesh] = None
    # built tilesets: (ordering, compression or "cf") -> TileSet / CF dict
    _tiles: Dict = field(default_factory=dict, repr=False, compare=False)
    # a TCSC_CF build's sorted edges, by ordering, until ``tiled_cf``
    # takes the phases from them
    _cf_sorted: Dict[Ordering, SortedEdges] = field(
        default_factory=dict, repr=False, compare=False)

    @property
    def nv(self) -> int:
        """Logical matrix dimension: num_vertices + 1, for vertex id 0
        (reference: graph.hpp:84-85)."""
        return self.config.num_vertices + 1

    @property
    def nedges(self) -> int:
        return int(self.r.size)

    @classmethod
    def load(cls, path: str, config: GraphConfig,
             mesh: Optional[Mesh] = None) -> "Graph":
        """Read an edge-list file (reference: Graph::load,
        graph.hpp:104-372), then apply the config's read-time transforms;
        on a mesh, this rank's byte range, then the exchange."""
        d = 1 if mesh is None else mesh.D
        r, c, w = read_edge_list(path, has_weight=config.has_weight,
                                 process_index=0 if d == 1 else mesh.shard,
                                 process_count=d)
        return cls._from_raw(r, c, w, config, mesh, distributed=d > 1)

    @classmethod
    def from_edges(cls, r, c, w, config: GraphConfig,
                   mesh: Optional[Mesh] = None) -> "Graph":
        """Build from an in-memory raw edge list (e.g. the RMAT generator),
        applying the config's read-time transforms; every rank keeps every
        edge."""
        return cls._from_raw(np.asarray(r), np.asarray(c),
                             None if w is None else np.asarray(w), config,
                             mesh)

    @classmethod
    def _from_raw(cls, r, c, w, config: GraphConfig, mesh: Optional[Mesh],
                  distributed: bool = False) -> "Graph":
        r, c, w = apply_transforms(
            r, c, w, directed=config.directed, transpose=config.transpose,
            self_loops=config.self_loops, acyclic=config.acyclic)
        nv = config.num_vertices + 1
        if r.size and max(int(r.max()), int(c.max())) >= nv:
            raise ValueError("edge endpoint exceeds num_vertices")
        R, C = (1, 1) if mesh is None else mesh.shape
        part = Partition.build(nv, R, C, segment_align=config.segment_align)
        if distributed:
            r, c, w = multihost.exchange_edges(r, c, w, part, mesh)
        return cls(config=config, part=part, r=r, c=c, w=w, mesh=mesh)

    def _oriented(self, ordering: Ordering):
        """(rows, cols, weights) of the matrix tiled in ``ordering``; on a
        mesh only the edges of this rank's tile (the others are another
        rank's, and the tile build reduces across the ranks)."""
        r, c = (self.c, self.r) if ordering == Ordering.COL \
            else (self.r, self.c)
        if self.mesh is None or self.mesh.D == 1:
            return r, c, self.w
        mine = multihost.host_edge_share(r, c, self.part, self.mesh.shard)
        return r[mine], c[mine], None if self.w is None else self.w[mine]

    @property
    def _weight_dtype(self):
        """The tiles' weight type: the weights' own where they are
        floats (Graph500's uniform weights), else int32 (the reference's
        u32 weights, as the JAX package tiles them)."""
        if self.w is not None and np.issubdtype(self.w.dtype, np.floating):
            return self.w.dtype
        return np.int32

    def tiled(self, ordering: Ordering = Ordering.ROW,
              compression: Optional[Compression] = None) -> TileSet:
        """The TileSet of the stored matrix (ROW) or its transpose (COL);
        a build is a ``tiles`` span in the open tracer. The Graph keeps a
        TCSC_CF build's sorted edges until ``tiled_cf`` takes its phases
        (an ordering that never runs them, as the degree phase's COL,
        keeps them with the graph)."""
        comp = compression or self.config.compression
        if (ordering, comp) not in self._tiles:
            with timing.span("tiles", ordering=ordering.name):
                r, c, w = self._oriented(ordering)
                ts, srt = build_tileset_sorted(
                    r, c, w, self.part, compression=comp,
                    parallel_edges=self.config.parallel_edges,
                    edge_align=self.config.edge_align,
                    weight_dtype=self._weight_dtype, mesh=self.mesh)
            self._tiles[ordering, comp] = ts
            if srt is not None:
                self._cf_sorted[ordering] = srt
        return self._tiles[ordering, comp]

    def tiled_cf(self, ordering: Ordering = Ordering.ROW) -> dict:
        """The TCSC_CF phase tilesets (full/first/middle/last) of the
        stored matrix (ROW) or its transpose (COL) (reference:
        compressed_column.hpp:606-1120): "full" is ``tiled(ordering,
        TCSC_CF)`` itself, and the three phases are taken from its sorted
        edges (``format/tiles.py::build_cf_subsets``), which the Graph
        then lets go."""
        if (ordering, "cf") not in self._tiles:
            full = self.tiled(ordering, Compression.TCSC_CF)
            with timing.span("tiles", ordering=ordering.name, cf=True):
                r, c, _ = self._oriented(ordering)
                phases = build_cf_subsets(
                    full, self._cf_sorted.pop(ordering), r, c,
                    edge_align=self.config.edge_align,
                    weight_dtype=self._weight_dtype)
            self._tiles[ordering, "cf"] = {"full": full, **phases}
        return self._tiles[ordering, "cf"]
