"""Configuration dataclasses.

The reference configures everything through compile-time macros and per-app
hardcoded booleans (reference: src/apps/pr.cpp:26-40, cc.cpp:25-43,
Makefile:27-28). Here the same ~12 knobs are a pair of frozen dataclasses.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Optional


class Compression(enum.Enum):
    """Tile compression format (reference: src/ds/compressed_column.hpp:17-23)."""

    CSC = "csc"            # plain CSC per tile
    DCSC = "dcsc"          # doubly compressed: JC nnz-col indirection
    TCSC = "tcsc"          # triply compressed: renumbered nnz rows + nnz cols
    TCSC_CF = "tcsc_cf"    # TCSC + computation filtering (regular/source/sink)

    # DCSC (reference: compressed_column.hpp:156-271) is implemented in its
    # reference shape — column ids renumbered to compact nnz-col space and
    # x gathered through the JC table (dcsc_spmv.hpp:216-230) — for the
    # kernel lab's cross-format invariant. It is NOT the recommended
    # distributed format here: the JC indirection compresses the per-tile x
    # working set, which on the TPU layout is a property of the exchange
    # (the sparse activity-filtered path in engine/executor.py), so the
    # extra gather buys nothing the exchange doesn't already (measured in
    # docs/PARITY.md §2.2). Likewise the _2D_/_2DT_ rank layouts
    # (tiling.hpp:13-16) collapse into the single mesh-aligned layout of
    # parallel/layout.py.


class Ordering(enum.Enum):
    """Row vs column ordering (reference: vertex_program.hpp:279-325).

    _COL_ runs the engine on the transpose of the loaded matrix without
    re-loading (used by the PageRank degree phase, pr.cpp:41).
    """

    ROW = "row"
    COL = "col"


@dataclass(frozen=True)
class GraphConfig:
    """Ingest-time knobs (reference: Graph::load signature, graph.hpp:41-43)."""

    num_vertices: int                  # logical vertex count; matrix is (n+1)^2
    directed: bool = True              # if False, mirror each edge
    transpose: bool = False            # swap (row, col) at read time
    self_loops: bool = True            # True = KEEP self loops (as reference)
    acyclic: bool = False              # force row < col by swapping
    parallel_edges: bool = True        # True = KEEP parallel edges
    has_weight: bool = False           # edge stream carries a u32 weight
    compression: Compression = Compression.TCSC
    # TPU-specific: segment alignment for padded static shapes. Each of the
    # D = R*C vertex segments is padded to a multiple of this.
    segment_align: int = 1024
    # Edge padding alignment per device tile.
    edge_align: int = 1024


@dataclass(frozen=True)
class EngineConfig:
    """Engine-mode knobs (reference: vertex_program.hpp:27-29 and app mains)."""

    stationary: bool = True
    gather_depends_on_apply: bool = False
    apply_depends_on_iter: bool = False
    ordering: Ordering = Ordering.ROW
    # Number of iterations; 0 => run to convergence
    # (reference: execute(), vertex_program.hpp:407-441).
    num_iterations: int = 0
    # Activity-filtered exchange (reference: scatter_nonstationary /
    # gather_nonstationary, vertex_program.hpp:865-966): when every
    # column-group sender's active count fits in this static capacity,
    # the superstep exchanges (index, value) pairs of the K most-active
    # slots instead of the dense (L,) message vector — the reference's
    # "≤ 0.6 active fraction → sparse" protocol with the ratio replaced
    # by a static capacity (XLA needs fixed shapes). 0 disables (dense
    # exchange always). Worth enabling only when the gather crosses DCN;
    # on single-slice ICI the dense path is faster (the rebuild scatter
    # costs more than the bandwidth saved).
    sparse_exchange_capacity: int = 0
