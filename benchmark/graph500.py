"""The yardstick's graph: Graph500's Kronecker generator, the read-time
transforms a configuration states, and the counts taken from the edges.

``kronecker_edges`` is a frozen copy of the generator the port ships
(``graphtap_tpu_torch/ingest/rmat.py``, Graph500 spec v3 section 3: A, B,
C = 0.57, 0.19, 0.19, no vertex-label permutation), kept here so that a
change to the program cannot change the benchmark's inputs. It draws its
uniforms from any source: a run draws them on the card from the seed
(``uniforms``), in a few large calls; a test draws them from NumPy's
generator of the seed and holds the edges equal to the port's. Everything
here works on plain torch tensors and imports nothing of the program.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

RESULT_BYTES = 4     # a 32-bit index, message, result or state field

Uniforms = Callable[[int], torch.Tensor]


def rng_seed(seed: int) -> int:
    """A non-negative generator seed for any whole ``--seed``."""
    return int(seed) % (1 << 63)


def uniforms(seed: int, device) -> Uniforms:
    """``n`` -> ``n`` float64 uniforms in [0, 1) on ``device``, the next
    ones of one generator of ``seed``."""
    g = torch.Generator(device=device)
    g.manual_seed(rng_seed(seed))
    return lambda n: torch.rand(n, generator=g, device=device,
                                dtype=torch.float64)


def kronecker_edges(scale: int, edge_factor: int, a: float, b: float,
                    c: float, draw: Uniforms
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``edge_factor * 2**scale`` raw (row, col) int64 edges of the
    Kronecker graph, two uniforms an edge a bit, taken from ``draw``: bit
    for bit the port's ``rmat_edges`` when ``draw`` is its NumPy
    generator."""
    n_edges = edge_factor << scale
    ab = a + b
    a_norm = a / ab if ab > 0 else 0.5
    c_norm = c / (1.0 - ab) if ab < 1 else 0.5
    r = col = south_p = east_p = None
    for bit in range(scale):
        go_south = draw(n_edges) >= ab
        if r is None:
            dev = go_south.device
            r = torch.zeros(n_edges, dtype=torch.int64, device=dev)
            col = torch.zeros_like(r)
            south_p, east_p = (torch.tensor(p, dtype=torch.float64,
                                            device=dev)
                               for p in (c_norm, a_norm))
        p_east = torch.where(go_south, south_p, east_p)
        go_east = draw(n_edges) >= p_east
        r |= go_south.long() << bit
        col |= go_east.long() << bit
    return r, col


def stored_edges(r, c, graph: Dict) -> Tuple[torch.Tensor, torch.Tensor]:
    """The stored matrix's (row, col) int64 edges: the raw edges under the
    configuration's read-time transforms, in the reference's order
    (self-loop filter, acyclic swap, transpose, undirected mirror), then
    parallel edges dropped, sorted by (row, col), where
    ``parallel_edges`` is false. A stored edge (i, j) adds column j's
    message into row i."""
    r, c = torch.as_tensor(r).long(), torch.as_tensor(c).long()
    if not graph.get("self_loops", True):
        keep = r != c
        r, c = r[keep], c[keep]
    if graph.get("acyclic", False):
        r, c = torch.minimum(r, c), torch.maximum(r, c)
    if graph.get("transpose", False):
        r, c = c, r
    if not graph.get("directed", True):
        r, c = torch.cat([r, c]), torch.cat([c, r])
    if not graph.get("parallel_edges", True):
        key = torch.unique(r << 32 | c)
        r, c = key >> 32, key & 0xFFFFFFFF
    return r, c


def nonempty_rows(rows, nv: int) -> torch.Tensor:
    """The vertices whose stored row holds an edge, ascending."""
    return torch.nonzero(torch.bincount(torch.as_tensor(rows),
                                        minlength=nv)).flatten()


def min_superstep_bytes(rows, cols, nv: int, state_fields: int) -> int:
    """The least bytes one superstep of a vertex program must move,
    whatever implements it: each stored edge's source index read once,
    the message of each non-empty column read once, the result of each
    non-empty row written once, and every state field of every vertex
    read and written once, each 4 bytes."""
    rows, cols = torch.as_tensor(rows), torch.as_tensor(cols)
    ncols = int(torch.count_nonzero(torch.bincount(cols, minlength=nv)))
    nrows = int(torch.count_nonzero(torch.bincount(rows, minlength=nv)))
    return RESULT_BYTES * (rows.numel() + ncols + nrows
                           + 2 * state_fields * nv)
