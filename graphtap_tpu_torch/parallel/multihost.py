"""Multi-process runtime on ``torch.distributed``: init, distributed
ingest, host-side reductions, state gathers.

Counterpart of ``graphtap_tpu/parallel/multihost.py``. The reference
scales across nodes with ``mpirun`` + MPI_COMM_WORLD (reference:
src/mpi/env.hpp:77-93); the port runs one rank per mesh shard (rank =
shard, ``parallel/layout.py::Mesh``):

  initialize()          ``dist.init_process_group`` (from the arguments or
                        the RANK/WORLD_SIZE/MASTER_* environment a
                        launcher sets, ``parallel/launch.py``), with a
                        timeout so that a lost rank fails the others
  host_edge_share()     the edges whose tile is this rank's shard
  exchange_edges()      byte-range shares -> each rank's own edges, an
                        all-gather + select in bounded rounds, with the
                        edge-count conservation check (graph.hpp:299-300)
  global_or() / global_max() / global_sum()
                        the filtering and count reductions of tiling and
                        planning (the leader OR-combine, matrix.hpp:990-1006)
  allgather_state()     every shard's state row on every rank (the master
                        gather of checksum1, vertex_program.hpp:1963-2119)

Host reductions run on the mesh's gloo group (``Mesh.host_group``), on
CPU tensors, whatever the exchange's backend. Every rank must call them
in the same order (they are collectives). Without a mesh (``mesh=None``)
or on one rank they are the identity.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional, Tuple

import numpy as np
import torch

from graphtap_tpu_torch.parallel.layout import Mesh, Partition

# seconds a collective waits for the other ranks before it fails
TIMEOUT_S = 600
EXCHANGE_CHUNK = 1 << 22   # edges per all-gather round (bounds peak memory)


def initialize(backend: Optional[str] = None,
               init_method: Optional[str] = None,
               rank: Optional[int] = None,
               world: Optional[int] = None) -> Tuple[int, int]:
    """Initialize the default process group; returns (rank, world).

    The arguments default to the launcher's environment (RANK,
    WORLD_SIZE, MASTER_ADDR, MASTER_PORT: ``init_method="env://"``);
    without either there is nothing to join, and (0, 1) is returned with
    no group (the 1x1 layout). ``backend``: 'gloo' (CPU tensors, or CUDA
    tensors staged through the host) or 'nccl'; default gloo. The analog
    of Env::init (env.hpp:77-93)."""
    import torch.distributed as dist
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    if world is None and "WORLD_SIZE" not in os.environ:
        return 0, 1
    rank = int(os.environ["RANK"]) if rank is None else rank
    world = int(os.environ["WORLD_SIZE"]) if world is None else world
    dist.init_process_group(
        backend=backend or "gloo", init_method=init_method or "env://",
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=TIMEOUT_S))
    return rank, world


def _active(mesh: Optional[Mesh]) -> bool:
    return mesh is not None and mesh.D > 1


def shard_of(part: Partition, mesh: Optional[Mesh]) -> int:
    """The shard this process holds of a ``part`` layout: the mesh's, or
    0 without one. A D > 1 partition needs a mesh of D ranks."""
    if mesh is None:
        if part.D != 1:
            raise ValueError(f"a {part.R}x{part.C} partition needs a mesh "
                             f"of {part.D} ranks; there is none")
        return 0
    if mesh.shape != (part.R, part.C):
        raise ValueError(f"partition {part.R}x{part.C} on a "
                         f"{mesh.R}x{mesh.C} mesh")
    return mesh.shard


def host_edge_share(r: np.ndarray, c: np.ndarray, part: Partition,
                    shard: int) -> np.ndarray:
    """Boolean mask of the edges whose tile is shard ``shard`` (the
    destination routing of Matrix::distribute, matrix.hpp:692-810, done by
    selection)."""
    return part.edge_device(r, c) == shard


def _allgather_host(x: np.ndarray, mesh: Mesh) -> np.ndarray:
    """(D, ...) stack of every rank's ``x`` (same shape and dtype on every
    rank), in rank order."""
    import torch.distributed as dist
    t = torch.from_numpy(np.ascontiguousarray(x))
    out = torch.empty(mesh.D * t.numel(), dtype=t.dtype)
    dist.all_gather_into_tensor(out, t.reshape(-1), group=mesh.host_group)
    return out.numpy().reshape((mesh.D,) + tuple(t.shape))


def _allreduce_host(x: np.ndarray, op, mesh: Mesh) -> np.ndarray:
    import torch.distributed as dist
    t = torch.from_numpy(np.array(x, copy=True))
    dist.all_reduce(t, op=op, group=mesh.host_group)
    return t.numpy()


def global_or(mask: np.ndarray, mesh: Optional[Mesh] = None) -> np.ndarray:
    """OR-reduce a boolean array across the mesh's ranks (the leader
    bitvector OR-combine, matrix.hpp:990-1006)."""
    if not _active(mesh):
        return mask
    import torch.distributed as dist
    return _allreduce_host(np.asarray(mask).astype(np.uint8),
                           dist.ReduceOp.MAX, mesh).astype(bool)


def global_max(x, mesh: Optional[Mesh] = None) -> np.ndarray:
    """Element-wise max across the mesh's ranks (int64 on the wire)."""
    x = np.asarray(x)
    if not _active(mesh):
        return x
    import torch.distributed as dist
    return _allreduce_host(x.astype(np.int64), dist.ReduceOp.MAX,
                           mesh).astype(x.dtype)


def global_sum(x, mesh: Optional[Mesh] = None) -> np.ndarray:
    """Element-wise sum across the mesh's ranks (int64 on the wire)."""
    x = np.asarray(x)
    if not _active(mesh):
        return x
    import torch.distributed as dist
    return _allreduce_host(x.astype(np.int64), dist.ReduceOp.SUM,
                           mesh).astype(x.dtype)


def exchange_edges(r: np.ndarray, c: np.ndarray, w: Optional[np.ndarray],
                   part: Partition, mesh: Optional[Mesh]):
    """From per-rank byte-range shares to per-rank ownership: all-gather
    every rank's share and keep the edges of this rank's tiles, in either
    ordering: an edge (r, c) whose tile is this shard's in the stored
    matrix (ROW) or in its transpose (COL, where it is (c, r)), since one
    graph is tiled in both (PageRank's degree phase runs on COL). The JAX
    package keeps the ROW owner's edges only. One-time ingest cost
    (reference: the triple all-to-all, matrix.hpp:692-810). The gather
    runs in EXCHANGE_CHUNK-edge rounds so peak memory is O(D * chunk);
    the edge count must be conserved (graph.hpp:299-300), else
    RuntimeError."""
    if not _active(mesh):
        return r, c, w
    counts = _allgather_host(np.array([r.size], np.int64), mesh)[:, 0]
    cap, total = int(counts.max()), int(counts.sum())
    keep_r, keep_c, keep_w = [], [], []
    n_seen = 0
    for lo in range(0, cap, EXCHANGE_CHUNK):
        hi = min(cap, lo + EXCHANGE_CHUNK)

        def gather(a, dtype):
            out = np.zeros(hi - lo, dtype=dtype)
            seg = a[lo:hi]
            out[:seg.size] = seg
            return _allgather_host(out, mesh)

        keepv = np.concatenate([np.arange(lo, hi) < n for n in counts])
        rr = gather(r, np.int64).reshape(-1)[keepv]
        cc = gather(c, np.int64).reshape(-1)[keepv]
        n_seen += rr.size
        mine = host_edge_share(rr, cc, part, mesh.shard) \
            | host_edge_share(cc, rr, part, mesh.shard)
        keep_r.append(rr[mine])
        keep_c.append(cc[mine])
        if w is not None:
            keep_w.append(gather(w, w.dtype).reshape(-1)[keepv][mine])
    if n_seen != total:
        raise RuntimeError(f"edge count not conserved across the exchange: "
                           f"{n_seen} seen, {total} read")
    rr = np.concatenate(keep_r) if keep_r else r[:0]
    cc = np.concatenate(keep_c) if keep_c else c[:0]
    ww = None if w is None else (np.concatenate(keep_w) if keep_w
                                 else w[:0])
    return rr, cc, ww


def barrier(mesh: Optional[Mesh] = None) -> None:
    """Wait until every rank of the mesh arrives (no-op without one)."""
    if _active(mesh):
        import torch.distributed as dist
        dist.barrier(group=mesh.host_group)


def allgather_state(v: torch.Tensor, mesh: Optional[Mesh] = None
                    ) -> np.ndarray:
    """Every shard's row of a state vector, stacked in shard order: the
    rank's (L, ...) tensor -> (D, L, ...) numpy on every rank (on one rank,
    its own row under a leading axis of 1). Gathered on the host group."""
    a = v.detach().cpu().numpy()
    if not _active(mesh):
        return a[None]
    if a.dtype == bool:
        return _allgather_host(a.astype(np.uint8), mesh).astype(bool)
    return _allgather_host(a, mesh)
