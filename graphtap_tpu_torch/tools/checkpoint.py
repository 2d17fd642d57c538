"""Checkpoint / resume for long executions.

Counterpart of ``graphtap_tpu/tools/checkpoint.py``. The reference has no
persistence (results are printed, never written); this snapshots an
executor's vertex state, its changed bitmap and iteration counter, and
restores them into a freshly built Executor over the same graph (the
graph itself is rebuilt from the edge list, deterministically).

Format: one ``.npz`` per checkpoint (host numpy), one (D, L) array per
state leaf (every shard's row, in shard order) plus ``__changed__`` and
a JSON ``__meta__`` (iteration, nv, the program, the mesh shape). On a
mesh every rank must call both: ``save_state`` gathers the rows and rank
0 writes the file; ``load_state`` checks the mesh shape, as the JAX
package's does, and each rank takes its own row.
"""

from __future__ import annotations

import json
from typing import TYPE_CHECKING

import numpy as np
import torch

from graphtap_tpu_torch.parallel import multihost as mh

if TYPE_CHECKING:  # pragma: no cover
    from graphtap_tpu_torch.engine.executor import Executor

_META_KEY = "__meta__"
_CHANGED_KEY = "__changed__"


def _mesh_shape(ex: "Executor") -> list:
    return [ex.part.R, ex.part.C]


def save_state(ex: "Executor", path: str) -> None:
    """Snapshot an executor's iteration state to ``path`` (.npz)."""
    if ex.state is None:
        raise ValueError("executor has no state; call initialize() first")
    if any(k.startswith("__") for k in ex.state):
        raise ValueError("state keys must not start with '__'")
    arrays = {k: mh.allgather_state(v, ex.mesh) for k, v in ex.state.items()}
    arrays[_CHANGED_KEY] = mh.allgather_state(ex.changed, ex.mesh)
    meta = {
        "iteration": ex.iteration,
        "nv": ex.graph.nv,
        "program": type(ex.program).__name__,
        "mesh": _mesh_shape(ex),
    }
    arrays[_META_KEY] = np.frombuffer(json.dumps(meta).encode(),
                                      dtype=np.uint8)
    if ex.shard == 0:
        np.savez(path, **arrays)
    mh.barrier(ex.mesh)


def load_state(ex: "Executor", path: str) -> int:
    """Restore a snapshot into ``ex`` (its arrays on the executor's
    device); returns the saved iteration count. The executor must be
    built over the same graph and mesh as the one that wrote it: nv, the
    mesh shape and every array's shape are checked (ValueError)."""
    with np.load(path) as z:
        meta = json.loads(bytes(z[_META_KEY]).decode())
        if meta["nv"] != ex.graph.nv:
            raise ValueError(
                f"checkpoint nv={meta['nv']} != graph nv={ex.graph.nv}")
        if meta["mesh"] != _mesh_shape(ex):
            raise ValueError(
                f"checkpoint mesh {meta['mesh']} != executor mesh "
                f"{_mesh_shape(ex)}")
        changed = z[_CHANGED_KEY]
        state = {k: z[k] for k in z.files
                 if k not in (_META_KEY, _CHANGED_KEY)}
    shape = ex.part.owner_vids().shape
    for k, a in list(state.items()) + [(_CHANGED_KEY, changed)]:
        if a.shape != shape:
            raise ValueError(f"checkpoint {k}: shape {a.shape}, the "
                             f"executor's is {shape}")
    b = ex.shard
    ex.state = {k: torch.from_numpy(np.ascontiguousarray(v[b])).to(ex.device)
                for k, v in state.items()}
    ex.changed = torch.from_numpy(changed[b].astype(bool)).to(ex.device)
    ex.iteration = int(meta["iteration"])
    return ex.iteration
