"""Checkpoint / resume for long executions.

Counterpart of ``graphtap_tpu/tools/checkpoint.py``. The reference has no
persistence (results are printed, never written); this snapshots an
executor's vertex state, its changed bitmap and iteration counter, and
restores them into a freshly built Executor over the same graph (the
graph itself is rebuilt from the edge list, deterministically).

Format: one ``.npz`` per checkpoint (host numpy), one array per state
leaf plus ``__changed__`` and a JSON ``__meta__`` (iteration, nv, the
program, the partition). The port runs on one device, so where the JAX
package checks the mesh shape, this checks the partition (1 x 1).
"""

from __future__ import annotations

import json
from typing import TYPE_CHECKING

import numpy as np
import torch

if TYPE_CHECKING:  # pragma: no cover
    from graphtap_tpu_torch.engine.executor import Executor

_META_KEY = "__meta__"
_CHANGED_KEY = "__changed__"


def _partition(ex: "Executor") -> list:
    return [ex.part.R, ex.part.C]


def save_state(ex: "Executor", path: str) -> None:
    """Snapshot an executor's iteration state to ``path`` (.npz)."""
    if ex.state is None:
        raise ValueError("executor has no state; call initialize() first")
    arrays = {k: v.cpu().numpy() for k, v in ex.state.items()}
    if any(k.startswith("__") for k in arrays):
        raise ValueError("state keys must not start with '__'")
    arrays[_CHANGED_KEY] = ex.changed.cpu().numpy()
    meta = {
        "iteration": ex.iteration,
        "nv": ex.graph.nv,
        "program": type(ex.program).__name__,
        "partition": _partition(ex),
    }
    arrays[_META_KEY] = np.frombuffer(json.dumps(meta).encode(),
                                      dtype=np.uint8)
    np.savez(path, **arrays)


def load_state(ex: "Executor", path: str) -> int:
    """Restore a snapshot into ``ex`` (its arrays on the executor's
    device); returns the saved iteration count. The executor must be
    built over the same graph and partition as the one that wrote it:
    nv, the partition and every array's shape are checked (ValueError)."""
    with np.load(path) as z:
        meta = json.loads(bytes(z[_META_KEY]).decode())
        if meta["nv"] != ex.graph.nv:
            raise ValueError(
                f"checkpoint nv={meta['nv']} != graph nv={ex.graph.nv}")
        if meta["partition"] != _partition(ex):
            raise ValueError(
                f"checkpoint partition {meta['partition']} != executor "
                f"partition {_partition(ex)}")
        changed = z[_CHANGED_KEY]
        state = {k: z[k] for k in z.files
                 if k not in (_META_KEY, _CHANGED_KEY)}
    rows = ex.part.owner_vids().shape[-1]
    for k, a in list(state.items()) + [(_CHANGED_KEY, changed)]:
        if a.shape != (rows,):
            raise ValueError(f"checkpoint {k}: shape {a.shape}, the "
                             f"executor's is ({rows},)")
    ex.state = {k: torch.from_numpy(v).to(ex.device)
                for k, v in state.items()}
    ex.changed = torch.from_numpy(changed.astype(bool)).to(ex.device)
    ex.iteration = int(meta["iteration"])
    return ex.iteration
