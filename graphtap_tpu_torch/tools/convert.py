"""Carry arrays from the JAX package (or any numpy source) to the port.

The JAX package stacks its per-device arrays on a leading device axis
(D, ...); a rank of the port holds one shard, whose arrays carry that
axis with one row. These take a shard's row (a leading axis of size 1),
drop the axis and make the arrays tensors on the requested device.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def _shard_row(name: str, a) -> np.ndarray:
    a = np.asarray(a)
    if a.ndim == 0 or a.shape[0] != 1:
        raise ValueError(f"{name}: expected a shard's row (a leading "
                         f"device axis of size 1), got shape {a.shape}")
    a = np.ascontiguousarray(a[0])
    # torch tensors may be written to: copy read-only views (jax arrays)
    return a if a.flags.writeable else a.copy()


def meta_from_numpy(arrays: Mapping[str, np.ndarray],
                    device) -> Dict[str, torch.Tensor]:
    """A shard's plan arrays (``Spmv3Meta.arrays`` and the like; the JAX
    package's at D = 1, or the port's) -> the tensors the SpMV reads."""
    return {k: torch.from_numpy(_shard_row(k, v)).to(device)
            for k, v in arrays.items()}


def state_from_numpy(state: Mapping[str, np.ndarray],
                     device="cpu") -> Dict[str, torch.Tensor]:
    """A shard's vertex state (dict of (1, L) arrays, e.g. a 1x1 JAX
    executor's ``state``) -> dict of (L,) tensors, the port executor's
    layout."""
    return {k: torch.from_numpy(_shard_row(k, v)).to(device)
            for k, v in state.items()}
