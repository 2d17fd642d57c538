"""Carry arrays from the JAX package (or any numpy source) to the port.

The JAX package stacks its per-device arrays on a leading device axis
(D, ...). The port runs on one device, so D must be 1; the leading axis is
dropped and the arrays become tensors on the requested device.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def _one_device(name: str, a) -> np.ndarray:
    a = np.asarray(a)
    if a.ndim == 0 or a.shape[0] != 1:
        raise ValueError(f"{name}: expected a leading device axis of size 1, "
                         f"got shape {a.shape}")
    a = np.ascontiguousarray(a[0])
    # torch tensors may be written to: copy read-only views (jax arrays)
    return a if a.flags.writeable else a.copy()


def meta_from_numpy(arrays: Mapping[str, np.ndarray],
                    device) -> Dict[str, torch.Tensor]:
    """``Spmv3Meta.arrays`` (leading device axis, D = 1; the JAX
    package's or the port's) -> the tensors ``spmv3_local`` reads."""
    return {k: torch.from_numpy(_one_device(k, v)).to(device)
            for k, v in arrays.items()}


def state_from_numpy(state: Mapping[str, np.ndarray],
                     device="cpu") -> Dict[str, torch.Tensor]:
    """Vertex state (dict of (D, L) arrays, D = 1, e.g. a JAX executor's
    ``state``) -> dict of (L,) tensors, the port executor's layout."""
    return {k: torch.from_numpy(_one_device(k, v)).to(device)
            for k, v in state.items()}
