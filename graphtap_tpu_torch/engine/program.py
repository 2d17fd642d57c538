"""VertexProgram: the five-callback user surface, over torch tensors.

Counterpart of ``graphtap_tpu/engine/program.py`` (reference:
vertex_program.hpp:32-45): initializer / messenger / combiner (the
semiring) / applicator / infinity. ``init``, ``messenger`` and
``applicator`` are vectorized torch functions over a whole vertex segment
on the run's device: ``init`` builds the initial state there from the
shard's rows that the executor keeps on it, where the JAX package builds
it on the host in numpy.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from graphtap_tpu_torch.kernels.semiring import Semiring

State = Dict[str, torch.Tensor]


def numpy_dtype(dtype: torch.dtype) -> np.dtype:
    """The numpy dtype of a torch dtype (the planners' value dtype)."""
    return torch.empty((), dtype=dtype).numpy().dtype


class VertexProgram:
    """Subclass and override. See apps/ for the reference programs."""

    #: the (⊕, ⊗, id) triple — replaces the combiner overloads
    semiring: Semiring
    #: dtype of messages / accumulators
    value_dtype: torch.dtype = torch.float32
    #: engine mode flags (reference: vertex_program.hpp:27-29)
    stationary: bool = True
    gather_depends_on_apply: bool = False
    apply_depends_on_iter: bool = False

    def init(self, vids: torch.Tensor, i_mask: torch.Tensor,
             other: Optional[State]) -> Tuple[State, torch.Tensor]:
        """Initial state and changed bitmap, on the device of ``vids``.

        ``vids``: (L,) int32 global vertex id per slot of this shard;
        ``i_mask``: (L,) bool in-edge mask of its owner segment;
        ``other``: a predecessor program's final state as (L,) tensors on
        the same device (Deg -> PR, pr.cpp:48), or None. Returns fresh
        (L,) tensors in the program's dtypes and an (L,) bool ``changed``;
        none may share storage with ``vids``, ``i_mask`` or ``other``, so
        that updates of the state never reach them.
        """
        raise NotImplementedError

    def messenger(self, state: State) -> torch.Tensor:
        """Vertex -> outgoing message value."""
        raise NotImplementedError

    def applicator(self, state: State, y: torch.Tensor,
                   iteration: int) -> Tuple[State, torch.Tensor]:
        """(state, accumulator, iteration) -> (new state, changed mask)."""
        raise NotImplementedError

    def infinity(self):
        """The unreached-state sentinel used by the checksum oracle
        (reference default 0, vertex_program.hpp:40)."""
        return 0

    def get_state(self, state: Dict[str, Any]):
        """Scalar summary per vertex (reference: State::get_state)."""
        raise NotImplementedError

    def format_state(self, state_row: Dict[str, Any]) -> str:
        """Pretty-print one vertex (reference: State::print_state)."""
        return ",".join(f"{k}={v}" for k, v in state_row.items())
