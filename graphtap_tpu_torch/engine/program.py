"""VertexProgram: the five-callback user surface, over torch tensors.

Counterpart of ``graphtap_tpu/engine/program.py`` (reference:
vertex_program.hpp:32-45): initializer / messenger / combiner (the
semiring) / applicator / infinity. ``init`` builds the initial state on the
host in numpy, as in the JAX package; ``messenger`` and ``applicator`` are
vectorized torch functions over a whole vertex segment on the run's device.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from graphtap_tpu_torch.kernels.semiring import Semiring

State = Dict[str, torch.Tensor]


def numpy_dtype(dtype: torch.dtype) -> np.dtype:
    """The numpy dtype of a torch dtype (host-side state construction)."""
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

    def init(self, vids: np.ndarray, i_mask: np.ndarray,
             other: Optional[Dict[str, np.ndarray]]
             ) -> Tuple[Dict[str, np.ndarray], np.ndarray]:
        """Initial state and changed bitmap, host-side numpy.

        ``vids``: (D, L) global vertex id per slot; ``i_mask``: (D, L)
        in-edge mask of the owner segment; ``other``: a predecessor
        program's final state as (D, L) numpy arrays (Deg -> PR, pr.cpp:48).
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
