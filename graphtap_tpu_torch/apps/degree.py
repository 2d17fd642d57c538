"""Degree: one plus-times superstep with unit messages.

Counterpart of ``graphtap_tpu/apps/degree.py`` (reference: src/apps/deg.h:
messenger = 1, combiner = +, applicator stores y, never 'changed'; deg.cpp:
stationary, TCSC, ROW ordering, one iteration).
"""

from __future__ import annotations

import torch

from graphtap_tpu_torch.config import EngineConfig, Ordering
from graphtap_tpu_torch.engine.executor import Executor
from graphtap_tpu_torch.engine.program import VertexProgram
from graphtap_tpu_torch.kernels.semiring import plus_times


class DegreeProgram(VertexProgram):
    stationary = True

    def __init__(self, value_dtype: torch.dtype = torch.float32):
        self.semiring = plus_times()
        self.value_dtype = value_dtype

    def init(self, vids, i_mask, other):
        state = {"degree": torch.zeros(vids.shape, dtype=self.value_dtype,
                                       device=vids.device)}
        return state, torch.ones_like(i_mask)

    def messenger(self, state):
        return torch.ones_like(state["degree"])

    def applicator(self, state, y, iteration):
        return {"degree": y}, torch.zeros(y.shape, dtype=torch.bool,
                                          device=y.device)

    def get_state(self, state):
        return state["degree"]

    def format_state(self, row):
        return f"Degree={row['degree']}"


def run_degree(graph, value_dtype: torch.dtype = torch.float32,
               ordering: Ordering = Ordering.ROW, kernel: str = "shuffle",
               device="cuda") -> Executor:
    """Out-degree of the stored matrix (deg.cpp: directed, untransposed,
    ROW ordering: y[src] = the count of its out-edges), one superstep on
    ``kernel``, on ``device``."""
    ex = Executor(graph, DegreeProgram(value_dtype=value_dtype),
                  EngineConfig(stationary=True, ordering=ordering),
                  kernel=kernel, device=device)
    ex.initialize()
    ex.execute(1)
    return ex
