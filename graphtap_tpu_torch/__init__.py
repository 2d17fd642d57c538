"""graphtap_tpu_torch — graphtap on PyTorch and CUDA (NVIDIA Hopper).

A port of ``graphtap_tpu`` (JAX, Pallas kernels for the TPU), which stays
beside it as the reference. The port mirrors its layout: ``config``,
``parallel/layout``, ``ingest``, ``format/tiles``, ``kernels``,
``engine``, ``apps`` and ``tools``. Plain tensor code is torch; the Pallas
kernels of the panel path (static and frontier-gated) are hand-written
CUDA C++ for sm_90a (``csrc/``), each with a plain torch version beside
it. The numpy-only
host planner of the JAX package is reused byte for byte, loaded by path
without jax (``_host.py``).

This version runs on one device: the degree phase and PageRank, for a
fixed count of iterations or to convergence (``apps.run_pagerank``), and
BFS, CC and SSSP to convergence with frontier gating (``apps.run_bfs``,
``run_cc``, ``run_sssp``).
"""

from graphtap_tpu_torch.config import (Compression, EngineConfig,
                                       GraphConfig, Ordering)
from graphtap_tpu_torch.parallel.layout import Partition
from graphtap_tpu_torch.ingest.graph import Graph
from graphtap_tpu_torch.engine.program import VertexProgram
from graphtap_tpu_torch.engine.executor import Executor
from graphtap_tpu_torch.kernels.semiring import (Semiring, min_plus,
                                                 min_select, plus_times)

__version__ = "0.1.0"

__all__ = [
    "GraphConfig", "EngineConfig", "Compression", "Ordering", "Partition",
    "Graph", "VertexProgram", "Executor", "Semiring", "plus_times",
    "min_plus", "min_select",
]
