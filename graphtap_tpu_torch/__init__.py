"""graphtap_tpu_torch — graphtap on PyTorch and CUDA (NVIDIA Hopper).

A port of ``graphtap_tpu`` (JAX, Pallas kernels for the TPU), which stays
beside it as the reference. The port mirrors its layout: ``config``,
``parallel/layout``, ``ingest``, ``format/tiles``, ``kernels``,
``engine``, ``apps`` and ``tools``. Plain tensor code is torch; the Pallas
kernels (the panel path, static, frontier-gated and staged; the v1
shuffle, v2 windowed-gather and one-hot paths) are hand-written CUDA C++
for sm_90a (``csrc/``), each with a plain torch version beside it. The
numpy-only host planner is the port's own copy of the JAX package's
(``config.py``, ``ingest/rmat.py``, ``ingest/io.py``,
``kernels/{panel,gather,shuffle}_plan.py`` and the C++ sources under
``native/``, built into ``build/`` at first use), so its plan bytes equal
the JAX package's and nothing of that package is read.

It runs the degree phase and PageRank, for a fixed count of iterations
or to convergence, on CSC, DCSC, TCSC or TCSC_CF tiles
(``apps.run_pagerank``, ``run_pagerank_two_load``; the ``apps.pr``,
``pr1`` and ``deg`` mains), BFS, CC and SSSP to convergence with
frontier gating and the sparse exchange (``apps.run_bfs``, ``run_cc``,
``run_sssp``), and the kernel lab's nine format/kernel variants
(``tools.kernel_lab``, ``tools.lab_table``), on one device or on an
R x C mesh of ``torch.distributed`` ranks, one a shard
(``parallel.layout.make_mesh``; ``parallel.launch`` starts N ranks; the
kernel lab stays 1x1). Entry points run on the card (``device="cuda"``)
unless the caller passes ``device="cpu"``.
"""

from graphtap_tpu_torch.config import (Compression, EngineConfig,
                                       GraphConfig, Ordering)
from graphtap_tpu_torch.parallel.layout import Mesh, Partition, make_mesh
from graphtap_tpu_torch.ingest.graph import Graph
from graphtap_tpu_torch.engine.program import VertexProgram
from graphtap_tpu_torch.engine.executor import Executor
from graphtap_tpu_torch.kernels.semiring import (Semiring, min_plus,
                                                 min_select, plus_times)

__version__ = "0.1.0"

__all__ = [
    "GraphConfig", "EngineConfig", "Compression", "Ordering", "Partition",
    "Mesh", "make_mesh",
    "Graph", "VertexProgram", "Executor", "Semiring", "plus_times",
    "min_plus", "min_select",
]
