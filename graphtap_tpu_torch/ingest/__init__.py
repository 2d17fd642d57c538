"""Ingest: the numpy RMAT generator and read-time transforms (the port's
copies of the JAX package's ``ingest/rmat.py`` and ``ingest/io.py``) and
the port's ``Graph``."""

from graphtap_tpu_torch.ingest.graph import Graph
from graphtap_tpu_torch.ingest.io import apply_transforms
from graphtap_tpu_torch.ingest.rmat import rmat_edges

__all__ = ["rmat_edges", "apply_transforms", "Graph"]
