"""Ingest: the JAX package's numpy RMAT generator and read-time transforms
(loaded by path, see ``_host.py``) and the port's ``Graph``."""

from graphtap_tpu_torch import _host

rmat_edges = _host.load("rmat").rmat_edges
apply_transforms = _host.load("io").apply_transforms

from graphtap_tpu_torch.ingest.graph import Graph  # noqa: E402

__all__ = ["rmat_edges", "apply_transforms", "Graph"]
