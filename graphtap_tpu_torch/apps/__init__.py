"""Applications on the port: Degree and PageRank."""

from graphtap_tpu_torch.apps.degree import DegreeProgram
from graphtap_tpu_torch.apps.pagerank import PageRankProgram, run_pagerank

__all__ = ["DegreeProgram", "PageRankProgram", "run_pagerank"]
