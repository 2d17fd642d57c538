"""Applications on the port: Degree, PageRank, BFS, CC and SSSP."""

from graphtap_tpu_torch.apps.degree import DegreeProgram, run_degree
from graphtap_tpu_torch.apps.pagerank import (PageRankProgram, run_pagerank,
                                              run_pagerank_two_load)
from graphtap_tpu_torch.apps.bfs import BFSProgram, bfs_config, run_bfs
from graphtap_tpu_torch.apps.cc import CCProgram, cc_config, run_cc
from graphtap_tpu_torch.apps.sssp import SSSPProgram, run_sssp, sssp_config

__all__ = ["DegreeProgram", "run_degree", "PageRankProgram", "run_pagerank",
           "run_pagerank_two_load", "BFSProgram",
           "bfs_config", "run_bfs", "CCProgram", "cc_config", "run_cc",
           "SSSPProgram", "sssp_config", "run_sssp"]
