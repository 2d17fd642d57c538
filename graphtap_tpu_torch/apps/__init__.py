"""Applications on the port: Degree, PageRank, BFS, CC and SSSP."""

from graphtap_tpu_torch.apps.degree import DegreeProgram
from graphtap_tpu_torch.apps.pagerank import PageRankProgram, run_pagerank
from graphtap_tpu_torch.apps.bfs import BFSProgram, bfs_config, run_bfs
from graphtap_tpu_torch.apps.cc import CCProgram, cc_config, run_cc
from graphtap_tpu_torch.apps.sssp import SSSPProgram, run_sssp, sssp_config

__all__ = ["DegreeProgram", "PageRankProgram", "run_pagerank", "BFSProgram",
           "bfs_config", "run_bfs", "CCProgram", "cc_config", "run_cc",
           "SSSPProgram", "sssp_config", "run_sssp"]
