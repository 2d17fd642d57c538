"""The cases of K5 from the one-hot plan (the gather, ⊗ and padding mask
made in the fold), shared by the CPU tests and the card's: each a value
type, ⊕ and ⊗ on an RMAT graph of its app's config, and a plan whose last
chunk is all padding. Imports no JAX."""

import dataclasses

import numpy as np
import torch

from graphtap_tpu_torch import Graph, GraphConfig
from graphtap_tpu_torch.apps import bfs_config, sssp_config
from graphtap_tpu_torch.ingest import rmat_edges
from graphtap_tpu_torch.kernels import onehot_spmv as oh
from graphtap_tpu_torch.kernels import semiring as tsr


def pad_chunk(plan):
    """``plan`` with one more chunk, all padding, on its last block (as
    ``build_onehot_plan`` grows a shard's plan to the mesh's length)."""
    def grow(a):
        return np.concatenate([a, np.zeros((1, oh.CHUNK), a.dtype)], 1)
    return dataclasses.replace(
        plan, Ep=plan.Ep + oh.CHUNK, nchunks=plan.nchunks + 1,
        lrows=grow(plan.lrows), cols=grow(plan.cols),
        weights=None if plan.weights is None else grow(plan.weights),
        evalid=grow(plan.evalid),
        chunk_block=np.concatenate([plan.chunk_block,
                                    plan.chunk_block[:, -1:]], 1))


def gather_case(case, scale=10):
    """(x, plan, NR, semiring) of one case of K5 from the plan on
    ``rmat_edges(scale, 16, seed=1)``: its value type, ⊕ and ⊗, x seeded
    (int32 and float min-plus x with ⊕-identity entries)."""
    n = 1 << scale
    rng = np.random.default_rng(5)
    weighted = "_w" in case
    r, c, w = rmat_edges(scale, 16, seed=1, weighted=case == "i32_minplus_w")
    if case.startswith("i32"):
        cfg = sssp_config(n) if weighted else bfs_config(n)
        sem = tsr.min_plus() if weighted else tsr.min_select()
        dtype = np.int32
    elif case == "f32_minplus_w_inf":
        cfg = GraphConfig(num_vertices=n, directed=False, self_loops=False,
                          parallel_edges=False, has_weight=True)
        w = rng.random(r.size).astype(np.float32)
        sem, dtype = tsr.min_plus(tsr.inf_of(torch.float32)), np.float32
    else:
        cfg = GraphConfig(num_vertices=n, transpose=True)
        dtype = np.float64 if case.startswith("f64") else np.float32
        w = rng.random(r.size).astype(dtype) if weighted else None
        sem = tsr.plus_times()
    g = Graph.from_edges(r, c, w, cfg)
    ts = g.tiled()
    plan = oh.build_onehot_plan(ts)
    if case == "f32_sum_pad_chunk":
        plan = pad_chunk(plan)
    nc = g.part.tile_cols
    if dtype == np.int32:
        x = rng.integers(0, 1000, nc).astype(np.int32)
    else:
        x = rng.random(nc).astype(dtype)
    if case.startswith("i32") or case == "f32_minplus_w_inf":
        x[rng.random(nc) < 0.3] = sem.identity
    return torch.from_numpy(x), plan, ts.NR, sem


GATHER_CASES = ["f32_sum", "f32_sum_w", "f64_sum_w", "i32_min",
                "i32_minplus_w", "f32_minplus_w_inf", "f32_sum_pad_chunk"]
