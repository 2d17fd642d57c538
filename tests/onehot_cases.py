"""The cases of K5 from the one-hot plan (the gather, ⊗ and padding mask
made in the fold), shared by the CPU tests and the card's: each a value
type, ⊕ and ⊗ on an RMAT graph of its app's config, and plans that reach
the edges of its gather tables: a last chunk of padding, a plan of a few
chunks (RMAT-8), null items (row blocks with no chunk), seven trailing
chunks with no edge, one hub lane across many chunks (a chunk's 2,048
slots in one lane), and x exactly ``col_bound`` long. Imports no JAX."""

import dataclasses

import numpy as np
import torch

from graphtap_tpu_torch import Graph, GraphConfig
from graphtap_tpu_torch.apps import bfs_config, sssp_config
from graphtap_tpu_torch.ingest import rmat_edges
from graphtap_tpu_torch.kernels import onehot_spmv as oh
from graphtap_tpu_torch.kernels import semiring as tsr


def pad_chunk(plan, n=1):
    """``plan`` with ``n`` more chunks, all padding, on its last block (as
    ``build_onehot_plan`` grows a shard's plan to the mesh's length)."""
    def grow(a):
        return np.concatenate([a, np.zeros((1, n * oh.CHUNK), a.dtype)], 1)
    return dataclasses.replace(
        plan, Ep=plan.Ep + n * oh.CHUNK, nchunks=plan.nchunks + n,
        lrows=grow(plan.lrows), cols=grow(plan.cols),
        weights=None if plan.weights is None else grow(plan.weights),
        evalid=grow(plan.evalid),
        chunk_block=np.concatenate([plan.chunk_block,
                                    np.repeat(plan.chunk_block[:, -1:], n,
                                              1)], 1))


def spread_blocks(plan):
    """``plan`` on twice its row blocks, its chunks on the even ones: each
    odd block has no chunk, so the chunk list holds a null item (-1) for
    it between real ones."""
    return dataclasses.replace(plan, nblocks=2 * plan.nblocks,
                               chunk_block=2 * plan.chunk_block)


def hub_lane(plan, nchunks=9):
    """``plan`` whose first ``nchunks`` chunks are every one an edge of
    lane 7 of block 0: one lane's run of entries across many chunks."""
    p = dataclasses.replace(plan, lrows=plan.lrows.copy(),
                            evalid=plan.evalid.copy(),
                            chunk_block=plan.chunk_block.copy())
    n = nchunks * oh.CHUNK
    p.lrows[:, :n] = 7
    p.evalid[:, :n] = True
    p.chunk_block[:, :nchunks] = 0
    return p


def gather_case(case, scale=10):
    """(x, plan, NR, semiring) of one case of K5 from the plan on
    ``rmat_edges(scale, 16, seed=1)``: its value type, ⊕ and ⊗, x seeded
    (int32 and float min-plus x with ⊕-identity entries)."""
    if case == "f32_sum_few_items":
        scale = 8
    n = 1 << scale
    rng = np.random.default_rng(5)
    weighted = "_w" in case
    r, c, w = rmat_edges(scale, 16, seed=1, weighted=case == "i32_minplus_w")
    if case.startswith("i32"):
        cfg = sssp_config(n) if weighted else bfs_config(n)
        sem = tsr.min_plus() if weighted else tsr.min_select()
        dtype = np.int32
    elif case.startswith("f32_minplus_w"):
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
    nr = ts.NR
    if case == "f32_sum_pad_chunk":
        plan = pad_chunk(plan)
    elif case == "i32_min_pad_chunks":
        plan = pad_chunk(plan, 7)
    elif case == "f32_sum_null_items":
        plan = spread_blocks(plan)
        nr = plan.nblocks * oh.RB
    elif case == "f32_sum_hub_lane":
        plan = hub_lane(plan)
    nc = g.part.tile_cols
    if case == "f32_minplus_w_x_col_bound":
        nc = plan.col_bound
    if dtype == np.int32:
        x = rng.integers(0, 1000, nc).astype(np.int32)
    else:
        x = rng.random(nc).astype(dtype)
    if case.startswith("i32") or case.startswith("f32_minplus_w"):
        x[rng.random(nc) < 0.3] = sem.identity
    return torch.from_numpy(x), plan, nr, sem


GATHER_CASES = ["f32_sum", "f32_sum_w", "f64_sum_w", "i32_min",
                "i32_minplus_w", "f32_minplus_w_inf", "f32_sum_pad_chunk",
                "f32_sum_few_items", "f32_sum_null_items",
                "i32_min_pad_chunks", "f32_sum_hub_lane",
                "f32_minplus_w_x_col_bound"]
