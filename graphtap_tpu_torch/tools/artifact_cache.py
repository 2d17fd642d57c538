"""On-disk cache of the port's host-built artifacts: the panel meta
(``Spmv3Meta``), the v1 shuffle plans (``ShufflePlans``) and the v2
windowed-gather plans (``Spmv2Meta``); tile sets (``save_tileset``,
``load_tileset``) and RMAT edge lists (``cached_rmat``), as the JAX
package's ``tools/artifact_cache.py`` keeps them. The one-hot plan builds
in about a second and is not cached.

Plans are a pure function of the edge list, the graph's ingest config,
the ordering, the value dtype and the planner's code, and an RMAT-20 panel
or v2 plan takes minutes to build, so they are memoized as ``.npz`` under
``graphtap_tpu_torch/build/plan_cache/``. The key names the generator
parameters (scale,
edge factor, seed), every field of the ``GraphConfig`` (BFS and CC read
one RMAT edge list through different configs — self-loops dropped or
kept — and get different plans), whether the tiles carry weights, the
ordering, the tile phase ("main", or the TCSC_CF "first", "middle" and
"last" edge subsets of one graph, whose plans differ), the dtype, the
mesh shape and the shard (a rank plans its own shard, so a 1x1 plan is
never served to a mesh rank, nor one rank's to another) and a hash of
every source file the plan bytes depend on, so a plan built by older
planner code is never served (a key that leaves out what the artifact
depends on serves a wrong artifact). On a mesh every rank must call the
``cached_*`` functions: the ranks load only when every rank's plan is on
disk, else every rank builds (planning is collective).
"""

from __future__ import annotations

import dataclasses
import enum
import hashlib
import json
import os
from pathlib import Path
from typing import Optional

import numpy as np

from graphtap_tpu_torch.config import Compression
from graphtap_tpu_torch.format.tiles import TileSet
from graphtap_tpu_torch.kernels.gather_engine import (Spmv2Meta,
                                                      build_spmv2_meta,
                                                      validate_spmv2_meta)
from graphtap_tpu_torch.kernels.panel_meta import (Spmv3Meta,
                                                   build_spmv3_meta,
                                                   validate_meta)
from graphtap_tpu_torch.kernels.shuffle_engine import (
    ShufflePlans, build_shuffle_plans, validate_shuffle_plans)
from graphtap_tpu_torch.parallel import multihost as mh
from graphtap_tpu_torch.parallel.layout import Mesh, Partition

PKG = Path(__file__).resolve().parent.parent
DEFAULT_DIR = PKG / "build" / "plan_cache"
_META = "__meta__"
_SCALARS = ("NC", "nblocks", "dense_rows", "f2_rows", "exp_panels",
            "pa_panels", "pa_nwin", "fix_panels", "fixr_nwin",
            "fix2_chunks", "f2_panels", "f2_nwin", "nrb", "xext_rows",
            "xr_nwin", "sx_rows", "has_w")
# every file whose code decides the plan bytes, per plan kind
_PLAN_SOURCES = {
    "spmv3": (PKG / "kernels" / "panel_plan.py",
              PKG / "kernels" / "gather_plan.py",
              PKG / "native" / "route_solver.cpp",
              PKG / "kernels" / "panel_meta.py",
              PKG / "kernels" / "panel_kernels.py"),
    "shuffle": (PKG / "kernels" / "shuffle_plan.py",
                PKG / "kernels" / "shuffle_engine.py",
                PKG / "kernels" / "shuffle_kernels.py"),
    "spmv2": (PKG / "kernels" / "gather_plan.py",
              PKG / "kernels" / "gather_engine.py",
              PKG / "kernels" / "gather_kernels.py"),
}


# ----------------------------------------------------------------- TileSet
_TS_ARRAYS = ("rows", "cols", "weights", "nnz", "ja", "ir", "iv_dense",
              "nnzrows", "i_own", "j_own", "regular_own", "source_own",
              "sink_own", "nnzcols", "jc", "dev_nnz")


def save_tileset(ts: TileSet, path) -> None:
    """A tile set as one ``.npz``: its arrays and a JSON meta entry of its
    scalar fields and partition (the mesh's R x C: a mesh rank's tiles
    hold its own row)."""
    arrays = {k: getattr(ts, k) for k in _TS_ARRAYS
              if getattr(ts, k) is not None}
    meta = {"compression": ts.compression.value,
            "has_weight": bool(ts.has_weight), "Ep": int(ts.Ep),
            "NR": int(ts.NR), "nnz_total": int(ts.nnz_total),
            "part": [ts.part.nv, ts.part.R, ts.part.C, ts.part.L]}
    arrays[_META] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    np.savez(path, **arrays)


def load_tileset(path, mesh: Optional[Mesh] = None) -> TileSet:
    """The tile set ``save_tileset`` wrote, on ``mesh`` (which must be
    of its partition's shape; None for 1x1 tiles)."""
    with np.load(path) as z:
        meta = json.loads(bytes(z[_META]).decode())
        arrays = {k: (z[k] if k in z.files else None) for k in _TS_ARRAYS}
    nv, R, C, L = meta["part"]
    part = Partition(nv=nv, R=R, C=C, L=L)
    mh.shard_of(part, mesh)
    return TileSet(part=part, mesh=mesh,
                   compression=Compression(meta["compression"]),
                   has_weight=meta["has_weight"], Ep=meta["Ep"],
                   NR=meta["NR"], nnz_total=meta["nnz_total"], **arrays)


# ------------------------------------------------------------- edge lists
def cached_rmat(scale: int, edge_factor: int, seed: int, cache_dir,
                weighted: bool = False):
    """RMAT edges memoized as a raw binary edge list (the same
    ``(u32, u32[, u32])`` records the reference's data files use)."""
    from graphtap_tpu_torch.ingest.io import read_edge_list, write_binary
    from graphtap_tpu_torch.ingest.rmat import rmat_edges
    os.makedirs(cache_dir, exist_ok=True)
    tag = "w" if weighted else ""
    path = os.path.join(cache_dir,
                        f"rmat{scale}_ef{edge_factor}_s{seed}{tag}.bin")
    if os.path.exists(path):
        return read_edge_list(path, has_weight=weighted)
    r, c, w = rmat_edges(scale=scale, edge_factor=edge_factor, seed=seed,
                         weighted=weighted)
    tmp = f"{path}.{os.getpid()}.tmp"
    write_binary(tmp, r, c, w)
    os.replace(tmp, path)
    return r, c, w


# ------------------------------------------------------------------ plans
def _scalar_names(cls):
    return tuple(f.name for f in dataclasses.fields(cls) if f.name != "arrays")


_SHUFFLE_SCALARS = _scalar_names(ShufflePlans)
_SPMV2_SCALARS = _scalar_names(Spmv2Meta)   # nsub, out_rows: per-stage dicts


def source_hash(kind: str = "spmv3") -> str:
    h = hashlib.sha256()
    for p in _PLAN_SOURCES[kind]:
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def config_hash(config) -> str:
    """A short hash of every field of a ``GraphConfig``."""
    fields = {k: (v.value if isinstance(v, enum.Enum) else v)
              for k, v in dataclasses.asdict(config).items()}
    return hashlib.sha256(json.dumps(fields, sort_keys=True).encode()
                          ).hexdigest()[:12]


PHASES = ("main", "first", "middle", "last")


def meta_key(scale: int, edge_factor: int, seed: int, config, ordering,
             value_dtype, weighted: bool, kind: str = "spmv3",
             phase: str = "main", mesh_shape=(1, 1), shard: int = 0) -> str:
    if phase not in PHASES:
        raise ValueError(f"phase {phase!r}: expected one of {PHASES}")
    R, C = mesh_shape
    return (f"{kind}_rmat{scale}_ef{edge_factor}_s{seed}_"
            f"cfg{config_hash(config)}_{'w' if weighted else 'nw'}_"
            f"{ordering.value}_{phase}_{np.dtype(value_dtype).name}_"
            f"m{R}x{C}b{shard}_{source_hash(kind)}")


def _plain(v):
    """A scalar (or a dict of them) as JSON takes it."""
    if isinstance(v, dict):
        return {k: _plain(x) for k, x in v.items()}
    return bool(v) if isinstance(v, (bool, np.bool_)) else int(v)


def _save(meta, scalar_names, path) -> None:
    arrays = dict(meta.arrays)
    scalars = {k: _plain(getattr(meta, k)) for k in scalar_names}
    arrays[_META] = np.frombuffer(json.dumps(scalars).encode(),
                                  dtype=np.uint8)
    tmp = f"{path}.{os.getpid()}.tmp.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, path)


def _load(cls, validate, path):
    with np.load(path) as z:
        scalars = json.loads(bytes(z[_META]).decode())
        arrays = {k: z[k] for k in z.files if k != _META}
    meta = cls(arrays=arrays, **scalars)
    validate(meta)
    return meta


def save_spmv3_meta(meta: Spmv3Meta, path) -> None:
    _save(meta, _SCALARS, path)


def load_spmv3_meta(path) -> Spmv3Meta:
    return _load(Spmv3Meta, validate_meta, path)


def save_shuffle_plans(meta: ShufflePlans, path) -> None:
    _save(meta, _SHUFFLE_SCALARS, path)


def load_shuffle_plans(path) -> ShufflePlans:
    return _load(ShufflePlans, validate_shuffle_plans, path)


def save_spmv2_meta(meta: Spmv2Meta, path) -> None:
    _save(meta, _SPMV2_SCALARS, path)


def load_spmv2_meta(path) -> Spmv2Meta:
    return _load(Spmv2Meta, validate_spmv2_meta, path)


_KINDS = {"spmv3": (build_spmv3_meta, save_spmv3_meta, load_spmv3_meta),
          "shuffle": (build_shuffle_plans, save_shuffle_plans,
                      load_shuffle_plans),
          "spmv2": (build_spmv2_meta, save_spmv2_meta, load_spmv2_meta)}


def _cached(kind, tiles, scale, edge_factor, seed, config, ordering,
            value_dtype, cache_dir, phase):
    build, save, load = _KINDS[kind]
    d = Path(cache_dir) if cache_dir is not None else DEFAULT_DIR
    part = tiles.part
    path = d / (meta_key(scale, edge_factor, seed, config, ordering,
                         value_dtype, tiles.weights is not None, kind, phase,
                         (part.R, part.C), mh.shard_of(part, tiles.mesh))
                + ".npz")
    if int(mh.global_sum(int(path.exists()), tiles.mesh)) == part.D:
        return load(path)
    meta = build(tiles, value_dtype=value_dtype)
    d.mkdir(parents=True, exist_ok=True)
    save(meta, path)
    return meta


def cached_spmv3_meta(tiles: TileSet, scale: int, edge_factor: int,
                      seed: int, config, ordering, value_dtype=np.float32,
                      cache_dir: Optional[os.PathLike] = None,
                      phase: str = "main") -> Spmv3Meta:
    """The panel meta of an RMAT graph's tiles (read through the
    ``GraphConfig`` ``config``, tiled in ``ordering``; ``phase``: "main",
    or the TCSC_CF phase the tiles are of), from disk when cached."""
    return _cached("spmv3", tiles, scale, edge_factor, seed, config,
                   ordering, value_dtype, cache_dir, phase)


def cached_shuffle_plans(tiles: TileSet, scale: int, edge_factor: int,
                         seed: int, config, ordering, value_dtype=np.float32,
                         cache_dir: Optional[os.PathLike] = None,
                         phase: str = "main") -> ShufflePlans:
    """The v1 shuffle plans of an RMAT graph's tiles, keyed as
    ``cached_spmv3_meta`` keys the panel meta, from disk when cached."""
    return _cached("shuffle", tiles, scale, edge_factor, seed, config,
                   ordering, value_dtype, cache_dir, phase)


def cached_spmv2_meta(tiles: TileSet, scale: int, edge_factor: int,
                      seed: int, config, ordering, value_dtype=np.float32,
                      cache_dir: Optional[os.PathLike] = None,
                      phase: str = "main") -> Spmv2Meta:
    """The v2 windowed-gather plans of an RMAT graph's tiles, keyed as
    ``cached_spmv3_meta`` keys the panel meta, from disk when cached."""
    return _cached("spmv2", tiles, scale, edge_factor, seed, config,
                   ordering, value_dtype, cache_dir, phase)
