"""Executor: the BSP superstep loop of one mesh shard.

Counterpart of ``graphtap_tpu/engine/executor.py`` (reference:
Vertex_Program::execute, vertex_program.hpp:407-441). One superstep is
messenger -> exchange x -> combine (the SpMV) -> exchange y -> apply
(masked to the I rows under TCSC, :1655-1670). The JAX executor runs the
superstep under ``shard_map`` on its ('rows', 'cols') mesh; the port runs
one ``torch.distributed`` rank per shard (``parallel/layout.py::Mesh``,
rank = shard b = i*C + j), on the graph's mesh, and each rank uploads
its own row of the tiles and plans. The exchanges follow the JAX
executor's (its executor.py:257-343):

  * x: an all-gather of the messages over the rank's mesh column
    (``xgroup``), which concatenates, in i order, the contiguous column
    block of the tile;
  * y: an all-to-all of the (C, L) partials over the mesh row
    (``ygroup``), then a ⊕-fold of the C received parts in shard order,
    for every semiring (the JAX executor reduce-scatters sums with
    ``psum_scatter``, which sums in its own order: f32 sums agree within
    tolerance, not bit for bit);
  * the vote: an all-reduce of every rank's all(~changed) over the world,
    compared with D, read to the host once a superstep;
  * with ``EngineConfig.sparse_exchange_capacity = K`` and a
    nonstationary program, the sparse protocol (reference :865-966,
    :1543-1573), on 1x1 as well: if every member of the group has at
    most K active slots (a fits-vote summed over the group, so every
    member takes the same branch), the first K active slots are
    compacted (a stable argsort), exchanged as (index, value) pairs and
    rebuilt (x) or ⊕-scattered (y, min/max only: sums always exchange
    dense); else the dense exchange. ``supersteps[i]["sparse"]`` and
    ``["sparse_y"]`` record the branch each side took (None: dense by
    rule, K = 0 or a sum).

Collectives run on the group's device: the CUDA tensors themselves on
NCCL, CPU tensors on gloo, and with CUDA tensors on gloo (ranks sharing
one card) each exchange copies to the host and back (``exchange``:
"nccl", "gloo", "gloo-host", or None without a mesh, where every
exchange but the sparse protocol's compaction is the identity).

Ported: fixed-iteration and convergence mode on every tile format (CSC,
DCSC, TCSC, TCSC_CF), stationary and nonstationary programs (messages
masked to the ⊕-identity outside the frontier, the panel pipeline
frontier-gated), every kernel choice of the JAX executor (``KERNELS``),
prebuilt ``tiles=``, ``initialize(other=)`` with the I-masked handoff
(both programs share one partition, so each rank's segment is local),
``free()``, ``execute_profiled`` (per-phase timing) and the oracles
(``state_vector``, ``checksum``, ``stats``, ``display``, which gather the
state from every rank and return the same values on each). The format is
the tiles' own, and the JAX executor's rules hold: CSC and DCSC keep raw
local rows, so the SpMV's y is the dense row block itself and apply masks
nothing but the padding (the I mask is TCSC's, :1655-1670); DCSC gathers
x through its JC table first and runs on scan and segment only; shuffle
needs renumbered (TCSC) rows. Those two and an unknown kernel name raise
``ValueError``.

TCSC_CF (computation filtering, reference: spmv_stationary's phase
gating, vertex_program.hpp:1243-1320; apply :1671-1692) runs three edge
subsets of the matrix (``format/tiles.py::build_cf_tilesets``) as phases,
each with its own plans and apply mask: "first" (regular rows, all
columns; applies to regular rows), "middle" (regular rows x regular
columns; regular rows) and "last" (all but regular-row x sink-col;
regular and source rows). A fixed run of n > 1 iterations is first,
middle for iterations 1 .. n-2, last; convergence mode is first, middle
steps until the vote (which the middle mask limits to regular rows), then
the flush on "last" with the stale messages (executor.py:608-710 of the
JAX package). A 1-iteration run, such as the degree phase, runs the
main tiles ("main", applied under the I mask as TCSC is). The phase
tiles and plans are built at the first run that needs them.

Convergence mode (``execute(0)``, reference :407-441) runs supersteps
until every vertex votes unchanged, then one flush: combine and apply on
the last superstep's messages (:425-429), their x exchanged dense, as
the JAX executor's flush gathers it. Each superstep reads the vote to
the host once, each sparse side its fits-vote once, and the panel
kernel's "auto" gate its panel-activity vote once more; all are
synchronizing reads.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from graphtap_tpu_torch.config import Compression, EngineConfig
from graphtap_tpu_torch.engine.program import State, VertexProgram, \
    numpy_dtype
from graphtap_tpu_torch.format.tiles import TileSet
from graphtap_tpu_torch.ingest.graph import Graph
from graphtap_tpu_torch.kernels import (gather_engine, onehot_spmv,
                                        panel_engine, shuffle_engine)
from graphtap_tpu_torch.kernels.gather_engine import (Spmv2Meta,
                                                      build_spmv2_meta,
                                                      spmv2_local,
                                                      validate_spmv2_meta)
from graphtap_tpu_torch.kernels.onehot_spmv import (PallasPlan,
                                                    build_onehot_plan,
                                                    spmv_onehot,
                                                    validate_pallas_plan)
from graphtap_tpu_torch.kernels.panel_engine import spmv3_stages
from graphtap_tpu_torch.kernels.panel_meta import (Spmv3Meta,
                                                   build_spmv3_meta,
                                                   validate_meta)
from graphtap_tpu_torch.kernels.shuffle_engine import (
    ShufflePlans, build_shuffle_plans, spmv_local, validate_shuffle_plans)
from graphtap_tpu_torch.kernels.spmv import (expand_compact, spmv_segment,
                                             spmv_sorted_scan)
from graphtap_tpu_torch.parallel import multihost as mh
from graphtap_tpu_torch.tools.convert import meta_from_numpy

KERNELS = ("scan", "segment", "onehot", "shuffle", "shuffle2", "panel")
# kernel -> (plans type, build function, validator)
_PLANNERS = {"panel": (Spmv3Meta, build_spmv3_meta, validate_meta),
             "shuffle": (ShufflePlans, build_shuffle_plans,
                         validate_shuffle_plans),
             "shuffle2": (Spmv2Meta, build_spmv2_meta, validate_spmv2_meta),
             "onehot": (PallasPlan, build_onehot_plan,
                        validate_pallas_plan)}
# kernel -> the function that keeps its float folds' tables (and shuffle's
# K7 index) in the upload
_FOLD_TABLES = {"panel": panel_engine.fold_tables,
                "shuffle": shuffle_engine.fold_tables,
                "shuffle2": gather_engine.fold_tables,
                "onehot": onehot_spmv.fold_tables}
MAX_CONVERGENCE_ITERS = 1 << 20     # as the JAX package's executor
CF_PHASES = ("first", "middle", "last")
GATE_ENV = "GRAPHTAP_PANEL_GATE"
_GATE_MODES = {"auto": "auto", "1": True, "0": False}


def gate_mode(value: Optional[str]):
    """The panel gate of a ``GRAPHTAP_PANEL_GATE`` value: unset or "auto"
    -> "auto" (the per-superstep panel-activity vote), "1" -> gated,
    "0" -> static; anything else raises."""
    if value is None:
        return "auto"
    if value not in _GATE_MODES:
        raise ValueError(f"{GATE_ENV}={value!r}: expected one of "
                         f"{sorted(_GATE_MODES)} or unset")
    return _GATE_MODES[value]


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev}: CUDA is not available")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _nbytes(dev: Dict) -> int:
    return sum(v.numel() * v.element_size() for v in dev.values()
               if isinstance(v, torch.Tensor))


def _transport(mesh, device: torch.device) -> Optional[str]:
    """How the exchanges move data: None without a mesh; 'nccl' (the CUDA
    tensors themselves); 'gloo' (CPU tensors) or 'gloo-host' (CUDA
    tensors copied to the host and back)."""
    if mesh is None:
        return None
    if mesh.backend == "nccl":
        if device.type != "cuda":
            raise ValueError("an nccl mesh exchanges CUDA tensors; the "
                             "executor's device is the CPU")
        return "nccl"
    return "gloo-host" if device.type == "cuda" else "gloo"


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def _fenced(timer, name: str, device: torch.device):
    """``timer``'s phase ``name``, closed by a device synchronize (no
    timer: nothing)."""
    if timer is None:
        yield
        return
    with timer.phase(name):
        yield
        _sync(device)


class Executor:
    """Runs one VertexProgram over this rank's shard of one TileSet (the
    graph's mesh; without one, the whole 1x1 TileSet on one device).

    ``kernel``: 'panel' (the v3 panel-route pipeline, K1-K4), 'shuffle'
    (the v1 shuffle pipeline, K6-K8), 'shuffle2' (the v2 windowed-gather
    pipeline, K9 and K8), 'onehot' (the blocked one-hot reduce, K5, after
    a torch gather and ⊗), 'segment' or 'scan' (portable torch SpMVs);
    only 'panel' is ever gated, as in the JAX package. ``plans``: prebuilt
    plans of this graph's tiles (a ``Spmv3Meta`` for 'panel', a
    ``ShufflePlans`` for 'shuffle', a ``Spmv2Meta`` for 'shuffle2', a
    ``PallasPlan`` for 'onehot', e.g. from ``tools/artifact_cache.py``),
    validated here, else built here. ``phase_plans``: on a TCSC_CF graph,
    prebuilt plans of the "first", "middle" and "last" phase tiles (any
    of them; the rest are built), validated as ``plans`` is.
    ``tiles``: a prebuilt TileSet of this graph (e.g. the TCSC tiles of a
    TCSC_CF graph, which then runs as TCSC), else the graph's tiles of
    the engine's ordering; the format is the tiles' compression.
    ``device``: 'cuda' (the default) or 'cpu', where the kernels run
    their plain versions; without CUDA a 'cuda' executor raises.
    ``GRAPHTAP_PANEL_GATE`` is read once, here (``gate_mode``); it sets
    ``gate``, the panel pipeline's gating for nonstationary programs
    (stationary ones always run it static).
    ``timings`` records the host phases and the last ``execute`` in
    seconds (the latter after a device synchronize; the TCSC_CF phases'
    tiles, plans and upload under ``cf_tiles``, ``cf_plans``,
    ``cf_upload``). ``supersteps`` lists the last ``execute``'s
    supersteps: the tile phase each ran (``phase``: "main", or a TCSC_CF
    phase), the branch its SpMV took (``gated``: True/False on 'panel',
    None on the other kernels), the branches of its sparse exchange
    (``sparse`` for x, ``sparse_y`` for y: True/False, None where the
    exchange is dense by rule) and, on a CUDA device, its time by CUDA
    events (``ms``; None on the CPU); the flush of convergence mode is not
    among them. ``device_bytes`` is the size of the arrays this rank
    uploaded for the superstep (its row of the tiles or plans, and the
    fold lists and scratch of K3, K5 and K8), those of the TCSC_CF phases
    included once they are built. ``exchange`` names the exchanges'
    transport (``_transport``). ``exchange_bytes`` counts the bytes the
    exchanges moved on this rank since the last superstep began (the
    flush of convergence mode included); each superstep's own are its
    ``bytes`` (``_tally``)."""

    def __init__(self, graph: Graph, program: VertexProgram,
                 engine: Optional[EngineConfig] = None, kernel: str = "scan",
                 plans=None, device="cuda", phase_plans=None,
                 tiles: Optional[TileSet] = None):
        self.device = _device(device)
        if kernel not in KERNELS:
            raise ValueError(f"unknown kernel {kernel!r}; use one of "
                             f"{KERNELS}")
        self.graph = graph
        self.program = program
        self.engine = engine or EngineConfig(stationary=program.stationary)
        mode = gate_mode(os.environ.get(GATE_ENV))
        self.gate = False if program.stationary else mode
        self.kernel = kernel
        self.part = graph.part
        self.mesh = graph.mesh
        self.shard = mh.shard_of(self.part, self.mesh)
        self.exchange = _transport(self.mesh, self.device)
        self.timings: Dict[str, float] = {}
        self._phase_plans = dict(phase_plans or {})
        t0 = time.perf_counter()
        self.tiles = tiles if tiles is not None \
            else graph.tiled(self.engine.ordering)
        self.timings["tiles"] = time.perf_counter() - t0
        comp = self.tiles.compression
        # the JAX executor's format rules (its executor.py:88-104)
        self._renumber = self.tiles.ir is not None
        if comp == Compression.DCSC and kernel not in ("scan", "segment"):
            raise ValueError("DCSC (compact col ids + JC gather) is a "
                             "kernel-lab format; only the scan/segment "
                             "kernels consume it")
        if kernel == "shuffle" and not self._renumber:
            raise ValueError("shuffle kernel requires TCSC compression")
        self._apply_i_mask = comp in (Compression.TCSC, Compression.TCSC_CF)
        self.is_cf = comp == Compression.TCSC_CF
        if phase_plans and (not self.is_cf
                            or set(phase_plans) - set(CF_PHASES)):
            raise ValueError(f"phase_plans: {sorted(phase_plans)}; only a "
                             f"TCSC_CF graph takes plans of {CF_PHASES}")
        t0 = time.perf_counter()
        self.meta = self._plans(self.tiles, plans)
        if self.meta is not None:
            self.timings["plans"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        self._dev = self._upload(self.tiles, self.meta)
        self.device_bytes = _nbytes(self._dev)
        _sync(self.device)
        self.timings["upload"] = time.perf_counter() - t0
        # tile phase -> (tiles, plans, device arrays); the TCSC_CF phases
        # join at the first run that needs them (_cf_phases)
        self._phases = {"main": (self.tiles, self.meta, self._dev)}
        self.state: Optional[State] = None
        self.changed: Optional[torch.Tensor] = None
        self.iteration = 0
        self.supersteps: List[Dict] = []
        self.exchange_bytes: Dict[str, List[int]] = {}

    # ------------------------------------------------------------------ util
    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _plans(self, tiles: TileSet, plans):
        """The kernel's plans of ``tiles``: ``plans`` validated, or built;
        None for the kernels that read the tiles themselves."""
        if self.kernel not in _PLANNERS:
            return None
        kind, build, validate = _PLANNERS[self.kernel]
        if plans is None:
            return build(tiles,
                         value_dtype=numpy_dtype(self.program.value_dtype))
        if not isinstance(plans, kind):
            raise TypeError(f"kernel {self.kernel!r} takes {kind.__name__} "
                            f"plans, got {type(plans).__name__}")
        if self.kernel == "onehot":
            validate(plans, self.part.tile_cols)
        else:
            validate(plans)
        return plans

    def _upload(self, tiles: TileSet, meta) -> Dict[str, torch.Tensor]:
        """The device-resident arrays the superstep reads: this rank's row
        of the tiles' leading device axis, or its plans."""
        b = self.shard
        dev = {"i_own": self._tensor(tiles.i_own[b]),
               "vids": self._tensor(self.part.owner_vids()[b])}
        if self.kernel in _PLANNERS:
            dev.update(meta_from_numpy(meta.arrays, self.device))
            # the fixed-order float folds' lists and scratch (K3, K5, K8),
            # and K7's composed index
            _FOLD_TABLES[self.kernel](dev, meta, self.program.value_dtype)
            if self.kernel == "onehot" and tiles.iv_dense is not None:
                dev["iv_dense"] = self._tensor(tiles.iv_dense[b])
            return dev
        n = int(tiles.nnz[b, 0])
        dev.update(rows=self._tensor(tiles.rows[b].astype(np.int64)),
                   cols=self._tensor(tiles.cols[b].astype(np.int64)),
                   ja=self._tensor(tiles.ja[b]), nnz=n)
        for k in ("iv_dense", "jc", "weights"):
            if getattr(tiles, k) is not None:
                dev[k] = self._tensor(getattr(tiles, k)[b])
        return dev

    def _cf_phases(self) -> None:
        """Build and upload the TCSC_CF phases once (reference:
        compressed_column.hpp:606-1120): each phase's tiles, plans and
        apply mask (regular rows for first and middle, regular | source
        rows for last)."""
        if "first" in self._phases:
            return
        t0 = time.perf_counter()
        cf = self.graph.tiled_cf(self.engine.ordering)
        self.timings["cf_tiles"] = time.perf_counter() - t0
        full = cf["full"]
        masks = {"first": full.regular_own, "middle": full.regular_own,
                 "last": full.regular_own | full.source_own}
        self.timings["cf_plans"] = self.timings["cf_upload"] = 0.0
        for ph in CF_PHASES:
            t0 = time.perf_counter()
            meta = self._plans(cf[ph], self._phase_plans.pop(ph, None))
            t1 = time.perf_counter()
            dev = self._upload(cf[ph], meta)
            dev["apply_mask"] = self._tensor(masks[ph][self.shard])
            self.device_bytes += _nbytes(dev)
            _sync(self.device)
            self.timings["cf_plans"] += t1 - t0
            self.timings["cf_upload"] += time.perf_counter() - t1
            self._phases[ph] = (cf[ph], meta, dev)

    # ------------------------------------------------------------- lifecycle
    def initialize(self, other: Optional["Executor"] = None) -> None:
        """Build this rank's initial state (reference: initialize(),
        :444-503); the handoff variant takes the predecessor's final state
        (:467-483), which lies on this rank: both programs share one
        partition."""
        rows = slice(self.shard, self.shard + 1)
        vids = self.part.owner_vids()[rows]
        other_state = None
        if other is not None:
            other_state = {k: v.cpu().numpy()[None]
                           for k, v in other.state.items()}
        state_np, changed_np = self.program.init(vids, self.tiles.i_own[rows],
                                                 other_state)
        self.state = {k: self._tensor(np.asarray(v)[0])
                      for k, v in state_np.items()}
        valid = vids < self.graph.nv
        self.changed = self._tensor((np.asarray(changed_np, dtype=bool)
                                     & valid)[0])
        self.iteration = 0

    def free(self) -> None:
        """Release the device-resident tiles and plans of every phase
        (reference: Vertex_Program::free(), vertex_program.hpp:47-54). The
        state stays, so a successor can still ``initialize(other=self)``;
        ``execute`` after ``free`` raises."""
        self._dev = None
        self.meta = None
        self._phases = None
        self._phase_plans = {}

    # -------------------------------------------------------------- exchange
    def _wire(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` on the group's device (the host for 'gloo-host')."""
        t = t.contiguous()
        return t.cpu() if self.exchange == "gloo-host" else t

    def _home(self, t: torch.Tensor) -> torch.Tensor:
        return t.to(self.device) if self.exchange == "gloo-host" else t

    def _tally(self, collective: str, members: int, part: torch.Tensor
               ) -> None:
        """Count one collective in ``exchange_bytes``: [sent, received],
        this rank's ``part`` to each other member of its group and as many
        bytes back (the data's bytes, whatever the transport's algorithm
        moves; the votes' all-reduces are not counted)."""
        n = (members - 1) * part.numel() * part.element_size()
        sent, received = self.exchange_bytes.get(collective, (0, 0))
        self.exchange_bytes[collective] = [sent + n, received + n]

    def _gather_x(self, t: torch.Tensor) -> torch.Tensor:
        """(n,) -> (R*n,): every mesh-column member's ``t``, in i order."""
        if self.mesh is None:
            return t
        import torch.distributed as dist
        self._tally("all_gather_x", self.part.R, t)
        src = self._wire(t)
        out = torch.empty(self.part.R * src.numel(), dtype=src.dtype,
                          device=src.device)
        dist.all_gather_into_tensor(out, src, group=self.mesh.xgroup)
        return self._home(out)

    def _all_to_all_y(self, t: torch.Tensor) -> torch.Tensor:
        """(C, n) -> (C, n): part k goes to mesh-row member k, and part k
        of the result came from it."""
        if self.mesh is None:
            return t
        import torch.distributed as dist
        self._tally("all_to_all_y", self.part.C, t[0])
        src = self._wire(t)
        out = torch.empty_like(src)
        dist.all_to_all_single(out, src, group=self.mesh.ygroup)
        return self._home(out)

    def _count(self, flag: torch.Tensor, group: str) -> int:
        """The number of the mesh ``group``'s members ("xgroup", "ygroup"
        or "world") whose ``flag`` is set: one all-reduce, read to the
        host."""
        t = flag.to(torch.int32).reshape(1)
        if self.mesh is None:
            return int(t.item())
        import torch.distributed as dist
        t = self._wire(t)
        dist.all_reduce(t, group=getattr(self.mesh, group))
        return int(t.item())

    def _sparse_k(self) -> int:
        """The sparse exchange's capacity, capped at L; 0: dense."""
        K = self.engine.sparse_exchange_capacity
        return 0 if self.program.stationary else min(K, self.part.L)

    def _exchange_x(self, m: torch.Tensor, c: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, Optional[bool]]:
        """Messages -> the x block of the tile's columns (R*L,): an
        all-gather over the mesh column; or, with the sparse exchange and
        the frontier ``c``, its (index, value) pairs when every member's
        frontier fits in K (reference :865-966). Returns (x, the sparse
        branch: True/False, None if dense by rule)."""
        K = self._sparse_k() if c is not None else 0
        if not K:
            return self._gather_x(m), None
        R, L = self.part.R, self.part.L
        nact = c.sum()
        if self._count(nact <= K, "xgroup") != R:
            return self._gather_x(m), False
        idx = torch.argsort((~c).to(torch.uint8), stable=True)[:K]
        val = m[idx]
        ok = torch.arange(K, device=m.device) < nact
        idx = torch.where(ok, idx, R * L).to(torch.int32)
        gidx = self._gather_x(idx).view(R, K).long()
        gval = self._gather_x(val).view(R, K)
        off = torch.arange(R, device=m.device).view(R, 1) * L
        gi = torch.where(gidx < L, gidx + off, R * L)      # R*L: parked
        x = torch.full((R * L + 1,), self.program.semiring.identity,
                       dtype=m.dtype, device=m.device)
        x[gi.reshape(-1)] = gval.reshape(-1)
        return x[:R * L], True

    def _fold_parts(self, parts: torch.Tensor) -> torch.Tensor:
        """(C, L) received partials -> their ⊕-fold, in shard order."""
        add = self.program.semiring.add
        y = parts[0]
        for k in range(1, parts.shape[0]):
            y = add(y, parts[k])
        return y

    def _exchange_y(self, y_dense: torch.Tensor
                    ) -> Tuple[torch.Tensor, Optional[bool]]:
        """Partial y (C*L,) -> the owner's segment (L,): an all-to-all over
        the mesh row and a ⊕-fold of the parts in shard order; or, with
        the sparse exchange on a min/max semiring, the active (index,
        value) pairs ⊕-scattered when every member's parts fit in K
        (reference :912-966, :1543-1573). Returns (y, the sparse branch:
        True/False, None if dense by rule)."""
        sem, C, L = self.program.semiring, self.part.C, self.part.L
        y2 = y_dense.view(C, L)
        K = self._sparse_k() if sem.reduce_kind != "sum" else 0
        if not K:
            return self._fold_parts(self._all_to_all_y(y2)), None
        act = y2 != sem.identity
        nact = act.sum(dim=1)
        if self._count(nact.max() <= K, "ygroup") != C:
            return self._fold_parts(self._all_to_all_y(y2)), False
        idx = torch.argsort((~act).to(torch.uint8), dim=1, stable=True)[:, :K]
        val = torch.gather(y2, 1, idx)
        ok = torch.arange(K, device=y2.device).view(1, K) < nact.view(C, 1)
        idx = torch.where(ok, idx, L).to(torch.int32)      # L: parked
        gi = self._all_to_all_y(idx).reshape(-1).long()
        gv = self._all_to_all_y(val).reshape(-1)
        y = torch.full((L + 1,), sem.identity, dtype=y2.dtype,
                       device=y2.device)
        y.scatter_reduce_(0, gi, gv, "amin" if sem.reduce_kind == "min"
                          else "amax", include_self=True)
        return y[:L], True

    def _voted(self, C: torch.Tensor) -> bool:
        """The convergence vote: every rank's vertices unchanged (one
        all-reduce over the world, read to the host)."""
        if self.mesh is None:
            return not bool(C.any())
        return self._count(~C.any(), "world") == self.part.D

    # ------------------------------------------------------------- superstep
    def _combine(self, x: torch.Tensor, phase: str
                 ) -> Tuple[torch.Tensor, Optional[bool]]:
        """Tile SpMV of ``phase``'s tiles -> (the dense row block (C*L,),
        whether the panel pipeline ran gated; None on the other kernels,
        which are never gated, as in the JAX package) (reference: combine,
        vertex_program.hpp:1017-1573). The compact y of renumbered (TCSC)
        tiles is expanded to the dense block; CSC and DCSC rows are dense
        already."""
        tiles, meta, d = self._phases[phase]
        sem, n = self.program.semiring, self.part.tile_rows
        if self.kernel == "panel":
            st = spmv3_stages(x, d, meta, sem, dense_len=n, gate=self.gate)
            return st["y"], st["gated"]
        if self.kernel == "shuffle":
            return spmv_local(x, d, meta, sem, dense_len=n), None
        if self.kernel == "shuffle2":
            return spmv2_local(x, d, meta, sem, dense_len=n), None
        if self.kernel == "onehot":
            y = spmv_onehot(x, d, meta, sem, tiles.NR)
        else:
            if "jc" in d:
                # DCSC: cols hold compact nnz-col ids; gather x through JC
                # first (reference: dcsc_spmv.hpp:216-230)
                x = torch.index_select(x, 0, d["jc"])
            if self.kernel == "segment":
                y = spmv_segment(x, d["rows"], d["cols"], d.get("weights"),
                                 d["nnz"], tiles.NR, sem)
            else:
                y = spmv_sorted_scan(x, d["rows"], d["cols"],
                                     d.get("weights"), d["nnz"], d["ja"],
                                     sem)
        if self._renumber:
            y = expand_compact(y, d["iv_dense"], sem)
        return y, None

    def _apply(self, V: State, y_own: torch.Tensor, it: int,
               phase: str) -> Tuple[State, torch.Tensor]:
        """(reference: apply_*, vertex_program.hpp:1610-1802): a TCSC_CF
        phase applies where its apply mask is (:1671-1692), TCSC and
        TCSC_CF's main tiles only where the I bit is set (:1655-1670), CSC
        and DCSC everywhere; padding vertices never vote."""
        V2, changed = self.program.applicator(V, y_own, it)
        mask = self._phases[phase][2].get("apply_mask")
        if mask is None and self._apply_i_mask:
            mask = self._dev["i_own"]
        if mask is not None:
            V2 = {k: torch.where(mask, v2, V[k]) for k, v2 in V2.items()}
            changed = changed & mask
        return V2, changed & (self._dev["vids"] < self.graph.nv)

    def _messages(self, V: State, C: torch.Tensor) -> torch.Tensor:
        """Outgoing messages; a nonstationary program's are the
        ⊕-identity outside the frontier C (reference :688-758)."""
        prog = self.program
        m = prog.messenger(V).to(prog.value_dtype)
        if not prog.stationary:
            m = torch.where(C, m, prog.semiring.identity_like(m.dtype,
                                                              m.device))
        return m

    def _step(self, V: State, m: torch.Tensor, it: int, phase: str,
              timer=None, c: Optional[torch.Tensor] = None
              ) -> Tuple[State, torch.Tensor, Dict]:
        """Exchange x (sparse only given the frontier ``c`` of ``m``),
        combine, exchange y, apply -> (V', C', the branches taken:
        ``gated``, ``sparse``, ``sparse_y``); ``timer`` (a
        ``PhaseTimer``) times each exchange, combine and apply, fenced."""
        with _fenced(timer, "exchange", self.device):
            x, sparse = self._exchange_x(m, c)
        with _fenced(timer, "combine", self.device):
            y, gated = self._combine(x, phase)
        with _fenced(timer, "exchange", self.device):
            y_own, sparse_y = self._exchange_y(y)
        with _fenced(timer, "apply", self.device):
            V2, C2 = self._apply(V, y_own, it, phase)
        return V2, C2, {"gated": gated, "sparse": sparse,
                        "sparse_y": sparse_y}

    def _superstep(self, V: State, C: torch.Tensor, it: int, phase: str,
                   timer=None) -> Tuple[State, torch.Tensor, torch.Tensor]:
        """One superstep, recorded in ``supersteps`` (its ms by CUDA events
        on the card, or, with a ``timer``, fenced on the host clock; its
        exchanges' ``bytes``); returns (V', C', its messages)."""
        self.exchange_bytes = {}
        ev = None
        if timer is None and self.device.type == "cuda":
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
        t0 = time.perf_counter()
        with _fenced(timer, "scatter_gather", self.device):
            m = self._messages(V, C)
        V2, C2, branches = self._step(V, m, it, phase, timer, c=C)
        rec = {"phase": phase, **branches, "ms": None,
               "bytes": dict(self.exchange_bytes)}
        if ev is not None:
            ev[1].record()
            rec["events"] = ev
        elif timer is not None:
            rec["ms"] = (time.perf_counter() - t0) * 1e3
        self.supersteps.append(rec)
        return V2, C2, m

    # ------------------------------------------------------------------ API
    def execute(self, num_iterations: Optional[int] = None) -> int:
        """Run ``num_iterations`` supersteps, or, for 0, supersteps to
        convergence and the flush (reference: execute(), :407-441);
        returns the iteration count (the flush not counted). On a TCSC_CF
        graph every run but a 1-iteration one runs the CF phases. Ends
        with a device synchronize, so ``timings['execute']`` is device
        time (the CF phases' first build is not in it)."""
        return self._run(num_iterations)

    def execute_profiled(self, num_iterations: int, timer=None,
                         printer=print):
        """``execute`` with per-phase timing and per-iteration progress
        (the reference's -DTIMING mode and its ``Iteration: n`` lines,
        vertex_program.hpp:422, :2134-2152); returns the ``PhaseTimer``
        (``tools/timing.py``), whose report ``printer`` gets last.

        Each superstep's scatter_gather (the messages), exchange (x, then
        y, each a sample; in convergence mode the vote a third), combine
        (the SpMV) and apply (the applicator) is timed on the host clock,
        each fenced by a device synchronize on the card; so is the flush of
        convergence mode (its exchanges, combine and apply). The run is
        ``execute``'s loop, so the result is its result bit for bit.
        ``supersteps`` records each superstep's fenced host ms."""
        from graphtap_tpu_torch.tools.timing import PhaseTimer
        timer = timer or PhaseTimer()
        self._run(num_iterations, timer, printer)
        if printer is not None:
            printer(timer.report())
        return timer

    def step_call(self):
        """One superstep of the current state as a call that records
        nothing and leaves the state as it is (it returns (V', C')): what
        ``tools/timing.py::device_ms`` replays as a CUDA graph."""
        V, C = self.state, self.changed
        return lambda: self._step(V, self._messages(V, C), 0, "main",
                                  c=C)[:2]

    def _run(self, num_iterations, timer=None, printer=None) -> int:
        """The superstep loop of ``execute`` and ``execute_profiled``;
        ``printer`` gets an ``Iteration: n`` line after each superstep."""
        if self._dev is None:
            raise RuntimeError("execute() after free()")
        if self.state is None:
            self.initialize()
        niters = self.engine.num_iterations if num_iterations is None \
            else num_iterations
        cf = self.is_cf and (not niters or niters > 1)
        if cf:
            self._cf_phases()
        self.supersteps = []
        t0 = time.perf_counter()
        V, C = self.state, self.changed
        converge = not (niters and niters > 0)
        it, converged = 0, False
        while not converged and it < (MAX_CONVERGENCE_ITERS if converge
                                      else niters):
            phase = ("main" if not cf else "first" if it == 0
                     else "last" if not converge and it == niters - 1
                     else "middle")
            V, C, m = self._superstep(V, C, it, phase, timer)
            it += 1
            if printer is not None:
                printer(f"Iteration: {it}")
            if converge:
                with _fenced(timer, "exchange", self.device):
                    converged = self._voted(C)      # a host read
        if converge:
            # one extra combine + apply on the last superstep's messages,
            # to flush source/sink contributions (reference :425-429); their
            # x is exchanged dense
            V, C, _ = self._step(V, m, it, "last" if cf else "main", timer)
        self.iteration = it
        self.state, self.changed = V, C
        _sync(self.device)
        self.timings["execute"] = time.perf_counter() - t0
        for rec in self.supersteps:
            ev = rec.pop("events", None)
            if ev is not None:
                rec["ms"] = ev[0].elapsed_time(ev[1])
        return self.iteration

    # -------------------------------------------------------------- oracles
    def state_vector(self) -> Dict[str, np.ndarray]:
        """Full state in vertex-id order, truncated to nv, gathered from
        every rank (``multihost.allgather_state``; every rank must call
        it, and every rank gets it)."""
        return {k: self.part.to_vertex_order(
                    mh.allgather_state(v, self.mesh))[: self.graph.nv]
                for k, v in self.state.items()}

    def checksum(self) -> Tuple[float, int]:
        """(value checksum, reachable count) (reference: checksum(),
        :1927-1960)."""
        vals = np.asarray(self.program.get_state(self.state_vector()))
        mask = vals != self.program.infinity()
        return float(vals[mask].astype(np.float64).sum()), int(mask.sum())

    def stats(self) -> Dict[str, float]:
        """Distribution statistics over the reachable states (reference:
        checksum1(), vertex_program.hpp:1963-2119; ``tools/oracle.py``)."""
        from graphtap_tpu_torch.tools.oracle import state_stats
        vals = np.asarray(self.program.get_state(self.state_vector()))
        return state_stats(vals, self.program.infinity())

    def display(self, count: int = 31) -> str:
        """First ``count`` vertex states (reference: display(),
        :2124-2181)."""
        sv = self.state_vector()
        lines = []
        for vid in range(min(count, self.graph.nv)):
            row = {k: v[vid] for k, v in sv.items()}
            lines.append(f"vid={vid}: {self.program.format_state(row)}")
        return "\n".join(lines)
