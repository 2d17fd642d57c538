"""Executor: the BSP superstep loop on one device.

Counterpart of ``graphtap_tpu/engine/executor.py`` for a 1x1 mesh
(reference: Vertex_Program::execute, vertex_program.hpp:407-441). One
superstep is messenger -> exchange x -> combine (the SpMV) -> exchange y
-> apply (masked to the I rows under TCSC, :1655-1670). On one device
both exchanges are the identity; they assert the 1x1 layout instead of
running a collective.

Ported: fixed-iteration mode on TCSC tiles, the ``scan`` and ``panel``
kernels, ``initialize(other=)`` with the I-masked handoff, ``free()`` and
the oracles (``state_vector``, ``checksum``, ``display``). Convergence
mode, nonstationary programs, other tile formats (CSC, DCSC, TCSC_CF)
and the mesh raise ``NotImplementedError`` until a later version ports
them.
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from graphtap_tpu_torch.config import Compression, EngineConfig
from graphtap_tpu_torch.engine.program import State, VertexProgram, \
    numpy_dtype
from graphtap_tpu_torch.ingest.graph import Graph
from graphtap_tpu_torch.kernels.panel_engine import spmv3_local
from graphtap_tpu_torch.kernels.panel_meta import (Spmv3Meta,
                                                   build_spmv3_meta,
                                                   validate_meta)
from graphtap_tpu_torch.kernels.spmv import expand_compact, spmv_sorted_scan
from graphtap_tpu_torch.tools.convert import meta_from_numpy

KERNELS = ("scan", "panel")


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev}: CUDA is not available")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Executor:
    """Runs one VertexProgram over one TileSet on one device.

    ``kernel``: 'panel' (the v3 panel-route pipeline, K1-K4) or 'scan'
    (portable torch SpMV). ``plans``: a prebuilt ``Spmv3Meta`` of this
    graph's tiles for 'panel' (e.g. from ``tools/artifact_cache.py``),
    else built here.
    ``timings`` records the host phases and the last ``execute`` in
    seconds (the latter after a device synchronize)."""

    def __init__(self, graph: Graph, program: VertexProgram,
                 engine: Optional[EngineConfig] = None, kernel: str = "scan",
                 plans: Optional[Spmv3Meta] = None, device="cpu"):
        self.device = _device(device)
        if kernel not in KERNELS:
            raise NotImplementedError(f"kernel {kernel!r} is not ported; "
                                      f"use one of {KERNELS}")
        if not program.stationary:
            raise NotImplementedError("nonstationary programs are not "
                                      "ported yet")
        if graph.config.compression != Compression.TCSC:
            raise NotImplementedError(
                f"{graph.config.compression} tiles are not ported yet")
        self.graph = graph
        self.program = program
        self.engine = engine or EngineConfig(stationary=program.stationary)
        self.kernel = kernel
        self.part = graph.part
        self.timings: Dict[str, float] = {}
        t0 = time.perf_counter()
        self.tiles = graph.tiled(self.engine.ordering)
        self.timings["tiles"] = time.perf_counter() - t0
        self.meta: Optional[Spmv3Meta] = None
        if kernel == "panel":
            t0 = time.perf_counter()
            if plans is None:
                plans = build_spmv3_meta(
                    self.tiles, value_dtype=numpy_dtype(program.value_dtype))
            else:
                validate_meta(plans)
            self.meta = plans
            self.timings["plans"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        self._dev = self._upload()
        _sync(self.device)
        self.timings["upload"] = time.perf_counter() - t0
        self.state: Optional[State] = None
        self.changed: Optional[torch.Tensor] = None
        self.iteration = 0

    # ------------------------------------------------------------------ util
    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _upload(self) -> Dict[str, torch.Tensor]:
        """The device-resident arrays the superstep reads (device 0 of the
        tiles' leading device axis)."""
        ts = self.tiles
        dev = {"i_own": self._tensor(ts.i_own[0]),
               "vids": self._tensor(self.part.owner_vids()[0])}
        if self.kernel == "panel":
            dev.update(meta_from_numpy(self.meta.arrays, self.device))
            return dev
        n = int(ts.nnz[0, 0])
        dev.update(rows=self._tensor(ts.rows[0].astype(np.int64)),
                   cols=self._tensor(ts.cols[0].astype(np.int64)),
                   ja=self._tensor(ts.ja[0]), nnz=n,
                   iv_dense=self._tensor(ts.iv_dense[0]))
        if ts.weights is not None:
            dev["weights"] = self._tensor(ts.weights[0])
        return dev

    # ------------------------------------------------------------- lifecycle
    def initialize(self, other: Optional["Executor"] = None) -> None:
        """Build the initial state (reference: initialize(), :444-503); the
        handoff variant takes the predecessor's final state (:467-483)."""
        vids = self.part.owner_vids()
        other_state = None
        if other is not None:
            other_state = {k: v.cpu().numpy()[None]
                           for k, v in other.state.items()}
        state_np, changed_np = self.program.init(vids, self.tiles.i_own,
                                                 other_state)
        self.state = {k: self._tensor(np.asarray(v)[0])
                      for k, v in state_np.items()}
        valid = vids < self.graph.nv
        self.changed = self._tensor((np.asarray(changed_np, dtype=bool)
                                     & valid)[0])
        self.iteration = 0

    def free(self) -> None:
        """Release the device-resident tiles and plans (reference:
        Vertex_Program::free(), vertex_program.hpp:47-54). The state stays,
        so a successor can still ``initialize(other=self)``; ``execute``
        after ``free`` raises."""
        self._dev = None
        self.meta = None

    # ------------------------------------------------------------- superstep
    def _exchange_x(self, m: torch.Tensor) -> torch.Tensor:
        """Messages -> the x block of the tile's columns: an all-gather
        along the mesh rows, the identity on one device."""
        if self.part.R != 1:
            raise NotImplementedError("mesh exchange is not ported yet")
        return m

    def _exchange_y(self, y_dense: torch.Tensor) -> torch.Tensor:
        """Partial y -> the owner's segment: a reduce-scatter along the
        mesh cols, the identity on one device."""
        if self.part.C != 1:
            raise NotImplementedError("mesh exchange is not ported yet")
        return y_dense

    def _combine(self, x: torch.Tensor) -> torch.Tensor:
        """Tile SpMV -> the dense row block (C*L,) (reference: combine,
        vertex_program.hpp:1017-1573)."""
        sem, d = self.program.semiring, self._dev
        if self.kernel == "panel":
            return spmv3_local(x, d, self.meta, sem,
                               dense_len=self.part.tile_rows)
        y = spmv_sorted_scan(x, d["rows"], d["cols"], d.get("weights"),
                             d["nnz"], d["ja"], sem)
        return expand_compact(y, d["iv_dense"], sem)

    def _apply(self, V: State, y_own: torch.Tensor,
               it: int) -> Tuple[State, torch.Tensor]:
        """(reference: apply_*, vertex_program.hpp:1610-1802): TCSC applies
        only where the I bit is set (:1655-1670)."""
        V2, changed = self.program.applicator(V, y_own, it)
        mask = self._dev["i_own"]
        V2 = {k: torch.where(mask, v2, V[k]) for k, v2 in V2.items()}
        changed = changed & mask
        return V2, changed & (self._dev["vids"] < self.graph.nv)

    def _superstep(self, V: State, it: int) -> Tuple[State, torch.Tensor]:
        prog = self.program
        m = prog.messenger(V).to(prog.value_dtype)
        x = self._exchange_x(m)
        y_own = self._exchange_y(self._combine(x))
        return self._apply(V, y_own, it)

    # ------------------------------------------------------------------ API
    def execute(self, num_iterations: Optional[int] = None) -> int:
        """Run ``num_iterations`` supersteps (reference: execute(),
        :407-441); returns the iteration count. Ends with a device
        synchronize, so ``timings['execute']`` is device time."""
        if self._dev is None:
            raise RuntimeError("execute() after free()")
        if self.state is None:
            self.initialize()
        niters = self.engine.num_iterations if num_iterations is None \
            else num_iterations
        if not niters or niters <= 0:
            raise NotImplementedError("convergence mode is not ported yet")
        t0 = time.perf_counter()
        V, C = self.state, self.changed
        for it in range(niters):
            V, C = self._superstep(V, it)
        self.state, self.changed = V, C
        self.iteration = niters
        _sync(self.device)
        self.timings["execute"] = time.perf_counter() - t0
        return self.iteration

    # -------------------------------------------------------------- oracles
    def state_vector(self) -> Dict[str, np.ndarray]:
        """Full state in vertex-id order, truncated to nv."""
        return {k: self.part.to_vertex_order(v.cpu().numpy()[None])
                [: self.graph.nv] for k, v in self.state.items()}

    def checksum(self) -> Tuple[float, int]:
        """(value checksum, reachable count) (reference: checksum(),
        :1927-1960)."""
        vals = np.asarray(self.program.get_state(self.state_vector()))
        mask = vals != self.program.infinity()
        return float(vals[mask].astype(np.float64).sum()), int(mask.sum())

    def display(self, count: int = 31) -> str:
        """First ``count`` vertex states (reference: display(),
        :2124-2181)."""
        sv = self.state_vector()
        lines = []
        for vid in range(min(count, self.graph.nv)):
            row = {k: v[vid] for k, v in sv.items()}
            lines.append(f"vid={vid}: {self.program.format_state(row)}")
        return "\n".join(lines)
