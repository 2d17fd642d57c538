"""Phase timing and tracing instrumentation.

Counterpart of ``graphtap_tpu/tools/timing.py``: the analog of the
reference's -DTIMING per-phase vectors (vertex_program.hpp:202-208)
printed as sum/mean/std (:2134-2152), grown into one in-memory tracer.

``Tracer`` keeps spans (name, start and end on ``time.perf_counter_ns``,
the enclosing span, a job id, a few attributes) and named counters, both
recorded where the engine's layers meet: ``Executor.initialize`` and its
one stage, ``initialize.program``, ``execute``, each superstep and its
phases, the host's waits on the device (the vote, the closing
synchronize), the tile build's stages (and each TCSC_CF phase subset,
``tiles.cf_subset``), the plans and the upload, and the TCSC_CF phases'
build (``cf_phases``; each CF superstep's edges in ``cf_phase_edges``). One
tracer at a time is open in the process (``with tracing() as tr:``);
``span`` and ``count`` record into it and, with none open, return a
shared null context and do nothing. A job id starts at each
``initialize``. Two switches: ``fence`` synchronizes the device before
each span closes (each span then holds its device work, at the cost of
the overlap the plain loop keeps); ``annotate`` also opens
``torch.profiler.record_function("gt." + name)`` around each span, so a
profiler's trace holds every span as an annotation on its own clock.
``PhaseTimer`` is the fenced mode, as ``Executor.execute_profiled``
uses it. Spans are recorded from one thread.

Beside it, the kernel launch counts of the SpMV paths (``launches``,
``reset_launches``) and the device-only timing of ``tools/ring_times.py``
and ``tools/bench.py``: ``device_ms`` (calls replayed as one CUDA graph),
and ``take_call`` / ``slot_ids``, with which ``ring_times`` turns a pure
gather into one ``torch.take``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np
import torch


@dataclasses.dataclass(slots=True)
class Span:
    """One recorded span: ``start`` and ``end`` in ``perf_counter_ns``
    (``end`` 0 while open), ``parent`` the index of the enclosing span in
    the tracer's ``spans`` (-1: a root), ``job`` the id of the job it
    belongs to (0 before the first ``initialize``)."""
    name: str
    start: int
    end: int
    parent: int
    job: int
    attrs: Optional[Dict]

    @property
    def seconds(self) -> float:
        return (self.end - self.start) * 1e-9


def _fence() -> None:
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


class _Open:
    """The context of one span being recorded; entering it returns its
    ``Span``."""
    __slots__ = ("tracer", "name", "new_job", "attrs", "span",
                 "annotation")

    def __init__(self, tracer: "Tracer", name: str, new_job: bool,
                 attrs: Dict):
        self.tracer, self.name = tracer, name
        self.new_job, self.attrs = new_job, attrs

    def __enter__(self) -> Span:
        tr = self.tracer
        if self.new_job:
            tr.job += 1
        self.annotation = None
        if tr.annotate:
            self.annotation = torch.profiler.record_function(
                "gt." + self.name)
            self.annotation.__enter__()
        stack = tr._stack
        self.span = Span(self.name, time.perf_counter_ns(), 0,
                         stack[-1] if stack else -1, tr.job,
                         self.attrs or None)
        stack.append(len(tr.spans))
        tr.spans.append(self.span)
        return self.span

    def __exit__(self, *exc) -> None:
        tr = self.tracer
        if tr.fence:
            _fence()
        self.span.end = time.perf_counter_ns()
        tr._stack.pop()
        if self.annotation is not None:
            self.annotation.__exit__(*exc)


class Tracer:
    """Spans and counters in memory (the module docstring); a context
    manager that opens it as the process's tracer, the one open before
    it restored at the exit."""

    def __init__(self, fence: bool = False, annotate: bool = False):
        self.fence, self.annotate = fence, annotate
        self.spans: List[Span] = []
        self.counters: Dict[str, int] = defaultdict(int)
        self.job = 0
        self._stack: List[int] = []
        self._outer: List[Optional[Tracer]] = []

    def __enter__(self) -> "Tracer":
        global _active
        self._outer.append(_active)
        _active = self
        return self

    def __exit__(self, *exc) -> None:
        global _active
        _active = self._outer.pop()

    def span(self, name: str, new_job: bool = False, **attrs) -> _Open:
        """A span ``name`` in this tracer (open or not); ``new_job``
        starts a job id first."""
        return _Open(self, name, new_job, attrs)

    def _sample_name(self, name: str) -> Optional[str]:
        return name

    @property
    def samples(self) -> Dict[str, List[float]]:
        """Seconds of each closed span by name, in the order the names
        first opened."""
        out: Dict[str, List[float]] = {}
        for sp in self.spans:
            key = self._sample_name(sp.name)
            if key is not None and sp.end:
                out.setdefault(key, []).append(sp.seconds)
        return out

    def summary(self) -> Dict:
        """``spans``: per name, its seconds (``s``), its seconds outside
        its child spans (``self_s``) and its count (``n``);
        ``counters``; ``jobs``: the jobs begun (each ``initialize``)."""
        child = [0] * len(self.spans)
        for sp in self.spans:
            if sp.end and sp.parent >= 0:
                child[sp.parent] += sp.end - sp.start
        spans: Dict[str, Dict] = {}
        for sp, c in zip(self.spans, child):
            if sp.end:
                d = spans.setdefault(sp.name, {"s": 0.0, "self_s": 0.0,
                                               "n": 0})
                d["s"] += sp.seconds
                d["self_s"] += (sp.end - sp.start - c) * 1e-9
                d["n"] += 1
        return {"spans": spans, "counters": dict(self.counters),
                "jobs": self.job}

    def report(self) -> str:
        lines = []
        for name, xs in self.samples.items():
            a = np.asarray(xs)
            lines.append(
                f"{name}: sum={a.sum()*1e3:.3f}ms "
                f"mean={a.mean()*1e3:.3f}ms std={a.std()*1e3:.3f}ms "
                f"n={a.size}")
        return "\n".join(lines)


class PhaseTimer(Tracer):
    """The tracer's fenced mode, as ``Executor.execute_profiled`` opens
    it: ``samples`` holds the superstep's phases under the names of the
    reference's vectors: ``scatter_gather`` (the messages), ``exchange``
    (x, y and the convergence vote, each its own sample), ``combine``
    (the SpMV) and ``apply``; and any span opened with ``phase``."""

    PHASES = {"scatter_gather": "scatter_gather", "exchange_x": "exchange",
              "exchange_y": "exchange", "vote": "exchange",
              "combine": "combine", "apply": "apply"}

    def __init__(self):
        super().__init__(fence=True)
        self._phases = dict(self.PHASES)

    def phase(self, name: str) -> _Open:
        self._phases[name] = name
        return self.span(name)

    def _sample_name(self, name: str) -> Optional[str]:
        return self._phases.get(name)


_active: Optional[Tracer] = None
_NULL = contextlib.nullcontext()


def tracing(fence: bool = False, annotate: bool = False) -> Tracer:
    """A new tracer; ``with tracing() as tr:`` opens it."""
    return Tracer(fence, annotate)


def current() -> Optional[Tracer]:
    """The open tracer, or None."""
    return _active


def span(name: str, new_job: bool = False, **attrs):
    """A span ``name`` (with ``attrs``) in the open tracer; with none
    open, a shared null context."""
    tr = _active
    if tr is None:
        return _NULL
    return _Open(tr, name, new_job, attrs)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the open tracer's counter ``name``."""
    tr = _active
    if tr is not None:
        tr.counters[name] += n


def _counting_modules():
    """The modules whose wrappers count their kernels' launches."""
    from graphtap_tpu_torch.kernels import (gather_kernels, onehot_spmv,
                                            panel_kernels, shuffle_kernels)
    return panel_kernels, shuffle_kernels, gather_kernels, onehot_spmv


def reset_launches() -> None:
    for mod in _counting_modules():
        mod.reset_launches()


def launches() -> Dict[str, int]:
    """The path kernels' launches counted since ``reset_launches`` (those
    launched at least once)."""
    return {k: v for mod in _counting_modules()
            for k, v in mod.LAUNCHES.items() if v}


def slot_ids(src: torch.Tensor) -> torch.Tensor:
    """int32 slot numbers in ``src``'s shape: a pure gather run on them
    gives, per output slot, the flat source slot it reads (-1: the fill)."""
    return torch.arange(src.numel(), dtype=torch.int32,
                        device=src.device).view(src.shape)


def take_call(src: torch.Tensor, idx: torch.Tensor, fill):
    """One torch.take over ``src`` extended by one fill element, the index
    ``idx`` (-1: the fill) precomputed."""
    ext = torch.cat([src.reshape(-1), src.new_full((1,), fill)])
    idx = torch.where(idx >= 0, idx.long(), ext.numel() - 1)
    return lambda: torch.take(ext, idx)


def device_ms(fn, reps: int = 10, log=print):
    """Mean device-only time of one call: ``reps`` calls captured into one
    CUDA graph, replayed between two CUDA events (the lesser of two
    replays), so the card runs their kernels back to back with no host
    enqueue between them. None where a call reads a value back to the
    host (a synchronizing operation, found with the sync debug mode before
    any capture, and told to ``log``), which a graph cannot hold."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn()
    except RuntimeError as e:
        log(f"device time not measured: the call synchronizes ({e})")
        return None
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    best = None
    for _ in range(2):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / reps
        best = ms if best is None else min(best, ms)
    del graph
    return best
