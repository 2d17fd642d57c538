"""Phase timing instrumentation.

Counterpart of ``graphtap_tpu/tools/timing.py``: the analog of the
reference's -DTIMING per-phase vectors (vertex_program.hpp:202-208)
printed as sum/mean/std (:2134-2152). ``Executor.execute_profiled`` times
each phase of a superstep on the host clock, each phase fenced by a
device synchronize on the card (for profiling, not production: the
fences cost the overlap the plain loop keeps).

Beside it, the kernel launch counts of the SpMV paths (``launches``,
``reset_launches``) and the device-only timing that ``chip_smoke.py`` and
``tools/ring_times.py`` hold kernels and their PyTorch calls to:
``device_ms`` (calls replayed as one CUDA graph), and ``take_call`` /
``slot_ids``, which turn a pure gather into one ``torch.take``.
"""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict, List

import numpy as np
import torch


class PhaseTimer:
    def __init__(self):
        self.samples: Dict[str, List[float]] = defaultdict(list)

    @contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.samples[name].append(time.perf_counter() - t0)

    def report(self) -> str:
        lines = []
        for name, xs in self.samples.items():
            a = np.asarray(xs)
            lines.append(
                f"{name}: sum={a.sum()*1e3:.3f}ms "
                f"mean={a.mean()*1e3:.3f}ms std={a.std()*1e3:.3f}ms "
                f"n={a.size}")
        return "\n".join(lines)


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
