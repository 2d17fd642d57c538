"""Phase timing instrumentation.

Counterpart of ``graphtap_tpu/tools/timing.py``: the analog of the
reference's -DTIMING per-phase vectors (vertex_program.hpp:202-208)
printed as sum/mean/std (:2134-2152). ``Executor.execute_profiled`` times
each phase of a superstep on the host clock, each phase fenced by a
device synchronize on the card (for profiling, not production: the
fences cost the overlap the plain loop keeps).
"""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict, List

import numpy as np


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
