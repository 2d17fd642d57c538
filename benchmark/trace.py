"""The traced run's device timeline: a few jobs under ``torch.profiler``
(CUPTI), reduced to the seconds in which the device ran an operation,
the operations that took most of it, and the idle gaps by what the host
was doing.

Only the traced run (``--trace 1``) profiles, and only after its window
has closed, so no measured window carries the profiler's cost.
"""

from __future__ import annotations

import json
import os
import tempfile
from collections import defaultdict
from typing import Callable, Dict, List, Tuple

import numpy as np

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "python_function")
JOB = "bench.job"
TOP = 10


def profile_jobs(run_job: Callable, n: int, sync) -> Dict:
    """Run ``n`` jobs (``run_job(i, span)``, where ``span(name)`` is an
    annotation the job opens around its own steps) under the profiler,
    each inside a ``bench.job`` annotation, and reduce the trace
    (``reduce``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        for i in range(n):
            with record_function(JOB):
                run_job(i, lambda name: record_function(f"bench.{name}"))
        sync()
    fd, path = tempfile.mkstemp(suffix=".json", prefix="bench_trace_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    del prof, torch
    return reduce(events)


def _merge(spans: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def reduce(events: List[Dict]) -> Dict:
    """From chrome-trace events (microseconds): ``window_s``, the first
    job's start to the last one's end; ``busy_s``, the union of the
    device operations inside it; ``device_ops``, the ten operation names
    with the most device seconds; ``idle_gaps``, the device's idle
    seconds inside the window grouped by the innermost host event running
    at each gap's middle, ten largest; ``kernels``, the distinct device
    operation names."""
    jobs = [(e["ts"], e["ts"] + e["dur"]) for e in events
            if e.get("ph") == "X" and e.get("name") == JOB
            and e.get("cat") in HOST_CATS]
    if not jobs:
        raise ValueError("the trace holds no job annotation")
    w0, w1 = min(s for s, _ in jobs), max(e for _, e in jobs)
    dev, by_name = [], defaultdict(float)
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        s, t = max(e["ts"], w0), min(e["ts"] + e["dur"], w1)
        if t > s:
            dev.append((s, t))
            by_name[e["name"]] += (t - s) * 1e-6
    busy = _merge(dev)
    host = [e for e in events if e.get("ph") == "X"
            and e.get("cat") in HOST_CATS and e.get("dur", 0) > 0]
    hs = np.array([e["ts"] for e in host], dtype=np.float64)
    hd = np.array([e["dur"] for e in host], dtype=np.float64)
    gaps, prev = defaultdict(float), w0
    for s, t in busy + [(w1, w1)]:
        if s > prev:
            mid = (prev + s) / 2
            inside = np.flatnonzero((hs <= mid) & (hs + hd >= mid))
            label = (host[inside[np.argmin(hd[inside])]]["name"]
                     if inside.size else "no host event")
            gaps[label] += (s - prev) * 1e-6
        prev = max(prev, t)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])
    return {"window_s": (w1 - w0) * 1e-6,
            "busy_s": sum(t - s for s, t in busy) * 1e-6,
            "device_ops": [[n, v] for n, v in top[:TOP]],
            "idle_gaps": [[n, v] for n, v in
                          sorted(gaps.items(), key=lambda kv: -kv[1])[:TOP]],
            "kernels": sorted(by_name)}
