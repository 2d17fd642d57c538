"""One run of one cell, driven by data.

``BENCHMARK.json`` names the cell; the harness finds by name everything
that belongs to one configuration, traffic mix, cell or metric:

- ``configs[*].file``: the configuration (its app, sizes, graph
  transforms, kernel, types); its app's system under test is
  ``benchmark/apps/<app>.py`` and its plain reference
  ``benchmark/reference/<app>.py``;
- ``benchmark/traffic/<traffic>.json``: the mix the one generator
  (``traffic.py``) reads;
- ``benchmark/workloads/<cell>.json``: how many answers are compared,
  how many jobs the traced run profiles, and the limit of every number
  compared;
- ``benchmark/metrics/<metric>.py``: each metric's reader, ``read(ctx)``
  -> a number, or None where it finds nothing to read.

A run: set-up (the edges drawn on the card from the seed, and from them
the reference's stored edges, the traffic's roots and the least bytes of
a superstep; the port's graph, tiles, plans and upload, built afresh in
every run, so each run's set-up does the same work; the traffic's
warm-up jobs); the window
(a closed loop of jobs from ``--seed``, back to back, ended by the first
job to finish after ``--seconds``, answers sampled from the seed copied
on the device); with ``--trace 1`` the traced extras after the window;
then the sampled answers are read back, the program is freed and the
plain reference judges them.
"""

from __future__ import annotations

import gc
import importlib.util
import itertools
import json
import resource
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np

from benchmark import graph500, traffic as traffic_gen

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
PACE_S = 2.0      # the window's progress is logged in bins of this length


class SpecError(ValueError):
    """BENCHMARK.json or a file it names is missing or malformed."""


def load_json(path: Path) -> Dict:
    try:
        with open(path) as f:
            return json.load(f)
    except FileNotFoundError as e:
        raise SpecError(f"{path} is missing") from e


class Spec:
    """``BENCHMARK.json`` under ``root`` and the files it names."""

    def __init__(self, root: Path = ROOT):
        self.root = Path(root)
        self.data = load_json(self.root / "BENCHMARK.json")
        self._modules: Dict[Path, object] = {}

    def _named(self, key: str, name: str) -> Dict:
        for entry in self.data[key]:
            if entry["name"] == name:
                return entry
        raise SpecError(f"no {key} entry named {name!r} in BENCHMARK.json")

    def cell(self, name: str) -> Dict:
        return self._named("workloads", name)

    def config(self, name: str) -> Dict:
        return load_json(self.root / self._named("configs", name)["file"])

    def traffic(self, name: str) -> Dict:
        t = load_json(self.root / "benchmark" / "traffic" / f"{name}.json")
        traffic_gen.validate(t)
        return t

    def cell_file(self, name: str) -> Dict:
        return load_json(self.root / "benchmark" / "workloads"
                         / f"{name}.json")

    def module(self, kind: str, name: str):
        """``benchmark/<kind>/<name>.py`` under the root, loaded by path
        (a metric's name may hold dots)."""
        path = self.root / "benchmark" / kind / f"{name}.py"
        if path not in self._modules:
            if not path.exists():
                raise SpecError(f"{path} is missing")
            spec = importlib.util.spec_from_file_location(
                f"benchmark_{kind}_{name.replace('.', '_')}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            self._modules[path] = mod
        return self._modules[path]

    def metrics(self, cell: str, trace: bool) -> List[Dict]:
        """The cell's end-to-end metrics (``trace`` False) or per-layer
        metrics (True): those with no ``workloads`` key, and those that
        list the cell."""
        key = "per_layer" if trace else "end_to_end"
        return [m for m in self.data[key]
                if cell in m.get("workloads", [cell])]


class Graph500:
    """The cell's graph as the yardstick holds it: the raw edges the
    program is handed, on the host, and what the harness takes from them
    on the card (``stored_edges``, the traffic's candidate roots, the
    least bytes of a superstep). The stored edges wait on the host for
    the reference, which moves them back once the program is freed."""

    def __init__(self, cfg: Dict, seed: int, roots: bool, device):
        import torch
        nv = self.nv = (1 << cfg["scale"]) + 1
        r, c = graph500.kronecker_edges(
            cfg["scale"], cfg["edge_factor"], cfg["a"], cfg["b"], cfg["c"],
            graph500.uniforms(seed, device))
        rows, cols = graph500.stored_edges(r, c, cfg["graph"])
        self.candidates = (graph500.nonempty_rows(rows, nv).cpu().numpy()
                           if roots else None)
        self.min_bytes = graph500.min_superstep_bytes(
            rows, cols, nv, cfg["state_fields"])
        self.n_stored = int(rows.numel())
        self.raw = (r.cpu().numpy(), c.cpu().numpy())
        self.stored = (rows.cpu(), cols.cpu())
        del r, c, rows, cols
        if device.type == "cuda":
            # the device peak the result reports is the program's own
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(device)

    def stored_on(self, device):
        return tuple(t.to(device) for t in self.stored)


class Sampler:
    """A uniform sample of ``k`` of the window's jobs, drawn from the
    seed (reservoir sampling): their answers are copied on the device as
    they finish."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = traffic_gen.stream(seed, traffic_gen.SAMPLE)
        self.items: List = []

    def offer(self, i: int, take: Callable[[], object]) -> None:
        if i < self.k:
            self.items.append(take())
            return
        j = int(self.rng.integers(0, i + 1))
        if j < self.k:
            self.items[j] = take()


def _sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def window(system, jobs, seconds: float, sampler: Sampler, device,
           log) -> Dict:
    """Jobs back to back until the first one to finish after
    ``seconds``; each job's latency is from the end of the one before
    (its ``initialize``) to the end of its ``execute``, which ends in a
    device synchronize."""
    lat, steps = [], []
    t0 = prev = time.perf_counter()
    for i in itertools.count():
        params = next(jobs)
        system.job(params)
        t = time.perf_counter()
        lat.append(t - prev)
        prev = t
        steps.append(system.supersteps())
        sampler.offer(i, lambda: system.snapshot(params))
        if t - t0 >= seconds:
            break
    _sync(device)
    ends = np.cumsum(lat)
    per = np.bincount((ends // PACE_S).astype(np.int64))
    log(f"[bench] jobs finished in each {PACE_S:g} s of the window: "
        + " ".join(str(int(n)) for n in per))
    return {"seconds": prev - t0, "latencies": lat, "supersteps": steps,
            "jobs": len(lat)}


def _profiled_split(system, jobs, n: int, device) -> Dict:
    """The port's fenced per-phase split (``execute_profiled``'s
    ``PhaseTimer``) over ``n`` jobs: seconds of each phase, and the
    supersteps run."""
    from graphtap_tpu_torch.tools.timing import PhaseTimer
    timer = PhaseTimer()
    supersteps = 0
    for _ in range(n):
        system.job(next(jobs), profile=timer)
        supersteps += system.supersteps()
    _sync(device)
    return {"phases_s": {k: float(sum(v))
                         for k, v in timer.samples.items()},
            "supersteps": supersteps}


def _power_limit() -> Optional[str]:
    import subprocess
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


def traced_extras(system, jobs, cell_file: Dict, device, min_bytes: int,
                  log) -> Dict:
    """After the window: the profiler's timeline over a few jobs, and
    from it one superstep's device seconds (the jobs' device busy time
    over their supersteps, so each job's own copies and flush count); the
    fenced split; and the least bytes a superstep must move."""
    from benchmark import trace
    out: Dict = {"power_limit": None, "step_ms": None, "timeline": None}
    if device.type == "cuda":
        out["power_limit"] = _power_limit()
        steps = []

        def run(i, span):
            system.job(next(jobs), span=span)
            steps.append(system.supersteps())
        tl = trace.profile_jobs(run, cell_file["traced_jobs"],
                                lambda: _sync(device))
        out["timeline"] = tl
        out["step_ms"] = tl["busy_s"] * 1e3 / sum(steps)
        log(f"[bench] the profiler saw {len(tl['kernels'])} device "
            f"operations; {tl['busy_s']:.6f} s busy over {sum(steps)} "
            f"supersteps")
    out["split"] = _profiled_split(system, jobs, cell_file["profiled_jobs"],
                                   device)
    out["min_bytes"] = min_bytes
    return out


def judge(checks: Dict[str, float], limits: Dict[str, float]) -> bool:
    missing = set(checks) ^ set(limits)
    if missing:
        raise SpecError(f"numbers compared and limits differ: "
                        f"{sorted(missing)}")
    return all(checks[k] <= limits[k] for k in checks)


def run_cell(name: str, seed: int, seconds: float, trace: bool, device,
             t_start: float, log, root: Path = ROOT) -> Dict:
    """One run of the cell ``name``; returns the result line's object,
    ``checks`` last. ``t_start``: the process's first clock reading."""
    import torch
    spec = Spec(root)
    cell = spec.cell(name)
    cfg, mix = spec.config(cell["config"]), spec.traffic(cell["traffic"])
    cf = spec.cell_file(name)
    app = spec.module("apps", cfg["app"])
    times: Dict[str, float] = {}

    t0 = time.perf_counter()
    times["start"] = t0 - t_start
    torch.zeros(1, device=device)
    _sync(device)
    t1 = time.perf_counter()
    times["device_init"] = t1 - t0
    g = Graph500(cfg, seed, bool(mix.get("roots")), device)
    t2 = time.perf_counter()
    times["edges"] = t2 - t1
    system = app.System(cfg, g.raw, device, times)
    g.raw = None
    times["system"] = time.perf_counter() - t2
    t3 = time.perf_counter()
    for params in itertools.islice(
            traffic_gen.jobs(mix, seed, traffic_gen.WARMUP, g.candidates),
            mix["warmup_jobs"]):
        system.job(params)
        system.supersteps()
        system.snapshot(params)
    _sync(device)
    # the set-up's objects leave the collector's young generations, so
    # no collection inside the window walks them
    gc.collect()
    gc.freeze()
    times["warmup"] = time.perf_counter() - t3
    setup_s = time.perf_counter() - t_start
    log(f"[bench] set-up {setup_s:.3f} s: " + ", ".join(
        f"{k} {v:.3f} s" for k, v in times.items())
        + f"; host peak RSS "
        f"{resource.getrusage(resource.RUSAGE_SELF).ru_maxrss << 10} B")

    jobs = traffic_gen.jobs(mix, seed, traffic_gen.WINDOW, g.candidates)
    sampler = Sampler(cf["answers_sampled"], seed)
    win = window(system, jobs, seconds, sampler, device, log)
    log(f"[bench] window {win['seconds']:.3f} s, {win['jobs']} jobs")
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    extras = (traced_extras(system, jobs, cf, device, g.min_bytes, log)
              if trace else None)

    answers = [system.answer(s) for s in sampler.items]
    sampler.items = []
    system.free()
    del system
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t4 = time.perf_counter()
    ref = app.make_reference(cfg, mix, *g.stored_on(device), g.nv)
    per_answer = [app.compare(ref, a) for a in answers]
    del ref
    log(f"[bench] reference and comparison {time.perf_counter() - t4:.3f} s")
    limits = cf["limits"]
    checks = {k: max(p[k] for p in per_answer) for k in per_answer[0]}
    correct = judge(checks, limits)
    failed = sum(not judge(p, limits) for p in per_answer)

    ctx = {"setup_s": setup_s, "setup": times, "window": win,
           "stored_edges": g.n_stored, "trace": extras}
    metrics = {}
    for m in spec.metrics(name, trace):
        value = spec.module("metrics", m["name"]).read(ctx)
        if value is None and not trace:
            raise SpecError(f"end-to-end metric {m['name']} read nothing")
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": 1, "memory_peak_bytes": int(peak)}
    out = {"correct": correct, "attempted": win["jobs"], "failed": failed,
           "metrics": metrics, "device": dev}
    if extras is not None and extras["timeline"] is not None:
        tl = extras["timeline"]
        dev["busy_s"], dev["window_s"] = tl["busy_s"], tl["window_s"]
        out["breakdown"] = {"device_ops": tl["device_ops"],
                            "idle_gaps": tl["idle_gaps"]}
        log(f"[bench] power limit {extras['power_limit']}; device ms a "
            f"superstep {extras['step_ms']}; least bytes a superstep "
            f"{extras['min_bytes']}")
    out["checks"] = {k: {"value": checks[k], "limit": limits[k]}
                     for k in sorted(checks)}
    return out
