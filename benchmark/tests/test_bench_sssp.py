"""The SSSP cell's pieces on the CPU: the pair-hash weights, the plain
reference against Dijkstra in float32, the system under test against the
reference at a tiny scale (correct, with its per-layer readings), the
controls and an altered distance coming out not correct, and the new
readers reading nothing where their inputs are absent."""

import heapq
import itertools

import numpy as np
import pytest
import torch

from bench_testutil import run_tiny, tiny_copy
from benchmark import control, graph500, harness
from benchmark import traffic as traffic_gen
from benchmark.g500_weights import pair_weights
from benchmark.reference import sssp as ref_sssp

CELL = "sssp-s21-onehot-roots"
GRAPH = {"directed": False, "transpose": False, "self_loops": False,
         "acyclic": False, "parallel_edges": False}


def _splitmix_numpy(u, v):
    """The weights by uint64 arithmetic (logical shifts, wrapping)."""
    u, v = np.asarray(u, np.uint64), np.asarray(v, np.uint64)
    z = (np.minimum(u, v) << np.uint64(32)) | np.maximum(u, v)
    with np.errstate(over="ignore"):
        z = z + np.uint64(0x9E3779B97F4A7C15)
        z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        z = z ^ (z >> np.uint64(31))
    return ((z >> np.uint64(40)).astype(np.float64) * 2.0 ** -24
            ).astype(np.float32)


def test_pair_weights():
    rng = np.random.default_rng(3)
    u = torch.from_numpy(rng.integers(0, 1 << 26, 1 << 20))
    v = torch.from_numpy(rng.integers(0, 1 << 26, 1 << 20))
    w = pair_weights(u, v)
    assert w.dtype == torch.float32
    assert torch.equal(w, pair_weights(u, v))
    assert torch.equal(w, pair_weights(v, u))
    assert float(w.min()) >= 0.0 and float(w.max()) < 1.0
    assert abs(float(w.double().mean()) - 0.5) < 0.01
    assert torch.equal((w * 2 ** 24).floor(), w * 2 ** 24)   # 24 bits
    np.testing.assert_array_equal(w.numpy(), _splitmix_numpy(u, v))


def _dijkstra(rows, cols, w, nv, root):
    """float32 Dijkstra: d[i] = min over edges (i, j) of d[j] + w."""
    adj = [[] for _ in range(nv)]
    for i, j, x in zip(rows.tolist(), cols.tolist(), w.tolist()):
        adj[j].append((i, np.float32(x)))
    d = [np.float32(np.inf)] * nv
    d[root] = np.float32(0.0)
    heap = [(d[root], root)]
    while heap:
        dj, j = heapq.heappop(heap)
        if dj > d[j]:
            continue
        for i, x in adj[j]:
            nd = np.float32(dj + x)
            if nd < d[i]:
                d[i] = nd
                heapq.heappush(heap, (nd, i))
    return np.array(d, np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_reference_matches_dijkstra(seed):
    rng = np.random.default_rng(seed)
    n = 60
    r, c = rng.integers(0, n, 240), rng.integers(0, n, 240)
    rows, cols = graph500.stored_edges(r, c, GRAPH)
    ref = ref_sssp.Reference(rows, cols, n + 1)
    for root in (int(rows[0]), int(rows[-1])):
        d, steps = ref.run(root)
        want = _dijkstra(rows, cols, ref.w, n + 1, root)
        np.testing.assert_array_equal(d.view(np.int32), want.view(np.int32))
        assert steps >= 2


def test_system_against_reference(tmp_path):
    root = tiny_copy(tmp_path)
    res = run_tiny(root, CELL, seed=2 ** 31 + 12345, trace=True)
    assert res["correct"], res["checks"]
    assert set(res["checks"]) == {"distance_mismatch",
                                  "supersteps_mismatch"}
    m = res["metrics"]
    # on the CPU no device timeline: no roofline; the counters are there
    assert "step.weighted_roofline_share" not in m
    assert 0.0 < m["kernels.wasted_edge_share"]["value"] < 100.0
    assert m["loop.supersteps_per_job"]["value"] > 3
    res = run_tiny(root, CELL, seed=5, trace=False)
    assert res["correct"]
    assert set(res["metrics"]) == {"gteps", "job_p95_ms", "setup_s"}


def _cell_reference(tmp_path, seed, scale=10):
    spec = harness.Spec(tiny_copy(tmp_path, scale))
    cell = spec.cell(CELL)
    cfg, mix = spec.config(cell["config"]), spec.traffic(cell["traffic"])
    g = harness.Graph500(cfg, seed, True, torch.device("cpu"))
    roots = [j["root"] for j in itertools.islice(
        traffic_gen.jobs(mix, seed, traffic_gen.WINDOW, g.candidates), 8)]
    ref = ref_sssp.Reference(*g.stored, g.nv)
    return spec.cell_file(CELL)["limits"], ref, roots


@pytest.mark.parametrize("seed", [1, 2, 3000000001])
def test_controls_are_not_correct(tmp_path, seed):
    """Distances in bfloat16 (the cell's control) and weights rounded to
    1/128 each break a limit."""
    rec = control.readings(CELL, seed, torch.device("cpu"), lambda m: None,
                           root=tiny_copy(tmp_path / "c"))
    assert rec["correct"] is False and rec["checks"]["distance_mismatch"] > 0
    limits, ref, roots = _cell_reference(tmp_path / "q", seed)
    per = [ref.compare(a) for a in ref_sssp.control_answers(
        ref, roots, torch.float32, ref_sssp.QUANTUM)]
    checks = {k: max(p[k] for p in per) for k in per[0]}
    assert not harness.judge(checks, limits), checks
    assert checks["distance_mismatch"] > 0


def test_altered_distance_breaks_the_limit(tmp_path):
    limits, ref, roots = _cell_reference(tmp_path, 7)
    d, steps = ref.run(roots[0])
    answer = {"root": roots[0], "distance": d.copy(), "supersteps": steps}
    assert harness.judge(ref.compare(answer), limits)
    v = int(np.flatnonzero(np.isfinite(d) & (d > 0))[0])
    answer["distance"][v] = np.nextafter(d[v], np.float32(np.inf))
    checks = ref.compare(answer)
    assert checks["distance_mismatch"] == 1 and not harness.judge(checks,
                                                                  limits)


def test_new_readers_read_nothing_without_inputs():
    spec = harness.Spec()
    ctx = {"setup": {}, "trace": None, "stored_edges": 10,
           "window": {"supersteps": [3], "seconds": 1.0,
                      "latencies": [1.0], "jobs": 1}}
    for name in ("step.weighted_roofline_share",
                 "kernels.wasted_edge_share"):
        assert spec.module("metrics", name).read(ctx) is None
    ctx["setup"] = {"counters.relaxed_edges": 400,
                    "counters.frontier_edges": 100}
    ctx["trace"] = {"step_ms": 2.0, "min_bytes": 3.35e9}
    assert spec.module("metrics", "kernels.wasted_edge_share").read(
        ctx) == 75.0
    share = spec.module("metrics", "step.weighted_roofline_share").read(ctx)
    assert share == pytest.approx(100.0 * (3.35e9 + 40) / 3.35e12 / 2e-3)
