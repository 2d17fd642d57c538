"""The TCSC_CF PageRank cell's pieces on the CPU: the plain reference's
stop rule and flush against an independent NumPy count, the spec loading
the new configuration, traffic and cell, the system under test against the
reference at a tiny scale (correct, with its per-layer readings), the
bfloat16 control, a rank moved past its limit and a superstep count off by
more than its limit coming out not correct, and the new readers reading
nothing where their inputs are absent."""

import numpy as np
import pytest
import torch

from bench_testutil import run_tiny, tiny_copy
from benchmark import control, graph500, harness
from benchmark.apps import pagerank_cf as app
from benchmark.reference import pagerank_cf as ref_cf

CELL = "pr-s20-cf-converge"
GRAPH = {"directed": True, "transpose": True, "self_loops": True,
         "acyclic": False, "parallel_edges": True}


def _stored(scale, seed):
    r, c = graph500.kronecker_edges(scale, 16, 0.57, 0.19, 0.19,
                                    graph500.uniforms(seed,
                                                      torch.device("cpu")))
    return graph500.stored_edges(r, c, GRAPH)


def _numpy_pagerank_cf(rows, cols, nv, alpha=0.15, tol=1e-5):
    """pr.cpp on TCSC_CF, written again with NumPy's unbuffered adds: the
    vote over vertices with an in- and an out-edge, the flush over every
    vertex with an in-edge on the last superstep's messages."""
    rows, cols = np.asarray(rows), np.asarray(cols)
    has_in = np.zeros(nv, bool)
    has_in[rows] = True
    has_out = np.zeros(nv, bool)
    has_out[cols] = True
    regular = has_in & has_out
    deg = np.where(has_in, np.bincount(cols, minlength=nv), 0)
    rank = np.full(nv, alpha)
    steps = 0
    while True:
        msg = np.divide(rank, deg, out=np.zeros(nv), where=deg > 0)
        y = np.zeros(nv)
        np.add.at(y, rows, msg[cols])
        new = np.where(regular, alpha + (1 - alpha) * y, rank)
        moved = regular & (np.abs(new - rank) > tol)
        rank, steps = new, steps + 1
        if not moved.any():
            break
    return np.where(has_in, alpha + (1 - alpha) * y, rank), steps


@pytest.mark.parametrize("seed", [1, 2])
def test_reference_stop_rule_and_flush(seed):
    rows, cols = _stored(12, seed)
    nv = (1 << 12) + 1
    ref = ref_cf.Reference(rows, cols, nv, 0.15, 1e-5)
    want, steps = _numpy_pagerank_cf(rows, cols, nv)
    assert ref.supersteps == steps > 50
    np.testing.assert_allclose(ref.rank, want, rtol=1e-12, atol=0)
    # the flush gave the source rows (an in-edge, no out-edge) their rank
    has_in, regular = (t.numpy() for t in ref_cf.classes(rows, cols, nv))
    source = has_in & ~regular
    assert source.any() and (ref.rank[source] > 0.15).any()


def test_spec_loads_the_cell():
    spec = harness.Spec()
    cell = spec.cell(CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        "pagerank-g500-s20-cf-converge", "converge", 1)
    cfg, mix = spec.config(cell["config"]), spec.traffic(cell["traffic"])
    assert (cfg["app"], cfg["scale"], cfg["tol"], cfg["kernel"]) == (
        "pagerank_cf", 20, 1e-5, "onehot")
    assert cfg["graph"]["compression"] == "tcsc_cf"
    assert (mix["iterations"], mix["roots"], mix["warmup_jobs"]) == (0, None,
                                                                     1)
    assert set(spec.cell_file(CELL)["limits"]) == {
        "degree_mismatch", "rank_rel_err", "supersteps_off"}
    assert spec.module("apps", cfg["app"]).System is not None
    assert {m["name"] for m in spec.metrics(CELL, False)} == {"gteps",
                                                              "setup_s"}
    assert {"setup.cf_s", "kernels.cf_skipped_edge_share",
            "step.cf_roofline_share"} <= {m["name"] for m in
                                          spec.metrics(CELL, True)}


def test_system_against_reference(tmp_path):
    root = tiny_copy(tmp_path)
    res = run_tiny(root, CELL, seed=2 ** 31 + 12345, trace=True)
    assert res["correct"], res["checks"]
    m = res["metrics"]
    # on the CPU no device timeline: no roofline; the counters are there
    assert "step.cf_roofline_share" not in m
    assert 0.0 < m["kernels.cf_skipped_edge_share"]["value"] < 10.0
    assert m["setup.cf_s"]["value"] > 0.0
    res = run_tiny(root, CELL, seed=5, trace=False)
    assert res["correct"]
    assert set(res["metrics"]) == {"gteps", "setup_s"}


def _cell(tmp_path, seed, scale=10):
    spec = harness.Spec(tiny_copy(tmp_path, scale))
    cfg = spec.config(spec.cell(CELL)["config"])
    g = harness.Graph500(cfg, seed, False, torch.device("cpu"))
    ref = ref_cf.Reference(*g.stored, g.nv, cfg["alpha"], cfg["tol"])
    return spec.cell_file(CELL)["limits"], ref


@pytest.mark.parametrize("seed", [1, 3000000001])
def test_control_is_not_correct(tmp_path, seed):
    """The reference in bfloat16 breaks the rank limit and the superstep
    limit, at scale 12 (at 10 bf16 settles only 27-41 supersteps early,
    from 45 on at 12)."""
    root = tiny_copy(tmp_path / "c", scale=12)
    rec = control.readings(CELL, seed, torch.device("cpu"), lambda m: None,
                           root=root)
    assert rec["correct"] is False
    limits = harness.Spec(root).cell_file(CELL)["limits"]
    checks = rec["checks"]
    assert checks["rank_rel_err"] > limits["rank_rel_err"]
    assert checks["supersteps_off"] > limits["supersteps_off"]


def test_altered_answers_break_the_limits(tmp_path):
    limits, ref = _cell(tmp_path, 7)
    answer = {"rank": ref.rank.copy(), "degree": ref.handed.copy(),
              "supersteps": ref.supersteps}
    assert harness.judge(ref.compare(answer, ref.degree), limits)
    moved = dict(answer, rank=ref.rank.copy())
    moved["rank"][17] *= 1 + 2 * limits["rank_rel_err"]
    checks = ref.compare(moved, ref.degree)
    assert checks["rank_rel_err"] > limits["rank_rel_err"]
    assert not harness.judge(checks, limits)
    late = dict(answer, supersteps=ref.supersteps
                + limits["supersteps_off"] + 1)
    checks = ref.compare(late, ref.degree)
    assert checks["supersteps_off"] == limits["supersteps_off"] + 1
    assert not harness.judge(checks, limits)


def test_phase_min_bytes_count_each_subset():
    rows, cols = _stored(10, 4)
    nv = (1 << 10) + 1
    masks = app.phase_masks(rows, cols, nv)
    got = app.phase_min_bytes(rows, cols, nv, 2)
    for ph, m in masks.items():
        assert got[ph] == graph500.min_superstep_bytes(rows[m], cols[m], nv,
                                                       2)
    n = {ph: int(m.sum()) for ph, m in masks.items()}
    assert n["middle"] < n["first"] < rows.numel() and n["last"] < \
        rows.numel()


def test_new_readers_read_nothing_without_inputs():
    spec = harness.Spec()
    names = ("setup.cf_s", "kernels.cf_skipped_edge_share",
             "step.cf_roofline_share")
    ctx = {"setup": {}, "trace": None, "stored_edges": 100,
           "window": {"supersteps": [4, 4], "seconds": 1.0,
                      "latencies": [0.5, 0.5], "jobs": 2}}
    for name in names:
        assert spec.module("metrics", name).read(ctx) is None
    ctx["setup"] = {"cf_tiles": 1.0, "cf_plans": 2.0, "cf_upload": 0.5,
                    "counters.cf_phase_edges": 490,
                    "counters.cf_supersteps": 5,
                    "cf_min_bytes.first": 3.35e9,
                    "cf_min_bytes.middle": 3.35e9,
                    "cf_min_bytes.last": 6.7e9}
    ctx["trace"] = {"step_ms": 2.0}
    read = {n: spec.module("metrics", n).read(ctx) for n in names}
    assert read["setup.cf_s"] == 3.5
    assert read["kernels.cf_skipped_edge_share"] == pytest.approx(2.0)
    # first, three middles and the flush on last: 6 x 3.35 GB over
    # 3.35 TB/s against 4 supersteps of 2 ms
    assert read["step.cf_roofline_share"] == pytest.approx(75.0)
