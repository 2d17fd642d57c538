"""The port's tracer (``tools/timing.py``) on the CPU, on RMAT-10, over
the scan and onehot kernels:

  * the span tree of one PageRank job (fixed, with the degree handoff)
    and one BFS query (convergence): names, parents, one job id a job,
    children inside their parents, one ``superstep`` a superstep and one
    ``vote`` each; the set-up's ``tiles`` (and its four stages),
    ``plans`` and ``upload``;
  * ``init_bytes`` equals L x the bytes of the fields made, and a job
    on one device counts no copy;
  * states bit for bit with the tracer open (plain, fenced, annotated)
    and closed;
  * a closed tracer records nothing, the loop makes no profiler
    annotation and leaves ``supersteps[i]["ms"]`` None;
  * ``PhaseTimer.samples`` keeps its names and sample counts on a fixed
    and a convergence run;
  * under ``torch.profiler`` with ``annotate=True``, the exported trace
    holds the ``gt.*`` annotations in the spans' order.
"""

import json

import pytest
import torch

from graphtap_tpu_torch import EngineConfig, Graph, GraphConfig, Ordering
from graphtap_tpu_torch.apps import (BFSProgram, DegreeProgram,
                                     PageRankProgram, bfs_config)
from graphtap_tpu_torch.engine.executor import Executor
from graphtap_tpu_torch.ingest import rmat_edges
from graphtap_tpu_torch.tools import timing

N = 1024
ITERS = 3
KERNELS = ["scan", "onehot"]
PHASES = ["scatter_gather", "exchange_x", "combine", "exchange_y", "apply"]


@pytest.fixture(scope="module")
def edges():
    return rmat_edges(10, 16, seed=1)


@pytest.fixture(scope="module")
def pr_graph(edges):
    r, c, _ = edges
    return Graph.from_edges(r, c, None, GraphConfig(num_vertices=N,
                                                    transpose=True))


@pytest.fixture(scope="module")
def bfs_graph(edges):
    r, c, _ = edges
    return Graph.from_edges(r, c, None, bfs_config(N))


@pytest.fixture(scope="module")
def degree(pr_graph):
    deg = Executor(pr_graph, DegreeProgram(torch.float32),
                   EngineConfig(stationary=True, ordering=Ordering.COL),
                   kernel="scan", device="cpu")
    deg.initialize()
    deg.execute(1)
    return deg


def _pagerank(g, kernel):
    return Executor(g, PageRankProgram(torch.float32),
                    EngineConfig(stationary=True, ordering=Ordering.ROW),
                    kernel=kernel, device="cpu")


def _bfs(g, kernel):
    return Executor(g, BFSProgram(root=0),
                    EngineConfig(stationary=False, apply_depends_on_iter=True,
                                 ordering=Ordering.ROW),
                    kernel=kernel, device="cpu")


def _pr_job(ex, deg):
    ex.initialize(other=deg)
    ex.execute(ITERS)


def _bfs_job(ex):
    ex.initialize()
    ex.execute(0)


def _children(tr, i):
    return [k for k, sp in enumerate(tr.spans) if sp.parent == i]


def _names(tr, idx):
    return [tr.spans[k].name for k in idx]


def _check_nesting(tr):
    for sp in tr.spans:
        assert sp.end >= sp.start > 0
        if sp.parent >= 0:
            p = tr.spans[sp.parent]
            assert p.start <= sp.start and sp.end <= p.end
            assert p.job == sp.job


def _check_supersteps(tr, steps):
    for i, k in enumerate(steps):
        assert tr.spans[k].attrs == {"it": i, "phase": "main"}
        assert _names(tr, _children(tr, k)) == PHASES


@pytest.mark.parametrize("kernel", KERNELS)
def test_pagerank_job_span_tree(pr_graph, degree, kernel):
    ex = _pagerank(pr_graph, kernel)
    with timing.tracing() as tr:
        _pr_job(ex, degree)
        _pr_job(ex, degree)
    _check_nesting(tr)
    roots = _children(tr, -1)
    assert _names(tr, roots) == ["initialize", "execute"] * 2
    assert [tr.spans[k].job for k in roots] == [1, 1, 2, 2]
    assert tr.job == 2
    for init, exe in (roots[:2], roots[2:]):
        assert _names(tr, _children(tr, init)) == ["initialize.program"]
        kids = _children(tr, exe)
        assert _names(tr, kids) == ["superstep"] * ITERS + ["sync"]
        _check_supersteps(tr, kids[:ITERS])
    assert tr.counters["supersteps"] == 2 * ITERS


@pytest.mark.parametrize("kernel", KERNELS)
def test_bfs_query_span_tree(bfs_graph, kernel):
    ex = _bfs(bfs_graph, kernel)
    with timing.tracing() as tr:
        _bfs_job(ex)
    _check_nesting(tr)
    n = ex.iteration
    assert n > 1
    roots = _children(tr, -1)
    assert _names(tr, roots) == ["initialize", "execute"]
    assert {sp.job for sp in tr.spans} == {1}
    assert _names(tr, _children(tr, roots[0])) == ["initialize.program"]
    kids = _children(tr, roots[1])
    assert _names(tr, kids) == ["superstep", "vote"] * n + ["flush", "sync"]
    _check_supersteps(tr, kids[:-2:2])
    assert _names(tr, _children(tr, kids[-2])) == PHASES[1:]
    assert tr.counters["supersteps"] == n


@pytest.mark.parametrize("kernel", KERNELS)
def test_setup_spans(edges, kernel):
    r, c, _ = edges
    with timing.tracing() as tr:
        g = Graph.from_edges(r, c, None, GraphConfig(num_vertices=N,
                                                     transpose=True))
        ex = _pagerank(g, kernel)
        g.tiled(Ordering.ROW)                   # kept: no second build
    _check_nesting(tr)
    roots = _children(tr, -1)
    assert _names(tr, roots) == ["tiles", "plans", "upload"]
    assert tr.spans[roots[0]].attrs == {"ordering": "ROW"}
    assert _names(tr, _children(tr, roots[0])) == [
        "tiles.masks", "tiles.bin", "tiles.sort", "tiles.fill"]
    assert {sp.job for sp in tr.spans} == {0}
    assert ex.timings["upload"] >= tr.spans[roots[2]].seconds


@pytest.mark.parametrize("kernel", KERNELS)
def test_copy_counters(pr_graph, bfs_graph, degree, kernel):
    """init_bytes: every state field and ``changed`` (1 byte) made on the
    device, L x the field's bytes a job; no h2d or d2h copy where the
    handed-over state lies on the executor's device."""
    L = pr_graph.part.L
    ex = _pagerank(pr_graph, kernel)
    with timing.tracing() as pr:
        _pr_job(ex, degree)
    assert pr.counters["init_bytes"] == L * (4 + 4 + 1)      # rank, degree
    ex = _bfs(bfs_graph, kernel)
    with timing.tracing() as bfs:
        _bfs_job(ex)
    assert set(ex.state) == {"vid", "parent", "hops"}
    assert bfs.counters["init_bytes"] == bfs_graph.part.L * (3 * 4 + 1)
    for tr in (pr, bfs):
        assert not {"h2d_bytes", "d2h_bytes"} & set(tr.counters)


@pytest.mark.parametrize("mode", ["plain", "fence", "annotate"])
@pytest.mark.parametrize("kernel", KERNELS)
def test_states_equal_with_tracer(pr_graph, bfs_graph, degree, kernel,
                                  mode):
    kw = {"plain": {}, "fence": {"fence": True},
          "annotate": {"annotate": True}}[mode]
    for make, job in ((lambda: _pagerank(pr_graph, kernel),
                       lambda ex: _pr_job(ex, degree)),
                      (lambda: _bfs(bfs_graph, kernel), _bfs_job)):
        off, on = make(), make()
        job(off)
        with timing.tracing(**kw) as tr:
            job(on)
        assert tr.spans and on.iteration == off.iteration
        for k in off.state:
            assert torch.equal(on.state[k], off.state[k]), k
        assert torch.equal(on.changed, off.changed)
        if mode == "fence":
            assert all(s["ms"] > 0 for s in on.supersteps)
        else:
            assert all(s["ms"] is None for s in on.supersteps)


class _Refused:
    def __init__(self, *a, **k):
        raise AssertionError("made with no tracer open")


@pytest.mark.parametrize("kernel", KERNELS)
def test_closed_tracer_records_nothing(pr_graph, bfs_graph, degree, kernel,
                                       monkeypatch):
    tr = timing.tracing(fence=True, annotate=True)
    with tr:
        pass
    monkeypatch.setattr(torch.profiler, "record_function", _Refused)
    monkeypatch.setattr(torch.cuda, "Event", _Refused)
    assert timing.current() is None
    ex = _pagerank(pr_graph, kernel)
    _pr_job(ex, degree)
    assert [s["ms"] for s in ex.supersteps] == [None] * ITERS
    ex = _bfs(bfs_graph, kernel)
    _bfs_job(ex)
    assert all(s["ms"] is None for s in ex.supersteps)
    assert tr.spans == [] and dict(tr.counters) == {} and tr.job == 0


@pytest.mark.parametrize("kernel", KERNELS)
def test_phase_timer_samples(pr_graph, bfs_graph, degree, kernel):
    ex = _pagerank(pr_graph, kernel)
    ex.initialize(other=degree)
    timer = ex.execute_profiled(ITERS, printer=None)
    assert list(timer.samples) == ["scatter_gather", "exchange", "combine",
                                   "apply"]
    assert {k: len(v) for k, v in timer.samples.items()} == {
        "scatter_gather": ITERS, "exchange": 2 * ITERS, "combine": ITERS,
        "apply": ITERS}
    assert all(s["ms"] > 0 for s in ex.supersteps)
    assert timing.current() is None
    ex = _bfs(bfs_graph, kernel)
    ex.initialize()
    timer = ex.execute_profiled(0, printer=None)
    n = ex.iteration
    assert {k: len(v) for k, v in timer.samples.items()} == {
        "scatter_gather": n, "exchange": 3 * n + 2, "combine": n + 1,
        "apply": n + 1}
    assert timer.report().splitlines()[0].startswith("scatter_gather: sum=")


@pytest.mark.parametrize("kernel", KERNELS)
def test_profiler_holds_annotations(pr_graph, degree, kernel, tmp_path):
    from torch.profiler import ProfilerActivity, profile
    ex = _pagerank(pr_graph, kernel)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with timing.tracing(annotate=True) as tr:
            _pr_job(ex, degree)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    got = [e for e in events if e.get("ph") == "X"
           and e.get("cat") == "user_annotation"
           and e.get("name", "").startswith("gt.")]
    # a parent and its first child may open in the same microsecond
    got.sort(key=lambda e: (e["ts"], -e["dur"]))
    assert [e["name"] for e in got] == ["gt." + sp.name for sp in tr.spans]


def test_tracers_nest_and_summarize():
    outer = timing.tracing()
    with outer:
        with timing.span("a", new_job=True, k=1):
            with timing.span("b"):
                timing.count("c", 3)
            with timing.tracing() as inner:
                assert timing.current() is inner
                with timing.span("d"):
                    pass
            assert timing.current() is outer
    assert timing.current() is None
    assert [sp.name for sp in outer.spans] == ["a", "b"]
    assert [sp.name for sp in inner.spans] == ["d"]
    s = outer.summary()
    assert s["jobs"] == 1 and s["counters"] == {"c": 3}
    a, b = s["spans"]["a"], s["spans"]["b"]
    assert a["n"] == b["n"] == 1
    assert a["self_s"] == pytest.approx(a["s"] - b["s"])
    assert outer.spans[0].attrs == {"k": 1} and outer.spans[1].attrs is None
