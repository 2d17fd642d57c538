"""The port's two benchmarks, ``tools/bench.py`` and
``tools/bench_suite.py``, on RMAT-10 on the CPU, against the JAX
package's executor and the golden models.

``bench`` on panel and scan prints one JSON line with the JAX bench's
keys (no ``vs_baseline``) and the port's own, passes its gate, and its
checksum is the JAX scan executor's within 1e-5 relative; a wrong
golden makes it exit non-zero with no JSON line; the degree phase's
kernel follows the JAX bench's rule. The suite's BFS, CC and SSSP rows
equal ``tests/golden.py`` in as many iterations as the JAX executor
takes, CC on its own tiles (more edges than BFS's), a re-run skips the
recorded rows, and ``pagerank_large`` runs the bench in a child. One 2x2
launch of four gloo ranks: the exchange bytes the executor counts equal
((R-1)*L + (C-1)*L)*4 on every rank and superstep.
"""

import json
import os
import subprocess
import sys

import pytest
import torch

import jax
import jax.numpy as jnp

from graphtap_tpu.apps import bfs as jbfs
from graphtap_tpu.apps import cc as jcc
from graphtap_tpu.apps import sssp as jsssp
from graphtap_tpu.apps.degree import DegreeProgram as JDegree
from graphtap_tpu.apps.pagerank import PageRankProgram as JPageRank
from graphtap_tpu.config import Compression as JCompression
from graphtap_tpu.config import EngineConfig as JEngineConfig
from graphtap_tpu.config import GraphConfig as JGraphConfig
from graphtap_tpu.config import Ordering as JOrdering
from graphtap_tpu.engine.executor import Executor as JExecutor
from graphtap_tpu.ingest.graph import Graph as JGraph
from graphtap_tpu.parallel.layout import make_mesh as j_make_mesh

from graphtap_tpu_torch.config import Ordering
from graphtap_tpu_torch.ingest import rmat_edges
from graphtap_tpu_torch.tools import bench, bench_suite

SCALE = 10
ITERS = 5
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_KEYS = {"edges", "iters", "seconds", "checksum", "kernel", "devices",
            "warmup_seconds", "upload_seconds"}
PORT_KEYS = {"runs_seconds", "gteps_range", "device_superstep_ms",
             "device_bytes", "golden_rel_err", "name", "power_limit",
             "torch", "cuda", "nvcc"}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread while this file runs: RMAT-10's small ops gain
    nothing from more, and the test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mesh():
    return j_make_mesh(jax.devices()[:1], shape=(1, 1))


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    return str(tmp_path_factory.mktemp("bench_cache"))


@pytest.fixture(scope="module")
def jax_pagerank_checksum():
    """The JAX executor's PageRank checksum on the bench's graph: the
    degree phase and ITERS iterations on scan."""
    r, c, _ = rmat_edges(SCALE, 16, seed=1)
    cfg = JGraphConfig(num_vertices=1 << SCALE, directed=True,
                       transpose=True, compression=JCompression.TCSC)
    g = JGraph.from_edges(r, c, None, cfg, mesh=_mesh())
    deg = JExecutor(g, JDegree(value_dtype=jnp.float32),
                    JEngineConfig(stationary=True, ordering=JOrdering.COL),
                    kernel="scan")
    deg.initialize()
    deg.execute(1)
    pr = JExecutor(g, JPageRank(value_dtype=jnp.float32),
                   JEngineConfig(stationary=True, ordering=JOrdering.ROW),
                   kernel="scan")
    pr.initialize(other=deg)
    pr.execute(ITERS)
    return float(pr.checksum()[0])


@pytest.mark.parametrize("kernel", ["panel", "scan"])
def test_bench_json_line_and_gate(kernel, cache, capsys,
                                  jax_pagerank_checksum):
    assert bench.main(["--scale", str(SCALE), "--iters", str(ITERS),
                       "--kernel", kernel, "--device", "cpu", "--cache",
                       cache]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert set(rec) == {"metric", "value", "unit", "detail"}
    assert rec["metric"] == f"pagerank_gteps_rmat{SCALE}"
    assert rec["unit"] == "GTEPS"
    d = rec["detail"]
    assert JAX_KEYS | PORT_KEYS <= set(d) and "vs_baseline" not in d
    assert d["kernel"] == kernel and d["iters"] == ITERS
    assert d["degree_kernel"] == bench.degree_kernel(kernel, SCALE)
    assert len(d["runs_seconds"]) == bench.MIN_RUNS
    assert d["seconds"] == sorted(d["runs_seconds"])[bench.MIN_RUNS // 2]
    assert rec["value"] == d["edges"] * ITERS / d["seconds"] / 1e9
    lo, hi = d["gteps_range"]
    assert lo <= rec["value"] <= hi
    assert d["golden_rel_err"] < bench.GOLDEN_RTOL
    assert abs(d["checksum"] - jax_pagerank_checksum) <= \
        1e-5 * abs(jax_pagerank_checksum)
    # a CPU run names no card and no device time
    assert d["name"] is None and d["device_superstep_ms"] is None
    assert d["device"] == "cpu" and d["devices"] == 1


def test_bench_wrong_golden_exits_nonzero(tmp_path):
    with open(bench.golden_path(str(tmp_path), SCALE, ITERS), "w") as f:
        f.write("1.0")
    out = subprocess.run(
        [sys.executable, "-m", "graphtap_tpu_torch.tools.bench", "--scale",
         str(SCALE), "--iters", str(ITERS), "--kernel", "scan", "--device",
         "cpu", "--cache", str(tmp_path)],
        capture_output=True, text=True, cwd=ROOT, timeout=120,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "GateFailed" in out.stderr


def test_degree_kernel_rule():
    assert bench.degree_kernel("panel", 20) == "shuffle"
    assert bench.degree_kernel("panel", 21) == "scan"
    assert bench.degree_kernel("shuffle2", 22) == "scan"
    assert bench.degree_kernel("onehot", 22) == "onehot"
    assert bench.degree_kernel("scan", 20) == "scan"


@pytest.fixture(scope="module")
def jax_iterations():
    """The JAX executor's iteration counts of BFS, CC and SSSP (scan) on
    the suite's graphs."""
    r, c, _ = rmat_edges(SCALE, 16, seed=1)
    rw, cw, w = rmat_edges(SCALE, 16, seed=1, weighted=True)
    nv = 1 << SCALE
    return {
        "bfs": jbfs.run_bfs(JGraph.from_edges(r, c, None, jbfs.bfs_config(nv),
                                              mesh=_mesh()), 0).iteration,
        "cc": jcc.run_cc(JGraph.from_edges(r, c, None, jcc.cc_config(nv),
                                           mesh=_mesh())).iteration,
        "sssp": jsssp.run_sssp(JGraph.from_edges(
            rw, cw, w, jsssp.sssp_config(nv), mesh=_mesh()), 0).iteration}


def test_suite_rows(cache, tmp_path, capsys, monkeypatch, jax_iterations):
    out = tmp_path / "rows.jsonl"
    monkeypatch.setenv("BENCH_KERNEL", "scan")    # the pagerank_large child
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    args = ["--scale", str(SCALE), "--pr-scale", str(SCALE), "--device",
            "cpu", "--cache", cache, "--out", str(out), "--skip-comm"]
    assert bench_suite.main(args) == 0
    rows = {json.loads(ln)["metric"]: json.loads(ln)
            for ln in out.read_text().splitlines()}
    assert set(rows) == {f"{a}_seconds_rmat{SCALE}" for a in bench_suite.APPS
                         } | {f"pagerank_iters_per_sec_rmat{SCALE}"}
    golden = bench.golden_module()
    r, c, _ = rmat_edges(SCALE, 16, seed=1)
    rw, cw, w = rmat_edges(SCALE, 16, seed=1, weighted=True)
    nv = (1 << SCALE) + 1
    _, hops = golden.bfs(r, c, nv, 0)
    lab = golden.cc(r, c, nv)
    dist = golden.sssp(rw, cw, w, nv, 0)
    want = {"bfs": (float(hops[hops != golden.INF].sum()),
                    int((hops != golden.INF).sum())),
            "cc": (float(lab.sum()), lab.size),
            "sssp": (float(dist[dist != golden.INF].sum()),
                     int((dist != golden.INF).sum()))}
    for app in bench_suite.APPS:
        d = rows[f"{app}_seconds_rmat{SCALE}"]["detail"]
        assert (d["checksum"], d["reachable"]) == want[app], app
        assert d["iterations"] == jax_iterations[app], app
        assert d["kernel"] == "panel"
        assert {"gteps", "build_seconds", "upload_seconds",
                "warmup_seconds", "imbalance", "name",
                "power_limit"} <= set(d)
    # CC keeps its self loops: its own tile file, and more edges than BFS
    bfs_cfg = bench_suite.APPS["bfs"][0](1 << SCALE)
    cc_cfg = bench_suite.APPS["cc"][0](1 << SCALE)
    tiles = [bench.tiles_path(cache, SCALE, cfg, Ordering.ROW)
             for cfg in (bfs_cfg, cc_cfg)]
    assert tiles[0] != tiles[1] and all(map(os.path.exists, tiles))
    assert bfs_cfg.self_loops is False and cc_cfg.self_loops is True
    assert rows[f"cc_seconds_rmat{SCALE}"]["detail"]["edges"] > \
        rows[f"bfs_seconds_rmat{SCALE}"]["detail"]["edges"]
    pr = rows[f"pagerank_iters_per_sec_rmat{SCALE}"]
    assert pr["unit"] == "iters/s" and "vs_cpu_baseline" not in pr["detail"]
    assert pr["detail"]["kernel"] == "scan" and pr["detail"]["iters"] == 5
    assert pr["value"] == 5 / pr["detail"]["seconds"]
    # a re-run finds every row recorded and adds none
    capsys.readouterr()
    before = out.read_text()
    assert bench_suite.main(args) == 0
    assert out.read_text() == before
    assert capsys.readouterr().out == ""


def test_comm_model_bytes_equal_formula_2x2(cache):
    rec = bench_suite.comm_model(SCALE, ((2, 2),), "cpu", cache,
                                 log=lambda msg: None)
    assert rec["metric"] == f"comm_model_4dev_rmat{SCALE}"
    (row,) = rec["detail"]["rows"]
    L = row["L"]
    assert row["formula_bytes_per_dev_iter"] == ((2 - 1) * L
                                                 + (2 - 1) * L) * 4
    assert row["counted_bytes_per_dev_iter"] == \
        row["formula_bytes_per_dev_iter"]
    assert row["exchange_bytes"] == {"all_gather_x": [L * 4, L * 4],
                                     "all_to_all_y": [L * 4, L * 4]}
    assert rec["value"] == 0.0 and row["seconds"] > 0
    # the run is right, too: the bench's graph and iteration count
    golden = bench.golden_module()
    r, c, _ = rmat_edges(SCALE, 16, seed=1)
    want = float(golden.pagerank(r, c, (1 << SCALE) + 1,
                                 bench_suite.COMM_ITERS).sum())
    assert abs(row["checksum"] - want) <= 1e-5 * want
