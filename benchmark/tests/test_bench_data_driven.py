"""A configuration, traffic mix, cell and metric added as files (and
entries in BENCHMARK.json) to a copy of the benchmark are found by name
and run, with no edit to any file of the harness."""

import json

from bench_testutil import run_tiny, tiny_copy

METRIC = '''"""Jobs in the window (a test's metric)."""


def read(ctx):
    return ctx["window"]["jobs"]
'''


def test_new_files_are_found_by_name(tmp_path):
    root = tiny_copy(tmp_path)
    b = root / "benchmark"
    cfg = json.loads((b / "configs" / "pagerank-g500-s21-onehot.json")
                     .read_text())
    cfg["scale"] = 8
    (b / "configs" / "pagerank-tiny.json").write_text(json.dumps(cfg))
    (b / "traffic" / "fixed3.json").write_text(json.dumps(
        {"arrival": "closed", "clients": 1, "iterations": 3, "roots": None,
         "warmup_jobs": 1}))
    (b / "workloads" / "pr-tiny-fixed3.json").write_text(json.dumps(
        {"answers_sampled": 2, "traced_jobs": 2, "profiled_jobs": 2,
         "limits": {"degree_mismatch": 0, "rank_rel_err": 1e-4}}))
    (b / "metrics" / "window.jobs.py").write_text(METRIC)
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "pagerank-tiny", "source": "test",
                            "file": "benchmark/configs/pagerank-tiny.json",
                            "reduced": ["scale"], "why": "test"})
    spec["workloads"].append({"name": "pr-tiny-fixed3",
                              "config": "pagerank-tiny",
                              "traffic": "fixed3", "chips": 1,
                              "why": "test"})
    spec["per_layer"].append({"name": "window.jobs", "unit": "jobs",
                              "better": "higher", "source": "host_clock",
                              "layer": "test", "moves": "gteps",
                              "workloads": ["pr-tiny-fixed3"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))

    res = run_tiny(root, "pr-tiny-fixed3", trace=True)
    assert res["correct"]
    assert res["metrics"]["window.jobs"]["value"] == res["attempted"]
    assert "step.roofline_share" not in res["metrics"]   # not listed
    res = run_tiny(root, "pr-tiny-fixed3", trace=False)
    # job_p95_ms lists its cells, and the new cell is not among them
    assert set(res["metrics"]) == {"gteps", "setup_s"}
    assert list(res)[-1] == "checks"
