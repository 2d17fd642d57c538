"""BENCHMARK.json against the contract's shape: names, units, keys,
bounds, and that every file it names is there."""

import json
import re

import pytest

from bench_testutil import REPO

SPEC = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}
KEYS = {"configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source"},
        "per_layer": {"name", "unit", "better", "source", "layer",
                      "moves"}}


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys_and_size():
    assert set(SPEC) == TOP
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= SPEC["run_seconds"] <= 51
    assert all(PATH.match(p) and not p.startswith("/") and ".." not in p
               for p in SPEC["paths"])
    assert len(SPEC["command"]) <= 32 and all(_line(w)
                                              for w in SPEC["command"])


@pytest.mark.parametrize("key", sorted(KEYS))
def test_entries_have_only_their_keys(key):
    for e in SPEC[key]:
        extra = {"workloads"} if key in ("end_to_end", "per_layer") else set()
        assert KEYS[key] <= set(e) <= KEYS[key] | extra, e["name"]


def test_names_units_and_lines():
    names = []
    for key in KEYS:
        for e in SPEC[key]:
            assert NAME.match(e["name"]), e["name"]
            names.append((key, e["name"]))
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
            for k in ("why", "layer", "source"):
                if k in e and key in ("configs", "workloads", "per_layer"):
                    assert _line(e[k]), (e["name"], k)
    assert len(names) == len(set(names))
    for w in SPEC["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4)
    for c in SPEC["configs"]:
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])


def test_metrics_sources_bounds_and_moves():
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    cells = {w["name"] for w in SPEC["workloads"]}
    assert "setup_s" in e2e
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e
        assert set(m.get("workloads", cells)) <= cells
    # every cell that reports a per-layer metric reports the end-to-end
    # metric it moves
    reported = {m["name"]: set(m.get("workloads", cells))
                for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert set(m.get("workloads", cells)) <= reported[m["moves"]], \
            m["name"]


def test_every_named_file_is_there():
    for c in SPEC["configs"]:
        assert (REPO / c["file"]).is_file()
        assert c["file"].startswith(tuple(p + "/" for p in SPEC["paths"]))
        cfg = json.loads((REPO / c["file"]).read_text())
        assert set(c["reduced"]) <= set(cfg)
        assert (REPO / "benchmark" / "apps" / f"{cfg['app']}.py").is_file()
        assert (REPO / "benchmark" / "reference"
                / f"{cfg['app']}.py").is_file()
    for w in SPEC["workloads"]:
        assert (REPO / "benchmark" / "traffic"
                / f"{w['traffic']}.json").is_file()
        assert (REPO / "benchmark" / "workloads"
                / f"{w['name']}.json").is_file()
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert (REPO / "benchmark" / "metrics" / f"{m['name']}.py").is_file()
    assert {c["name"] for c in SPEC["configs"]} == \
        {w["config"] for w in SPEC["workloads"]}


def test_files_under_paths_are_named_from_name_characters():
    for p in SPEC["paths"]:
        for f in (REPO / p).rglob("*"):
            if "__pycache__" in f.parts:
                continue
            rel = f.relative_to(REPO).as_posix()
            assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel
