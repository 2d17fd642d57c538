"""What the harness loads, and where it refuses to run: no JAX and no JAX
package in the process (compared by whole top-level names), a reference
that imports nothing of the program, and no fallback to the CPU."""

import subprocess
import sys

from bench_testutil import PR_CELL, REPO

FORBIDDEN = {"jax", "jaxlib", "flax", "graphtap_tpu"}


def _py(code, **kw):
    return subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300, **kw)


def test_forbidden_names_are_compared_whole():
    from benchmark import run
    saved = dict(sys.modules)
    try:
        sys.modules.pop("jax", None)
        sys.modules["graphtap_tpu_torch_fake"] = object()
        assert "graphtap_tpu" not in run.forbidden_modules()
        sys.modules["graphtap_tpu.apps"] = object()
        assert run.forbidden_modules() == ["graphtap_tpu"]
    finally:
        sys.modules.clear()
        sys.modules.update(saved)


def test_a_cpu_run_loads_no_jax(tmp_path):
    code = (
        "import sys, json, pathlib, bench_testutil as u\n"
        f"root = u.tiny_copy(pathlib.Path({str(tmp_path)!r}))\n"
        f"res = u.run_tiny(root, {PR_CELL!r}, trace=True)\n"
        "top = {m.split('.')[0] for m in sys.modules}\n"
        "print(json.dumps({'found': sorted(top & set("
        f"{sorted(FORBIDDEN)!r})), 'torch': 'graphtap_tpu_torch' in top,"
        " 'correct': res['correct']}))\n")
    out = _py(code, env={"PYTHONPATH": str(REPO / "benchmark" / "tests"),
                         "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr[-2000:]
    rec = __import__("json").loads(out.stdout.strip().splitlines()[-1])
    assert rec == {"found": [], "torch": True, "correct": True}


def test_reference_imports_nothing_of_the_program():
    code = ("import sys, benchmark.reference.pagerank, "
            "benchmark.reference.bfs, benchmark.graph500, benchmark.traffic\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'graphtap_tpu_torch', 'graphtap_tpu', 'jax'}))")
    out = _py(code)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_no_card_no_result():
    out = _py("import sys; from benchmark.run import main; "
              f"sys.exit(main(['--workload', {PR_CELL!r}, '--seed', '1', "
              "'--seconds', '1', '--trace', '0']))",
              env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_alone_in_a_directory_it_fails(tmp_path):
    import shutil
    shutil.copytree(REPO / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", PR_CELL,
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
        capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin"})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
