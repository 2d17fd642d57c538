"""The lower-precision control of a cell: the plain reference computed in
the type below the configuration's, put in the program's place, and
judged by the cell's own comparison. It has to come out not correct.

    python3 -m benchmark.control --workload <cell> --seeds 1 2 3

prints, for each seed, one JSON line of the numbers compared and whether
they pass the cell's limits (``"correct"``, which must be false). The
benchmark's own runs never run it. PageRank's control is the reference
in bfloat16 (on the card when there is one); BFS's holds its messages
(vertex ids) in int16, at the cell's own sampled roots.
"""

from __future__ import annotations

import argparse
import itertools
import json
import sys
from typing import Dict

from benchmark import harness, traffic as traffic_gen


def readings(name: str, seed: int, device, log, root=harness.ROOT) -> Dict:
    """The control's numbers for one seed of the cell ``name``: the
    cell's own graph of the seed, and its own sampled roots."""
    spec = harness.Spec(root)
    cell = spec.cell(name)
    cfg, mix = spec.config(cell["config"]), spec.traffic(cell["traffic"])
    cf = spec.cell_file(name)
    app = spec.module("apps", cfg["app"])
    g = harness.Graph500(cfg, seed, bool(mix.get("roots")), device)
    roots = None
    if mix.get("roots"):
        jobs = traffic_gen.jobs(mix, seed, traffic_gen.WINDOW, g.candidates)
        roots = [j["root"] for j in itertools.islice(
            jobs, cf["answers_sampled"])]
    rows, cols = g.stored_on(device)
    ref = app.make_reference(cfg, mix, rows, cols, g.nv)
    answers = app.control(cfg, mix, ref, rows, cols, g.nv, roots)
    per = [app.control_compare(ref, a) for a in answers]
    checks = {k: max(p[k] for p in per) for k in per[0]}
    log(f"[control] {name} seed {seed}: {checks}")
    return {"seed": seed, "checks": checks,
            "correct": harness.judge(checks, cf["limits"])}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="benchmark.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    import torch
    device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    for seed in args.seeds:
        rec = readings(args.workload, seed, device,
                       lambda m: print(m, file=sys.stderr, flush=True))
        rec["device"] = str(device)
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
