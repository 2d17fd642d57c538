"""The one traffic generator: reads a mix's parameters
(``benchmark/traffic/<name>.json``) and yields its jobs from the seed.

A mix states ``arrival`` ("closed": the next job is sent when the last
one has finished), ``clients`` (1), ``iterations`` (the supersteps each
job runs; 0: to convergence), ``roots`` (null: the job has no root;
"degree_ge1": each job's root is drawn uniformly, with replacement, from
the vertices whose stored row has an edge: Graph500's search keys) and
``warmup_jobs`` (the jobs of the cell's own kind run in set-up). Every
seed gets the same kind and number of jobs; only the roots differ.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np

from benchmark.graph500 import rng_seed

ROOT_KINDS = ("degree_ge1",)
BLOCK = 4096
WINDOW, WARMUP, SAMPLE = 1, 2, 3     # the seed's independent streams


def validate(traffic: Dict) -> None:
    if traffic.get("arrival") != "closed" or traffic.get("clients") != 1:
        raise ValueError("only a closed loop with one client is generated:"
                         f" arrival={traffic.get('arrival')!r}, "
                         f"clients={traffic.get('clients')!r}")
    if traffic.get("roots") not in (None, *ROOT_KINDS):
        raise ValueError(f"roots {traffic.get('roots')!r}: expected null "
                         f"or one of {ROOT_KINDS}")
    if int(traffic["iterations"]) < 0 or int(traffic["warmup_jobs"]) < 1:
        raise ValueError("iterations must be >= 0 and warmup_jobs >= 1")


def stream(seed: int, which: int) -> np.random.Generator:
    return np.random.default_rng([rng_seed(seed), which])


def jobs(traffic: Dict, seed: int, which: int,
         candidates: Optional[np.ndarray]) -> Iterator[Dict]:
    """Endless jobs of ``traffic`` from stream ``which`` of ``seed``:
    ``{"iterations": n, "root": vertex or None}``."""
    rng = stream(seed, which)
    n = int(traffic["iterations"])
    while True:
        if traffic.get("roots") is None:
            roots = [None] * BLOCK
        else:
            roots = [int(v) for v in rng.choice(candidates, size=BLOCK)]
        for root in roots:
            yield {"iterations": n, "root": root}
