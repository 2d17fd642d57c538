"""PageRank to tolerance as GraphTap's pr.cpp runs it on the port: one
TCSC_CF graph, the degree phase once in set-up, then each job hands its
degrees over (``initialize(other=)``) and runs to the vote and its flush
(``execute(0)``) through the CF phases: "first", "middle" until the
vote, then the flush on "last". The executor builds the phases at the
first job that runs them, the traffic's warm-up, inside the set-up.

Into the set-up record ``times`` given at construction, which the harness
hands the metric readers as ``ctx["setup"]``, go: the job executor's
``cf_tiles``, ``cf_plans`` and ``cf_upload`` seconds once the phases are
built; and, with the traced run's profiled jobs (``profile``: the
``PhaseTimer`` that ``execute_profiled`` opens as the process's tracer),
``cf_min_bytes.<phase>``, the least bytes of one pass over each phase's
edge subset (``phase_min_bytes``, from the stored edges alone, computed
at the first profiled job, after the set-up's clock has stopped), and,
where the executor counts them,
``counters.cf_phase_edges`` (the stored edges of the phase each
superstep and flush ran) and ``counters.cf_supersteps`` (the passes it
counted: supersteps and flushes).
"""

from __future__ import annotations

from typing import Dict, List

import torch

from benchmark import graph500
from benchmark.apps import common
from benchmark.reference import pagerank_cf as reference
from graphtap_tpu_torch.apps.degree import DegreeProgram
from graphtap_tpu_torch.apps.pagerank import PageRankProgram
from graphtap_tpu_torch.config import EngineConfig, Ordering
from graphtap_tpu_torch.engine.executor import Executor

FIELDS = ("rank", "degree")
CF_TIMES = ("cf_tiles", "cf_plans", "cf_upload")


def phase_masks(rows, cols, nv: int) -> Dict[str, torch.Tensor]:
    """Each TCSC_CF phase's stored edges, with the vertex classes taken
    from the edges (``reference.classes``): "first" the regular rows',
    "middle" regular rows x regular columns, "last" all but regular rows
    x sink columns (columns whose row holds no edge)."""
    has_in, regular = reference.classes(rows, cols, nv)
    regular_row = regular[rows]
    sink_col = ~has_in[cols]
    return {"first": regular_row, "middle": regular_row & ~sink_col,
            "last": ~(regular_row & sink_col)}


def phase_min_bytes(rows, cols, nv: int, state_fields: int
                    ) -> Dict[str, int]:
    """The least bytes one pass over each phase's edges must move:
    ``graph500.min_superstep_bytes``'s rule on the phase's edge subset."""
    rows, cols = torch.as_tensor(rows), torch.as_tensor(cols)
    return {ph: graph500.min_superstep_bytes(rows[m], cols[m], nv,
                                             state_fields)
            for ph, m in phase_masks(rows, cols, nv).items()}


class System:
    def __init__(self, cfg: Dict, edges, device, times: Dict):
        dtype = common.DTYPES[cfg["value_dtype"]]
        self.cfg, self.edges, self.device = cfg, edges, device
        self.min_bytes = None
        g = common.graph(cfg, edges, times)
        self.deg = Executor(g, DegreeProgram(dtype),
                            EngineConfig(stationary=True,
                                         ordering=Ordering.COL),
                            kernel=cfg["degree_kernel"], device=device)
        self.deg.initialize()
        self.deg.execute(1)
        self.degree = common.vertex_order(self.deg,
                                          self.deg.state["degree"])
        self.deg.free()
        self.ex = Executor(g, PageRankProgram(dtype, alpha=cfg["alpha"],
                                              tol=cfg["tol"]),
                           EngineConfig(stationary=True,
                                        ordering=Ordering.ROW),
                           kernel=cfg["kernel"], device=device)
        common.add_times(self.deg, times)
        common.add_times(self.ex, times)
        self.times = times

    def job(self, params: Dict, profile=None, span=common.no_span) -> None:
        """One job; ``profile``: a ``PhaseTimer`` for the port's fenced
        per-phase split (``execute_profiled``), whose counters this job
        adds to the set-up record; ``span(name)``: an annotation around
        each step of the job."""
        before = (profile.counters.get("cf_phase_edges", 0)
                  if profile is not None else 0)
        with span("initialize"):
            self.ex.initialize(other=self.deg)
        with span("execute"):
            common.execute(self.ex, params["iterations"], profile)
        for k in CF_TIMES:
            if k in self.ex.timings:
                self.times[k] = self.ex.timings[k]
        if profile is not None:
            if self.min_bytes is None:
                rows, cols = graph500.stored_edges(
                    *(torch.from_numpy(e).to(self.device)
                      for e in self.edges), self.cfg["graph"])
                self.min_bytes = phase_min_bytes(
                    rows, cols, (1 << self.cfg["scale"]) + 1,
                    self.cfg["state_fields"])
                del rows, cols
            for ph, n in self.min_bytes.items():
                self.times[f"cf_min_bytes.{ph}"] = n
            edges = profile.counters.get("cf_phase_edges", 0) - before
            if edges:
                for k, n in (("cf_phase_edges", edges),
                             ("cf_supersteps", self.ex.iteration + 1)):
                    self.times[f"counters.{k}"] = (
                        self.times.get(f"counters.{k}", 0) + n)

    def supersteps(self) -> int:
        """The supersteps the last job ran (the flush not counted)."""
        return self.ex.iteration

    def snapshot(self, params: Dict) -> Dict:
        snap = {k: self.ex.state[k].clone() for k in FIELDS}
        snap["supersteps"] = self.ex.iteration
        return snap

    def answer(self, snap: Dict) -> Dict:
        """A job's answer in vertex order, with the degree phase's."""
        out = {k: common.vertex_order(self.ex, snap[k]) for k in FIELDS}
        out["supersteps"] = snap["supersteps"]
        out["degree_phase"] = self.degree
        return out

    def free(self) -> None:
        self.ex.free()


def make_reference(cfg: Dict, traffic: Dict, rows, cols, nv: int):
    return reference.Reference(rows, cols, nv, cfg["alpha"], cfg["tol"])


def compare(ref, answer: Dict) -> Dict:
    return ref.compare(answer, answer["degree_phase"])


def control(cfg: Dict, traffic: Dict, ref, rows, cols, nv: int,
            roots) -> List[Dict]:
    """The lower-precision control's answers, in the program's place."""
    return [reference.control_answers(rows, cols, nv, cfg["alpha"],
                                      cfg["tol"])]


def control_compare(ref, answer: Dict) -> Dict:
    """The control's numbers: its degree phase is the reference's own."""
    return ref.compare(answer, ref.degree)
