"""PageRank as users run it on the port: the degree phase once in
set-up, then each job hands its degrees over (``initialize(other=)``)
and runs the traffic's supersteps (``execute``)."""

from __future__ import annotations

from typing import Dict, List

from benchmark.apps import common
from benchmark.reference import pagerank as reference
from graphtap_tpu_torch.apps.degree import DegreeProgram
from graphtap_tpu_torch.apps.pagerank import PageRankProgram
from graphtap_tpu_torch.config import EngineConfig, Ordering
from graphtap_tpu_torch.engine.executor import Executor

FIELDS = ("rank", "degree")


class System:
    def __init__(self, cfg: Dict, edges, device, times: Dict):
        dtype = common.DTYPES[cfg["value_dtype"]]
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
        self.ex = Executor(g, PageRankProgram(dtype, alpha=cfg["alpha"]),
                           EngineConfig(stationary=True,
                                        ordering=Ordering.ROW),
                           kernel=cfg["kernel"], device=device)
        common.add_times(self.deg, times)
        common.add_times(self.ex, times)

    def job(self, params: Dict, profile=None, span=common.no_span) -> None:
        """One job; ``profile``: a ``PhaseTimer`` for the port's fenced
        per-phase split (``execute_profiled``); ``span(name)``: an
        annotation around each step of the job."""
        with span("initialize"):
            self.ex.initialize(other=self.deg)
        with span("execute"):
            common.execute(self.ex, params["iterations"], profile)

    def supersteps(self) -> int:
        """The supersteps the last job ran."""
        return self.ex.iteration

    def snapshot(self, params: Dict) -> Dict:
        return {k: self.ex.state[k].clone() for k in FIELDS}

    def answer(self, snap: Dict) -> Dict:
        """A job's answer in vertex order, with the degree phase's."""
        out = {k: common.vertex_order(self.ex, v) for k, v in snap.items()}
        out["degree_phase"] = self.degree
        return out

    def free(self) -> None:
        self.ex.free()


def make_reference(cfg: Dict, traffic: Dict, rows, cols, nv: int):
    return reference.Reference(rows, cols, nv, traffic["iterations"],
                               cfg["alpha"])


def compare(ref, answer: Dict) -> Dict:
    return ref.compare(answer, answer["degree_phase"])


def control(cfg: Dict, traffic: Dict, ref, rows, cols, nv: int,
            roots) -> List[Dict]:
    """The lower-precision control's answers, in the program's place."""
    return [reference.control_answers(rows, cols, nv, traffic["iterations"],
                                      cfg["alpha"])]


def control_compare(ref, answer: Dict) -> Dict:
    """The control's numbers: its degree phase is the reference's own."""
    return ref.compare(answer, ref.degree)
