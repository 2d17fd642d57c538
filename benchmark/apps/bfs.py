"""BFS queries as users run them on the port: one executor, and each
job sets its root on the executor's ``BFSProgram`` (which only ``init``
reads), then ``initialize()`` and ``execute(0)`` to convergence."""

from __future__ import annotations

from typing import Dict, List

from benchmark.apps import common
from benchmark.reference import bfs as reference
from graphtap_tpu_torch.apps.bfs import BFSProgram
from graphtap_tpu_torch.config import EngineConfig, Ordering
from graphtap_tpu_torch.engine.executor import Executor

FIELDS = ("parent", "hops")


class System:
    def __init__(self, cfg: Dict, edges, device, times: Dict):
        if common.DTYPES[cfg["value_dtype"]] != BFSProgram.value_dtype:
            raise ValueError(f"BFS runs in {BFSProgram.value_dtype}, not "
                             f"{cfg['value_dtype']}")
        g = common.graph(cfg, edges, times)
        self.ex = Executor(g, BFSProgram(root=0),
                           EngineConfig(stationary=False,
                                        apply_depends_on_iter=True,
                                        ordering=Ordering.ROW),
                           kernel=cfg["kernel"], device=device)
        common.add_times(self.ex, times)

    def job(self, params: Dict, profile=None, span=common.no_span) -> None:
        self.ex.program.root = params["root"]
        with span("initialize"):
            self.ex.initialize()
        with span("execute"):
            common.execute(self.ex, params["iterations"], profile)

    def supersteps(self) -> int:
        """The supersteps the last job ran (the flush not counted)."""
        return self.ex.iteration

    def snapshot(self, params: Dict) -> Dict:
        snap = {k: self.ex.state[k].clone() for k in FIELDS}
        snap.update(root=params["root"], supersteps=self.ex.iteration)
        return snap

    def answer(self, snap: Dict) -> Dict:
        out = dict(snap)
        for k in FIELDS:
            out[k] = common.vertex_order(self.ex, snap[k])
        return out

    def free(self) -> None:
        self.ex.free()


def make_reference(cfg: Dict, traffic: Dict, rows, cols, nv: int):
    return reference.Reference(rows, cols, nv)


def compare(ref, answer: Dict) -> Dict:
    return ref.compare(answer)


def control(cfg: Dict, traffic: Dict, ref, rows, cols, nv: int,
            roots) -> List[Dict]:
    """The lower-precision control's answers, in the program's place."""
    return reference.control_answers(ref, roots)


def control_compare(ref, answer: Dict) -> Dict:
    return ref.compare(answer)
