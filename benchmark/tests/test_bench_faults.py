"""A run with the timed path broken underneath comes out not correct,
for each fault a single-card cell can have: a superstep that returns its
state unchanged, half of the rows (every other one) left out of the SpMV, and an answer
altered where the program produces it. (No cell spans chips, so none
can leave out an exchange between them.) The unbroken run is correct."""

import pytest
import torch

from bench_testutil import BFS_CELL, PR_CELL, run_tiny, tiny_copy
from graphtap_tpu_torch.apps.bfs import BFSProgram
from graphtap_tpu_torch.apps.pagerank import PageRankProgram
from graphtap_tpu_torch.engine.executor import Executor


def _unchanged(monkeypatch):
    def step(self, V, m, it, phase, timer=None, c=None):
        C = torch.zeros_like(self._dev["i_own"], dtype=torch.bool)
        return V, C, {"gated": False, "sparse": None, "sparse_y": None}
    monkeypatch.setattr(Executor, "_step", step)


def _half_rows(monkeypatch):
    combine = Executor._combine

    def half(self, x, phase):
        y, gated = combine(self, x, phase)
        y = y.clone()
        y[1::2] = self.program.semiring.identity     # every other row
        return y, gated
    monkeypatch.setattr(Executor, "_combine", half)


def _altered(monkeypatch):
    pr_apply, bfs_apply = PageRankProgram.applicator, BFSProgram.applicator

    def pr(self, state, y, it):
        V, changed = pr_apply(self, state, y, it)
        rank = V["rank"].clone()
        rank[1] *= 1.01
        return {**V, "rank": rank}, changed

    def bfs(self, state, y, it):
        V, newly = bfs_apply(self, state, y, it)
        hops = V["hops"].clone()
        first = torch.nonzero(newly)[:1]
        hops[first] += 1
        return {**V, "hops": hops}, newly
    monkeypatch.setattr(PageRankProgram, "applicator", pr)
    monkeypatch.setattr(BFSProgram, "applicator", bfs)


FAULTS = {"state_unchanged": _unchanged, "half_rows": _half_rows,
          "answer_altered": _altered}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_copy(tmp_path_factory.mktemp("tiny"))


@pytest.mark.parametrize("cell", [PR_CELL, BFS_CELL])
def test_unbroken_run_is_correct(root, cell):
    res = run_tiny(root, cell)
    assert res["correct"] and res["failed"] == 0, res["checks"]


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", [PR_CELL, BFS_CELL])
def test_broken_run_is_not_correct(root, cell, fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    res = run_tiny(root, cell)
    assert res["correct"] is False, res["checks"]
    assert res["failed"] >= 1
