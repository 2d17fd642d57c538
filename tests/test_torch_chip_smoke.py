"""``chip_smoke.py``'s runs on the CPU at RMAT-8: each run's app reaches its
end through its entry point, the recorder sees every K5-from-the-plan
call (one a superstep; the converging runs one more, their closing
superstep) with the semiring each cell's kernel folds, each recorded
output equals ``segment_reduce_gather_plain`` of its recorded inputs, and
the composition the smoke times beside the kernel gives the same bits.
On the CPU no hand kernel launches, so no launch is counted."""

import os
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from graphtap_tpu_torch.kernels import onehot_spmv as oh  # noqa: E402

# run -> (x's dtype, reduce kind, ⊗ kind, fixed supersteps)
KINDS = {"pagerank": (torch.float32, "sum", "none", True),
         "bfs": (torch.int32, "min", "none", False),
         "sssp": (torch.float32, "min", "add_sat", False),
         "sssp_i32": (torch.int32, "min", "add_sat", False)}


@pytest.mark.parametrize("name", sorted(chip_smoke.RUNS))
def test_smoke_run_records_every_k5_call(name):
    assert set(KINDS) == set(chip_smoke.RUNS)
    dtype, reduce_kind, mul_kind, fixed = KINDS[name]
    ex, calls, launches, _ = chip_smoke.recorded_run(name, 8, "cpu")
    assert launches == {}
    assert len(calls) == ex.iteration + (0 if fixed else 1) > 1
    assert oh.segment_reduce_gather.__name__ == "segment_reduce_gather"
    for args, kw, y in calls:
        assert (args[0].dtype, args[9], args[10]) == (dtype, reduce_kind,
                                                      mul_kind)
        assert (args[3] is None) == (mul_kind == "none")
        assert torch.equal(y, oh.segment_reduce_gather_plain(*args))
    args, kw, y = calls[-1]
    assert torch.equal(chip_smoke.composition(ex.program.semiring, args,
                                              kw)(), y)
    ex.free()
