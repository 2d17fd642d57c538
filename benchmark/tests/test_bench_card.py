"""On the card: both cells at a tiny scale through the hand kernels,
with the traced extras (the profiler's timeline, the CUDA-graph
superstep). Skips without a CUDA card."""

import time

import pytest

from bench_testutil import BFS_CELL, PR_CELL, tiny_copy


@pytest.mark.gpu
@pytest.mark.parametrize("cell", [PR_CELL, BFS_CELL])
def test_tiny_cell_on_the_card(tmp_path, cell):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from benchmark import harness
    root = tiny_copy(tmp_path, 12)
    res = harness.run_cell(cell, 5, 0.5, True, torch.device("cuda", 0),
                           time.perf_counter(), print, root=root)
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu"
    assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
    assert res["breakdown"]["device_ops"]
