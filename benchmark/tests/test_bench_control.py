"""Each cell's lower-precision control comes out not correct under the
cell's limits, at sizes a test run holds: PageRank's reference in
bfloat16 at scale 10, BFS with int16 messages at scale 16 (more vertices
than int16 holds, as at the cell's scale 21)."""

import pytest
import torch

from bench_testutil import BFS_CELL, PR_CELL, tiny_copy
from benchmark import control


@pytest.mark.parametrize("cell,scale", [(PR_CELL, 10), (BFS_CELL, 16)])
@pytest.mark.parametrize("seed", [1, 2, 3000000001])
def test_control_is_not_correct(tmp_path, cell, scale, seed):
    root = tiny_copy(tmp_path, scale)
    rec = control.readings(cell, seed, torch.device("cpu"), lambda m: None,
                           root=root)
    assert rec["correct"] is False, rec
