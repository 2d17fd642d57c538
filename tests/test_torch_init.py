"""Each app's ``init`` builds its state on the device in torch: the same
values and dtypes, bit for bit, as the JAX package's numpy ``init`` on the
same rows (every rank's ``vids`` and ``i_mask`` row of a 1x1 and a 2x2
partition of RMAT-12's TCSC tiles; PageRank fresh and with a degree
handed over), and no returned tensor shares storage with ``vids``,
``i_mask`` or the handed-over state."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphtap_tpu.apps import (BFSProgram as JBFS, CCProgram as JCC,
                               DegreeProgram as JDegree,
                               PageRankProgram as JPageRank,
                               SSSPProgram as JSSSP)
from graphtap_tpu_torch import Compression
from graphtap_tpu_torch.apps import (BFSProgram, CCProgram, DegreeProgram,
                                     PageRankProgram, SSSPProgram)
from graphtap_tpu_torch.format.tiles import build_tileset
from graphtap_tpu_torch.ingest import rmat_edges
from graphtap_tpu_torch.parallel.layout import Partition

N = 1 << 12
ROOT = 3000

# case -> (the port's program, the JAX package's, whether a degree is
# handed over)
CASES = {
    "degree": (lambda: DegreeProgram(torch.float32),
               lambda: JDegree(jnp.float32), False),
    "pagerank": (lambda: PageRankProgram(torch.float32),
                 lambda: JPageRank(jnp.float32), False),
    "pagerank_handed": (lambda: PageRankProgram(torch.float32),
                        lambda: JPageRank(jnp.float32), True),
    "bfs": (lambda: BFSProgram(root=ROOT), lambda: JBFS(root=ROOT), False),
    "cc": (CCProgram, JCC, False),
    "sssp_weighted": (lambda: SSSPProgram(root=ROOT),
                      lambda: JSSSP(root=ROOT), False),
    "sssp_unweighted": (lambda: SSSPProgram(root=ROOT, weighted=False),
                        lambda: JSSSP(root=ROOT, weighted=False), False),
}


@pytest.fixture(scope="module", params=[(1, 1), (2, 2)],
                ids=["mesh1x1", "mesh2x2"])
def rows(request):
    """(vids, i_own), each (D, L), of the partition's TCSC tiles."""
    R, C = request.param
    r, c, _ = rmat_edges(12, 16, seed=1)
    part = Partition.build(N + 1, R, C)
    tiles = build_tileset(r, c, None, part, compression=Compression.TCSC)
    return part.owner_vids(), tiles.i_own


def _shares(a: torch.Tensor, b: torch.Tensor) -> bool:
    sa, sb = a.untyped_storage(), b.untyped_storage()
    return sa.data_ptr() == sb.data_ptr() and sa.nbytes() > 0


@pytest.mark.parametrize("case", sorted(CASES))
def test_init_matches_jax(rows, case):
    make, jmake, handed = CASES[case]
    vids, i_own = rows
    assert i_own.any() and (~i_own).any()
    rng = np.random.default_rng(7)
    for b in range(vids.shape[0]):
        v, m = torch.from_numpy(vids[b]), torch.from_numpy(i_own[b])
        other = jother = None
        if handed:
            deg = rng.integers(0, 50, vids.shape[1]).astype(np.float32)
            other, jother = {"degree": torch.from_numpy(deg)}, \
                {"degree": deg[None]}
        state, changed = make().init(v, m, other)
        jstate, jchanged = jmake().init(vids[b:b + 1], i_own[b:b + 1],
                                        jother)
        assert sorted(state) == sorted(jstate)
        for k, t in list(state.items()) + [("changed", changed)]:
            want = np.asarray(jstate[k] if k != "changed" else jchanged)[0]
            got = t.numpy()
            assert got.dtype == want.dtype, (case, b, k)
            assert got.shape == want.shape, (case, b, k)
            assert got.tobytes() == want.tobytes(), (case, b, k)
            inputs = [v, m] + list((other or {}).values())
            assert not any(_shares(t, x) for x in inputs), (case, b, k)
