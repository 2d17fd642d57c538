"""The benchmark's frozen Kronecker generator equals the port's when it
draws NumPy's uniforms of the seed, and a run's uniforms, drawn by torch's
generator of the seed, give the same edges for the same seed."""

import numpy as np
import pytest
import torch

import bench_testutil  # noqa: F401  (puts the repository on sys.path)
from benchmark import graph500
from graphtap_tpu_torch.ingest.rmat import rmat_edges


def _edges(scale, seed):
    return graph500.kronecker_edges(scale, 16, 0.57, 0.19, 0.19,
                                    graph500.uniforms(seed,
                                                      torch.device("cpu")))


@pytest.mark.parametrize("scale,seed", [(6, 0), (8, 1), (9, 3000000001),
                                        (10, 2**31 + 5)])
def test_generator_matches_port(scale, seed):
    rng = np.random.default_rng(graph500.rng_seed(seed))
    r, c = graph500.kronecker_edges(
        scale, 16, 0.57, 0.19, 0.19, lambda n: torch.from_numpy(rng.random(n)))
    pr, pc, _ = rmat_edges(scale, 16, seed=seed)
    np.testing.assert_array_equal(r.numpy(), pr)
    np.testing.assert_array_equal(c.numpy(), pc)


def test_same_seed_same_edges_other_seed_other_edges():
    a, b, c = _edges(8, 11), _edges(8, 11), _edges(8, 12)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert not torch.equal(a[0], c[0])


def test_negative_seed_is_taken():
    r, _ = _edges(6, -3)
    assert r.numel() == 16 << 6
