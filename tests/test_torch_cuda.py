"""The CUDA kernels against their plain torch versions, on the card.

Marked ``gpu``: each test skips (with a reason) where torch sees no CUDA
device, and runs on the card with
``python -m pytest tests/test_torch_cuda.py -q``. K1, K2 and K4 must match
bit for bit; K3 bit for bit in int32 and within rtol 1e-5 (f32) / 1e-12
(f64) in float sums, whose atomic adds run in no fixed order.
"""

import numpy as np
import pytest
import torch

from graphtap_tpu_torch import Graph, GraphConfig
from graphtap_tpu_torch.apps import run_pagerank
from graphtap_tpu_torch.ingest import rmat_edges
from graphtap_tpu_torch.kernels import panel_kernels as pk
from graphtap_tpu_torch.kernels import semiring as tsr
from graphtap_tpu_torch.kernels.panel_engine import spmv3_stages
from graphtap_tpu_torch.kernels.panel_meta import build_spmv3_meta
from graphtap_tpu_torch.tools.convert import meta_from_numpy

pytestmark = pytest.mark.gpu

FOLD_RTOL = {torch.float32: 1e-5, torch.float64: 1e-12}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype,weighted", [(np.float32, False),
                                            (np.float64, True),
                                            (np.int32, True)])
def test_kernels_match_plain(cuda, dtype, weighted):
    sem = tsr.min_plus() if dtype == np.int32 else tsr.plus_times()
    r, c, w = rmat_edges(12, 16, seed=3, weighted=weighted)
    g = Graph.from_edges(r, c, w, GraphConfig(num_vertices=1 << 12,
                                              transpose=True))
    meta = build_spmv3_meta(g.tiled(), value_dtype=dtype)
    t = meta_from_numpy(meta.arrays, cuda)
    rng = np.random.default_rng(1)
    if dtype == np.int32:
        x = rng.integers(0, 1000, size=g.part.tile_cols).astype(dtype)
        x[rng.random(x.size) < 0.3] = tsr.INF_I32
    else:
        x = rng.random(g.part.tile_cols).astype(dtype)
    before = dict(pk.LAUNCHES)
    st = spmv3_stages(torch.from_numpy(x).to(cuda), t, meta, sem,
                      g.part.tile_rows)
    assert {k: pk.LAUNCHES[k] - before[k] for k in before} == {
        "route_xr_exp": 1, "route_passa": 1, "route_fold": 2,
        "hub_fold": 1}
    fill, kind = sem.identity, sem.reduce_kind
    mul = ("mul" if kind == "sum" else "add_sat") if weighted else "none"
    xe = (st["x2d"], t["xr_bases"], t["xe_plan"], t.get("w_stream"), fill,
          meta.exp_panels + 1, meta.xr_nwin, mul)
    assert torch.equal(st["s0"], pk.route_xr_exp_plain(*xe))
    pa = (st["s0"], t["pa_bases"], t["pa_plan"], fill, meta.pa_panels + 1,
          meta.pa_nwin)
    assert torch.equal(st["s1"], pk.route_passa_plain(*pa))
    assert torch.equal(st["y_hub"],
                       pk.hub_fold_plain(st["y_mid"], t["hub_mask"], kind))
    folds = [
        (st["y_mid"], (st["s1"], t["fixr_bases"], t["fixr_plan"],
                       t["fix_dst"], t["fixr_seg"], meta.nrb, kind, fill,
                       meta.fix_panels, meta.fixr_nwin)),
        (st["y"].view(-1), (st["y_hub"], t["f2_bases"], t["f2_plan"],
                            t["fix2_dst"], t["f2_seg"], meta.f2_rows, kind,
                            fill, meta.f2_panels, meta.f2_nwin))]
    for got, args in folds:
        want = pk.route_fold_plain(*args).view(-1)[:got.numel()].view(
            got.shape)
        if got.dtype.is_floating_point:
            torch.testing.assert_close(got, want, rtol=FOLD_RTOL[got.dtype],
                                       atol=0)
        else:
            assert torch.equal(got, want)


def test_pagerank_on_cuda_matches_cpu(cuda):
    r, c, _ = rmat_edges(12, 16, seed=1)
    g = Graph.from_edges(r, c, None, GraphConfig(num_vertices=1 << 12,
                                                 transpose=True))
    on_card = run_pagerank(g, 20, torch.float64, kernel="panel",
                           device=cuda)
    on_cpu = run_pagerank(g, 20, torch.float64, kernel="panel")
    np.testing.assert_allclose(on_card.state_vector()["rank"],
                               on_cpu.state_vector()["rank"], rtol=1e-12,
                               atol=0)


def test_wrappers_reject_mixed_devices(cuda):
    r, c, _ = rmat_edges(8, 16, seed=1)
    g = Graph.from_edges(r, c, None, GraphConfig(num_vertices=256,
                                                 transpose=True))
    meta = build_spmv3_meta(g.tiled(), np.float32)
    t = meta_from_numpy(meta.arrays, "cpu")
    s0 = torch.zeros(((meta.exp_panels + 1) * 64, 128), device=cuda)
    with pytest.raises(ValueError):
        pk.route_passa(s0, t["pa_bases"], t["pa_plan"], 0.0,
                       meta.pa_panels + 1, meta.pa_nwin)
