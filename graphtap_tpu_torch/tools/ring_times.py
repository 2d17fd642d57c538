"""Device times of the plan-ring kernels K1 (``route_xr_exp``) and K11
(``route_expand``) at the RMAT-20 f32 PageRank shapes, and of P1
(``copy_blocks``) at its kernels-line shape, each beside its PyTorch call.

    python -m graphtap_tpu_torch.tools.ring_times

The RMAT-20 panel meta (edge factor 16, seed 1, transposed TCSC, f32, as
``run_pagerank`` plans it) is planned once (minutes) and kept in the
package's build directory under a name that carries those settings
(``meta_path``). So two checkouts can be timed in one run on the same
plan: run this file by its path with the other checkout first on
``PYTHONPATH``, and its kernels are the ones timed (that checkout's
``tools/timing.py`` must have ``device_ms``). x is seeded, unweighted
PageRank-like values. Each kernel is held against its plain version and
its PyTorch call bit for bit, then timed device-only
(``timing.device_ms``: ten calls replayed as one CUDA graph). Prints the
card's name and power limit, then one JSON line per kernel: name, device
ms, the PyTorch call's device ms (``torch.take`` over an index
precomputed from the plan; ``Tensor.copy_``), bytes moved (each input
read once, each output written once). Needs a card.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch

from graphtap_tpu_torch.tools.timing import device_ms, slot_ids, take_call

SCALE, EDGE_FACTOR, SEED = 20, 16, 1
BUILD = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "build")


def meta_path(directory: str = BUILD, scale: int = SCALE) -> str:
    """Where the panel meta of RMAT-``scale`` is kept: its name carries
    every setting it was planned from."""
    return os.path.join(directory, f"ring_times_rmat{scale}_ef{EDGE_FACTOR}"
                                   f"_seed{SEED}_tcsc_f32.npz")


def load_meta(path: str, scale: int = SCALE):
    """The f32 PageRank panel meta of RMAT-``scale``, read from ``path``
    (``meta_path``) where it exists, else planned and written there."""
    from graphtap_tpu_torch import Graph, GraphConfig
    from graphtap_tpu_torch.ingest import rmat_edges
    from graphtap_tpu_torch.kernels.panel_meta import build_spmv3_meta
    from graphtap_tpu_torch.tools import artifact_cache as ac
    if os.path.exists(path):
        return ac.load_spmv3_meta(path)
    r, c, _ = rmat_edges(scale, EDGE_FACTOR, seed=SEED)
    g = Graph.from_edges(r, c, None, GraphConfig(num_vertices=1 << scale,
                                                 transpose=True))
    meta = build_spmv3_meta(g.tiled(), value_dtype=np.float32)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    ac.save_spmv3_meta(meta, path)
    return meta


def copy_row(device="cuda", copy_bytes=None):
    """(name, kernel call, plain call, PyTorch call, bytes) of P1 on
    ``copy_bytes`` (default the probe's TARGET_BYTES) in (256, 1024)
    tiles, the smoke's kernels-line shape."""
    from graphtap_tpu_torch.tools import bw_probe as bw
    xc = torch.rand(((copy_bytes or bw.TARGET_BYTES) // 4096, 1024),
                    device=device)
    yc = torch.empty_like(xc)
    return ("copy_blocks", lambda: bw.copy_blocks(xc, 256, 1024),
            lambda: bw.copy_blocks_plain(xc, 256, 1024),
            lambda: yc.copy_(xc), 2 * xc.numel() * 4)


def rows(meta, device="cuda", copy_bytes=None):
    """The rows of K1 and K11 on ``meta`` and P1 (``copy_row``), their
    inputs on ``device``."""
    from graphtap_tpu_torch.kernels import panel_kernels as pk
    from graphtap_tpu_torch.kernels.panel_engine import (pad_x,
                                                         staged_tables)
    from graphtap_tpu_torch.tools.convert import meta_from_numpy
    t = staged_tables(meta_from_numpy(meta.arrays, device), meta)
    rng = np.random.default_rng(SEED)
    x = torch.from_numpy(rng.random(meta.NC).astype(np.float32)).to(device)
    x2d = pad_x(x, meta, 0.0)
    nxe = meta.exp_panels + 1
    xr = (x2d, t["xr_bases"], t["xr_plan"], 0.0, nxe, meta.xr_nwin)
    one = dict(out_rows=pk.XROWS, two_layer=False)
    x_ext = pk.route_passa(*xr, **one)
    panel = pk.PROWS * pk.LANES * 4
    k1 = (x2d, t["xr_bases"], t["xe_plan"], None, 0.0, nxe, meta.xr_nwin)
    k1_idx = pk.route_xr_exp_plain(slot_ids(x2d), *k1[1:4], -1, *k1[5:])
    k11 = (x_ext, t["exp_plan"], None, 0.0, nxe)
    k11_idx = pk.route_expand_plain(slot_ids(x_ext), k11[1], None, -1, nxe)
    return [
        ("route_xr_exp", lambda: pk.route_xr_exp(*k1),
         lambda: pk.route_xr_exp_plain(*k1), take_call(x2d, k1_idx, 0.0),
         x2d.numel() * 4 + 4 * nxe * meta.xr_nwin
         + nxe * pk.xe_plan_rows(meta.xr_nwin) * pk.LANES + nxe * panel),
        ("route_expand", lambda: pk.route_expand(*k11),
         lambda: pk.route_expand_plain(*k11), take_call(x_ext, k11_idx, 0.0),
         x_ext.numel() * 4 + nxe * pk.plan_rows(pk.XROWS) * pk.LANES
         + nxe * panel),
        copy_row(device, copy_bytes)]


def check(name, kern, plain, lib) -> None:
    """The kernel call equals its plain version and its PyTorch call bit
    for bit."""
    a = kern()
    if not torch.equal(a, plain()) or not torch.equal(lib().view(a.shape),
                                                      a):
        raise AssertionError(f"{name}: the kernel, its plain version and "
                             f"its PyTorch call disagree")


def main() -> int:
    if not torch.cuda.is_available():
        print("ring_times: no CUDA device; it times the card",
              file=sys.stderr)
        return 1
    import graphtap_tpu_torch
    from graphtap_tpu_torch.tools.bw_probe import card
    print(f"{card()} ({torch.cuda.get_device_name(0)}); package "
          f"{os.path.dirname(graphtap_tpu_torch.__file__)}", flush=True)
    for name, kern, plain, lib, nbytes in rows(load_meta(meta_path())):
        check(name, kern, plain, lib)
        print(json.dumps({"name": name, "device_ms": device_ms(kern),
                          "library_device_ms": device_ms(lib),
                          "bytes": nbytes}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
