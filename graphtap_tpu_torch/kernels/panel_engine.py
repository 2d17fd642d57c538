"""The v3 panel SpMV on one device: x (NC,) -> y_dense, through K1-K4.

Counterpart of ``graphtap_tpu/kernels/panel_engine.py::spmv3_local``,
static branch (``gate=False``, the stationary PageRank path). The glue the
JAX package leaves to XLA stays plain torch here: the x padding and its
appended fill block, the five-call chain, the ``f2_segok`` mask and the
final slice. The meta (``kernels/panel_meta.py``) is built on the host;
``t`` is its arrays as tensors on the run's device
(``tools/convert.py::meta_from_numpy``).

  x -> K1 route_xr_exp (x_ext in shared memory, ⊗w) -> s0
    -> K2 route_passa (corner turn) -> s1
    -> K3 route_fold (fixr, segmented y_mid) -> K4 hub_fold
    -> K3 route_fold (fix2, straight into the dense y)
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from graphtap_tpu_torch.kernels.panel_kernels import (
    FOLD_SEG_ROWS, LANES, STRIPE, hub_fold, route_fold, route_passa,
    route_xr_exp)
from graphtap_tpu_torch.kernels.panel_meta import Spmv3Meta
from graphtap_tpu_torch.kernels.semiring import Semiring


def spmv3_stages(x: torch.Tensor, t: Dict[str, torch.Tensor],
                 meta: Spmv3Meta, semiring: Semiring,
                 dense_len: int) -> Dict[str, torch.Tensor]:
    """Every stage of one SpMV: the padded x table ``x2d``, the
    contribution stream ``s0``, the corner-turned ``s1``, the fixr fold
    ``y_mid``, its hub fold ``y_hub`` and the result ``y`` (dense_len,)."""
    if meta.has_w:
        mul_kind = "mul" if semiring.reduce_kind == "sum" else "add_sat"
    else:
        mul_kind = "none"
    fill = semiring.identity
    kind = semiring.reduce_kind
    # x padded to sx rows, then one appended all-fill block
    sx = meta.sx_rows
    x2d = torch.full(((sx + STRIPE) * LANES,), fill, dtype=x.dtype,
                     device=x.device)
    x2d[:x.shape[0]] = x
    x2d = x2d.view(sx + STRIPE, LANES)
    # K1 and K2 each emit a trailing fill panel (meta panels + 1): the
    # pa / fixr fill windows at blocks exp_panels*8 / pa_panels*8 read it
    s0 = route_xr_exp(x2d, t["xr_bases"], t["xe_plan"], t.get("w_stream"),
                      fill, meta.exp_panels + 1, meta.xr_nwin, mul_kind)
    s1 = route_passa(s0, t["pa_bases"], t["pa_plan"], fill,
                     meta.pa_panels + 1, meta.pa_nwin)
    y_mid = route_fold(s1, t["fixr_bases"], t["fixr_plan"], t["fix_dst"],
                       t["fixr_seg"], meta.nrb, kind, fill, meta.fix_panels,
                       meta.fixr_nwin)
    # hub rows: lane-⊕-fold at the row's packed slot width
    y_hub = hub_fold(y_mid, t["hub_mask"], kind)
    # fix2 lands straight in the dense y layout
    y_dense = route_fold(y_hub, t["f2_bases"], t["f2_plan"], t["fix2_dst"],
                         t["f2_seg"], meta.f2_rows, kind, fill,
                         meta.f2_panels, meta.f2_nwin)
    # dense segments no fix2 panel visits hold the ⊕-identity (the fold
    # table starts filled; the mask keeps the JAX package's contract)
    if not bool(np.all(meta.arrays["f2_segok"])):
        seg_rows2 = min(meta.f2_rows, FOLD_SEG_ROWS)
        ok = torch.repeat_interleave(t["f2_segok"] != 0, seg_rows2)[:, None]
        y_dense = torch.where(
            ok, y_dense, torch.tensor(fill, dtype=y_dense.dtype,
                                      device=y_dense.device))
    return {"x2d": x2d, "s0": s0, "s1": s1, "y_mid": y_mid, "y_hub": y_hub,
            "y": y_dense.reshape(-1)[:dense_len]}


def spmv3_local(x: torch.Tensor, t: Dict[str, torch.Tensor],
                meta: Spmv3Meta, semiring: Semiring,
                dense_len: int) -> torch.Tensor:
    """One-device v3 SpMV: x (NC,) -> y_dense (dense_len,)."""
    return spmv3_stages(x, t, meta, semiring, dense_len)["y"]
