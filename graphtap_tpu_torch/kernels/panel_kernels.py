"""The v3 panel-route kernels: CUDA wrappers, plain torch versions, counts.

Counterpart of ``graphtap_tpu/kernels/panel_kernels.py``. Each of its
seven Pallas kernels has here

  * a wrapper (``route_xr_exp``, ``route_passa``, ``route_fold``,
    ``hub_fold`` on the fused path; ``route_expand``, ``fold_stripes``,
    ``colsum_chunks`` and ``route_passa``'s single-layer form on the
    staged one) that checks dtype, shape and contiguity, then runs the
    plain version for a CPU tensor or launches the hand-written Hopper
    kernel (``csrc/panel_route.cu``) for a CUDA tensor — never a fallback;
  * a plain torch version (``*_plain``) of the same function, which the
    CPU tests hold against the Pallas kernels and the ``gpu`` tests
    (``tests/test_torch_cuda.py``) hold against the CUDA kernels;
  * a launch count in ``LAUNCHES``, incremented only where the wrapper
    launches the CUDA kernel (``route_passa_single`` counts the
    single-layer launches of ``route_passa``).

K3's float sums fold in a fixed order (``fold_order.py``), which its
plain version follows, so the two agree bit for bit and a call gives the
same bits every time; K13 still folds with atomics.

K1-K3 also take ``plan_idx`` ((npanels,) int32, default None = static):
the frontier-gated variant of the Pallas kernels' ``plan_idx`` branch,
where panel i reads plan block ``plan_idx[i]`` (K1 also its weight block
there) instead of block i; window bases, and K3's dst and seg, stay
panel i's. Gated launches count under ``<name>_gated``. A gated call
also names ``fill_block``, the route's all-fill plan block (sel all 0xF8,
pure ⊕-identity output; ``panel_meta.fill_blocks``): the CUDA kernel
skips the gathers of a panel pointed there, which computes what the plain
version computes through that plan.

Route semantics, shared by K1-K3 and K11. A panel's plan block is uint8
rows [idx1 (nsrc*8), sel_a (out), sel_b (out, two-layer only), idx3
(out)]. For output slot (r, l): m = idx3[r,l] & 127; s = (idx3[r,l] >=
128 ? sel_b : sel_a)[r, m]; band = s >> 3, row = s & 7; the value is
src_band[band][row, idx1[band*8+row, m]] if band < nsrc, else the fill
(⊕-identity) — a band past the source is fill, never a wrapped read.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from graphtap_tpu_torch.kernels import _cuda
from graphtap_tpu_torch.kernels.fold_order import (fold_args, fold_lists,
                                                   list_fold, ordered_fold,
                                                   row_lists)
from graphtap_tpu_torch.kernels.panel_plan import (FOLD_SEG_ROWS, LANES,
                                                   PROWS, STRIPE, XROWS)

# launches of each CUDA kernel (the plain versions are not counted)
LAUNCHES = {"route_xr_exp": 0, "route_passa": 0, "route_fold": 0,
            "hub_fold": 0, "route_xr_exp_gated": 0, "route_passa_gated": 0,
            "route_fold_gated": 0, "route_passa_single": 0,
            "route_expand": 0, "fold_stripes": 0, "colsum_chunks": 0}

_DTYPES = {torch.float32: 0, torch.float64: 1, torch.int32: 2}
_MUL_KINDS = {"none": 0, "mul": 1, "add_sat": 2}
_REDUCE_KINDS = {"sum": 0, "min": 1, "max": 2}
# the ⊕ kinds each value type takes on the CUDA side
_REDUCE_OK = {torch.float32: ("sum",), torch.float64: ("sum",),
              torch.int32: ("sum", "min", "max")}
# K13: a y row of more chunks than this folds on blocks of its own
COLSUM_LONG = 32


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ------------------------------------------------------------ plan packing
def pack_route_plan(idx1, sel_a, sel_b, idx3, npanels: int, src_rows: int,
                    out_rows: int = PROWS, two_layer: bool = True
                    ) -> np.ndarray:
    """Concatenate a route's per-panel plan arrays row-wise into one
    uint8 stream: per panel [idx1 (src_rows), sel_a (out_rows),
    sel_b (out_rows, two-layer only), idx3 (out_rows)]."""
    pieces = [np.asarray(idx1).astype(np.uint8).reshape(
        npanels, src_rows, LANES),
        np.asarray(sel_a).astype(np.uint8).reshape(npanels, out_rows, LANES)]
    if two_layer:
        pieces.append(np.asarray(sel_b).astype(np.uint8).reshape(
            npanels, out_rows, LANES))
    pieces.append(np.asarray(idx3).astype(np.uint8).reshape(
        npanels, out_rows, LANES))
    return np.concatenate(pieces, axis=1).reshape(-1, LANES)


def plan_rows(src_rows: int, out_rows: int = PROWS,
              two_layer: bool = True) -> int:
    return src_rows + (3 if two_layer else 2) * out_rows


# K1-K3 and K11 on the card: shared memory a block may have (the H100's
# 227 KB), the stages of K1's, K2's and K11's plan rings, and the mbarrier
# beside each stage
SMEM_BLOCK = 232_448
PASSA_STAGES = 2
XE_STAGES = 2
EX_STAGES = 2
_MBAR_BYTES = 8


def _fits(stages: int, stage_bytes: int, extra: int = 0) -> bool:
    """``stages`` ring stages of ``stage_bytes`` (+ an mbarrier each) and
    ``extra`` bytes beside them fit a block's shared memory."""
    return stages * (stage_bytes + _MBAR_BYTES) + extra <= SMEM_BLOCK


def passa_form(nwin: int, out_rows: int, two_layer: bool,
               itemsize: int) -> str:
    """The form of K2's kernel for these shapes: 'staged' when two stages
    of (plan block + the panel's nwin source windows of ``itemsize``-byte
    values) fit a block's shared memory, else 'unstaged' (two stages of
    plan blocks; values read from device memory). Raises ValueError when
    two plan blocks alone do not fit: past nwin 89 two-layer (64 rows)
    and 105 single-layer (32 rows); a plan's bands are uint8 >> 3, so no
    route reads more than 32 windows."""
    plan_bytes = plan_rows(nwin * STRIPE, out_rows, two_layer) * LANES
    win_bytes = nwin * STRIPE * LANES * itemsize
    if nwin <= 32 and _fits(PASSA_STAGES, plan_bytes + win_bytes):
        return "staged"
    if _fits(PASSA_STAGES, plan_bytes):
        return "unstaged"
    raise ValueError(
        f"route_passa: nwin {nwin} needs a {plan_bytes}-byte plan block; "
        f"{PASSA_STAGES} of them exceed the {SMEM_BLOCK} bytes of shared "
        f"memory a block may have (nwin <= 89 two-layer, <= 105 "
        f"single-layer)")


def xe_plan_rows(nwin: int) -> int:
    """Rows per panel of the fused x->x_ext + expand plan (K1)."""
    return plan_rows(nwin * STRIPE, XROWS, False) + plan_rows(XROWS)


def xr_exp_smem(nwin: int, itemsize: int) -> int:
    """Shared memory of K1's block on the card: XE_STAGES plan blocks of
    ``xe_plan_rows(nwin)`` x 128 bytes (an mbarrier each) and the 32-row
    x_ext panel of ``itemsize``-byte values. Raises ValueError past a
    block's 232,448 bytes: nwin 69 for 4-byte values, 61 for 8-byte
    (every meta the repo builds has nwin 24: 139,280 bytes in f32)."""
    plan_bytes = xe_plan_rows(nwin) * LANES
    xe_bytes = XROWS * LANES * itemsize
    if not _fits(XE_STAGES, plan_bytes, xe_bytes):
        raise ValueError(
            f"route_xr_exp: nwin {nwin} needs a {plan_bytes}-byte plan "
            f"block; {XE_STAGES} of them and the {xe_bytes}-byte x_ext "
            f"panel exceed the {SMEM_BLOCK} bytes of shared memory a block "
            f"may have (nwin <= 69 for 4-byte values, <= 61 for 8-byte)")
    return XE_STAGES * (plan_bytes + _MBAR_BYTES) + xe_bytes


def expand_smem(itemsize: int) -> int:
    """Shared memory of K11's block on the card: EX_STAGES stages, each
    a panel's expand plan block (``plan_rows(XROWS)`` x 128 bytes) and
    its 32-row x_ext block of ``itemsize``-byte values beside it, an
    mbarrier each: 90,128 bytes for 4-byte values (two blocks an SM),
    122,896 for 8-byte (one)."""
    return EX_STAGES * (plan_rows(XROWS) * LANES + XROWS * LANES * itemsize
                        + _MBAR_BYTES)


def fold_stages(nwin: int) -> int:
    """Stages of K3's plan ring on the card: 2 while two plan blocks
    (64-row two-layer routes of nwin windows, an mbarrier each) fit a
    block's shared memory (nwin <= 89), 1 while one does (nwin <= 202).
    Raises ValueError past one plan block."""
    plan_bytes = plan_rows(nwin * STRIPE) * LANES
    for stages in (2, 1):
        if _fits(stages, plan_bytes):
            return stages
    raise ValueError(
        f"route_fold: nwin {nwin} needs a {plan_bytes}-byte plan block; "
        f"with its mbarrier it exceeds the {SMEM_BLOCK} bytes of shared "
        f"memory a block may have (nwin <= 202)")


# K3 asks for at least this much shared memory, more than half an SM's
# 228 KB, so one block runs an SM and its L1 keeps ~124 KB for the window
# sectors the block's gathers touch
FOLD_SMEM_MIN = 118_784


def fold_smem(nwin: int) -> int:
    """Shared memory of K3's block on the card: ``fold_stages`` stages of
    (plan block + mbarrier), at least FOLD_SMEM_MIN bytes."""
    return max(fold_stages(nwin) * (plan_rows(nwin * STRIPE) * LANES
                                    + _MBAR_BYTES), FOLD_SMEM_MIN)


def ring_blocks_per_sm(kernel: str, dtype, nwin: int = 0) -> int:
    """Blocks of K1 (``kernel`` 'route_xr_exp'), K3's pass (a)
    ('route_fold') or K11 ('route_expand', whose footprint has no nwin)
    that one SM of the current card holds at once for ``dtype`` values and
    ``nwin`` windows, as the launch sizes its grid."""
    which = {"route_xr_exp": 1, "route_fold": 3, "route_expand": 11}[kernel]
    stages = fold_stages(nwin) if which == 3 else XE_STAGES
    out = ctypes.c_int(0)
    rc = _cuda.library().gt_ring_blocks_per_sm(
        which, _DTYPES[dtype], nwin, stages, ctypes.addressof(out))
    _cuda.check(rc, "ring_blocks_per_sm")
    return out.value


# --------------------------------------------------------- plain versions
def _route(src, idx1, sel_a, sel_b, idx3, nsrc: int, fill):
    """The 3-stage route of a batch of panels. src: (P, nsrc*8, 128)
    source bands; idx1: (P, nsrc*8, 128); sel_a/sel_b/idx3: (P, out, 128)
    uint8; sel_b None = one landing layer (the pick bit is ignored)."""
    u = torch.gather(src, 2, idx1.long())           # stage 1: lane crossbar
    fill_t = torch.tensor(fill, dtype=src.dtype, device=src.device)

    def landing(sel):                               # stage 2: row + band
        s = sel.long()
        band = s >> 3
        q = (band * STRIPE + (s & 7)).clamp(max=nsrc * STRIPE - 1)
        return torch.where(band < nsrc, torch.gather(u, 1, q), fill_t)

    m = (idx3 & 127).long()                         # stage 3: lane crossbar
    out = torch.gather(landing(sel_a), 2, m)
    if sel_b is not None:
        out = torch.where(idx3 >= 128, torch.gather(landing(sel_b), 2, m),
                          out)
    return out


def _blocks(a, npanels: int, rows: int, plan_idx):
    """(npanels, rows, 128): the first npanels row blocks of ``a``, or,
    gated, its blocks ``plan_idx[:npanels]``."""
    if plan_idx is None:
        return a[:npanels * rows].view(npanels, rows, LANES)
    nblk = a.shape[0] // rows
    return a[:nblk * rows].view(nblk, rows, LANES)[
        plan_idx[:npanels].long()]


def _split(plan, npanels: int, sizes, plan_idx=None):
    """Per-panel row blocks of a packed plan stream."""
    pk = _blocks(plan, npanels, sum(sizes), plan_idx)
    return torch.split(pk, list(sizes), dim=1)


def _windows(src2d, bases, npanels: int, nwin: int):
    """Each panel's nwin 8-row windows of src2d at block indices bases."""
    blocks = src2d.view(-1, STRIPE, LANES)
    return blocks[bases[:npanels * nwin].long()].view(
        npanels, nwin * STRIPE, LANES)


def _mul(acc, weights, npanels: int, mul_kind: str, fill, plan_idx=None):
    if weights is None or mul_kind == "none":
        return acc
    w = _blocks(weights, npanels, PROWS, plan_idx)
    if mul_kind == "mul":
        return acc * w
    fill_t = torch.tensor(fill, dtype=acc.dtype, device=acc.device)
    return torch.where(acc >= fill_t, fill_t, acc + w)       # add_sat


def route_xr_exp_plain(x2d, bases, plan, weights, fill, npanels: int,
                       nwin: int, mul_kind: str = "none", plan_idx=None):
    sr = nwin * STRIPE
    (xi1, xsa, xi3, ei1, esa, esb, ei3) = _split(
        plan, npanels, (sr, XROWS, XROWS, XROWS, PROWS, PROWS, PROWS),
        plan_idx)
    x_ext = _route(_windows(x2d, bases, npanels, nwin), xi1, xsa, None, xi3,
                   nwin, fill)
    acc = _route(x_ext, ei1, esa, esb, ei3, XROWS // STRIPE, fill)
    return _mul(acc, weights, npanels, mul_kind, fill,
                plan_idx).reshape(-1, LANES)


def route_passa_plain(stream0, bases, plan, fill, npanels: int, nwin: int,
                      plan_idx=None, out_rows: int = PROWS,
                      two_layer: bool = True):
    sr = nwin * STRIPE
    sizes = (sr, out_rows, out_rows, out_rows) if two_layer \
        else (sr, out_rows, out_rows)
    parts = _split(plan, npanels, sizes, plan_idx)
    i1, sa, i3 = parts[0], parts[1], parts[-1]
    sb = parts[2] if two_layer else None
    return _route(_windows(stream0, bases, npanels, nwin), i1, sa, sb, i3,
                  nwin, fill).reshape(-1, LANES)


def route_expand_plain(x_ext, plan, weights, fill, npanels: int,
                       mul_kind: str = "none"):
    i1, sa, sb, i3 = _split(plan, npanels, (XROWS, PROWS, PROWS, PROWS))
    acc = _route(_blocks(x_ext, npanels, XROWS, None), i1, sa, sb, i3,
                 XROWS // STRIPE, fill)
    return _mul(acc, weights, npanels, mul_kind, fill).reshape(-1, LANES)


def _reduce8(t, reduce_kind: str):
    """(n*8, 128) -> (n, 128): the ⊕ of each 8 consecutive rows, in t's
    dtype (an int32 sum wraps as the kernels' does, not promoted)."""
    v = t.view(-1, STRIPE, LANES)
    if reduce_kind == "sum":
        return v.sum(dim=1, dtype=t.dtype)
    return v.amin(dim=1) if reduce_kind == "min" else v.amax(dim=1)


def fold_stripes_plain(s1, reduce_kind: str, npanels: int):
    return _reduce8(s1[:npanels * PROWS], reduce_kind)


def colsum_chunks_plain(ystack, chunk_dst, nblocks: int, reduce_kind: str,
                        identity):
    """K13's fold in its order: each chunk's 8 rows ⊕-ed in row order into
    a part, then row d = identity ⊕ part(i0) ⊕ part(i1) ⊕ ... over the
    chunks i with chunk_dst[i] == d, ascending (the Pallas grid's)."""
    v = ystack.view(-1, STRIPE, LANES)
    op = {"sum": torch.add, "min": torch.minimum,
          "max": torch.maximum}[reduce_kind]
    parts = v[:, 0]
    for k in range(1, STRIPE):
        parts = op(parts, v[:, k])
    return ordered_fold(parts, chunk_dst[:parts.shape[0]], nblocks,
                        reduce_kind, identity)


def _fold_rows(dst, seg, nrows: int):
    seg_rows = min(nrows, FOLD_SEG_ROWS)
    return seg.long().repeat_interleave(STRIPE) * seg_rows + dst.long()


def fold_rows(dst, seg, nrows: int, npanels: int):
    """(npanels*8,) int64: the y row ``seg*seg_rows + dst`` each routed
    8-row band of K3 folds into."""
    return _fold_rows(dst[:npanels * STRIPE], seg[:npanels], nrows)


def route_fold_plain(stream0, bases, plan, dst, seg, nrows: int,
                     reduce_kind: str, fill, npanels: int, nwin: int,
                     plan_idx=None):
    """K3 = the route of K2; each routed 8-row band folded lane-wise,
    rows 0..7 in order; then each y row ``seg*seg_rows + dst`` folds its
    bands in ascending band order from the fill — the kernel's fixed
    order (``fold_order.py``), so equal to it bit for bit."""
    routed = route_passa_plain(stream0, bases, plan, fill, npanels, nwin,
                               plan_idx).view(-1, STRIPE, LANES)
    op = {"sum": torch.add, "min": torch.minimum,
          "max": torch.maximum}[reduce_kind]
    bands = routed[:, 0]
    for r in range(1, STRIPE):
        bands = op(bands, routed[:, r])
    return list_fold(bands, fold_rows(dst, seg, nrows, npanels), nrows,
                     reduce_kind, fill)


def hub_fold_plain(y_mid, hub_mask, reduce_kind: str):
    op = {"sum": torch.add, "min": torch.minimum,
          "max": torch.maximum}[reduce_kind]
    lane = torch.arange(LANES, device=y_mid.device)
    out = acc = y_mid
    for width, shifts in ((32, (1, 2, 4, 8, 16)), (64, (32,)), (128, (64,))):
        for sh in shifts:
            acc = op(acc, acc[:, lane ^ sh])
        out = torch.where(hub_mask == width, acc, out)
    return out


# ------------------------------------------------------------- validation
def _check_2d(name, t, dtype=None, min_rows=0):
    if t.dim() != 2 or t.shape[1] != LANES:
        raise ValueError(f"{name}: expected (rows, {LANES}), got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
    if dtype is not None and t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if t.shape[0] < min_rows:
        raise ValueError(f"{name}: {t.shape[0]} rows < {min_rows}")


def _check_idx(name, t, n, device):
    if t.dim() != 1 or t.dtype != torch.int32 or not t.is_contiguous():
        raise TypeError(f"{name}: expected a contiguous 1-D int32 tensor")
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, expected {device}")
    if t.shape[0] < n:
        raise ValueError(f"{name}: {t.shape[0]} entries < {n}")


def _check_values(name, t, device):
    if t.dtype not in _DTYPES:
        raise TypeError(f"{name}: dtype {t.dtype} not in f32/f64/i32")
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, expected {device}")


def _check_aligned(**tensors) -> None:
    """The card's kernels copy or access these in 16-byte words."""
    for name, t in tensors.items():
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"{name}: not 16-byte aligned")


def _on_cuda(t: torch.Tensor) -> bool:
    """True for a CUDA tensor, False for a CPU one; anything else raises."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {t.device}")


def _stream(t: torch.Tensor):
    return torch.cuda.current_stream(t.device).cuda_stream


def _gate_args(name, plan_idx, fill_block, plan, prows: int, npanels: int,
               device):
    """Check a gated launch's plan_idx and fill_block; returns the
    launcher's (plan_idx pointer, fill block, LAUNCHES key). The plan_idx
    values are not read back (they come from arange/where over the
    route's own blocks)."""
    if plan_idx is None:
        return None, -1, name
    _check_idx("plan_idx", plan_idx, npanels, device)
    if fill_block is None or not 0 <= fill_block < plan.shape[0] // prows:
        raise ValueError(f"{name}: fill_block {fill_block} outside the "
                         f"{plan.shape[0] // prows}-block plan")
    return plan_idx.data_ptr(), int(fill_block), f"{name}_gated"


# --------------------------------------------------------------- wrappers
def route_xr_exp(x2d, bases, plan, weights, fill, npanels: int, nwin: int,
                 mul_kind: str = "none", plan_idx=None, fill_block=None):
    """K1: x table -> (npanels*64, 128) contribution panels: the fused
    single-layer x -> x_ext route of each panel's ``nwin`` x windows (at
    block indices ``bases``), the two-layer expand route, then ⊗ with the
    weight stream. Replaces ``panel_kernels.py::route_xr_exp``, static
    and gated (``plan_idx``).

    On the card, persistent blocks stage each panel's plan block in
    shared memory with TMA bulk copies, two panels in flight a block,
    build the panel's x_ext in shared memory beside them and expand it,
    four slots a thread (``csrc/panel_route.cu``). An nwin whose two plan
    blocks and x_ext panel exceed a block's shared memory (past nwin 69
    for 4-byte values, 61 for 8-byte) raises on any device
    (``xr_exp_smem``)."""
    _check_sources("x2d", x2d, bases, plan, npanels, nwin)
    _check_2d("plan", plan, torch.uint8, npanels * xe_plan_rows(nwin))
    if mul_kind not in _MUL_KINDS:
        raise ValueError(f"mul_kind {mul_kind!r}")
    if weights is not None:
        _check_2d("weights", weights, x2d.dtype, npanels * PROWS)
        _check_values("weights", weights, x2d.device)
    xr_exp_smem(nwin, x2d.element_size())
    pidx, fblk, key = _gate_args("route_xr_exp", plan_idx, fill_block, plan,
                                 xe_plan_rows(nwin), npanels, x2d.device)
    if not _on_cuda(x2d):
        return route_xr_exp_plain(x2d, bases, plan, weights, fill, npanels,
                                  nwin, mul_kind, plan_idx)
    _check_aligned(plan=plan, weights=weights)
    lib = _cuda.library()
    out = torch.empty((npanels * PROWS, LANES), dtype=x2d.dtype,
                      device=x2d.device)
    if npanels == 0:
        return out
    with torch.cuda.device(x2d.device):
        rc = lib.gt_route_xr_exp(
            x2d.data_ptr(), bases.data_ptr(), plan.data_ptr(),
            None if weights is None else weights.data_ptr(), out.data_ptr(),
            npanels, nwin, _DTYPES[x2d.dtype],
            _MUL_KINDS[mul_kind] if weights is not None else 0, float(fill),
            pidx, fblk, _stream(x2d))
    LAUNCHES[key] += 1
    _cuda.check(rc, key)
    return out


def route_passa(stream0, bases, plan, fill, npanels: int, nwin: int,
                plan_idx=None, fill_block=None, out_rows: int = PROWS,
                two_layer: bool = True):
    """K2: the corner turn — each panel's ``nwin`` 8-row windows of
    ``stream0`` (at block indices ``bases``) routed into an
    ``out_rows``-row panel: two-layer into 64 rows (the default), or
    single-layer into 32 (``out_rows=XROWS, two_layer=False``: the
    x -> x_ext route, whose plan has no sel_b). Replaces
    ``panel_kernels.py::route_passa``, static and gated (``plan_idx``).
    Static single-layer launches count under ``route_passa_single``.

    On the card, persistent blocks stage each panel's plan block (and,
    in the 'staged' form of ``passa_form``, its source windows) in shared
    memory with TMA bulk copies, two panels in flight a block, and
    resolve four slots a thread (``csrc/panel_route.cu``). An nwin whose
    two plan blocks exceed a block's shared memory raises on any device
    (``passa_form``)."""
    if out_rows not in (PROWS, XROWS):
        raise ValueError(f"route_passa: out_rows {out_rows}, expected "
                         f"{PROWS} or {XROWS}")
    prows = plan_rows(nwin * STRIPE, out_rows, two_layer)
    _check_sources("stream0", stream0, bases, plan, npanels, nwin)
    _check_2d("plan", plan, torch.uint8, npanels * prows)
    form = passa_form(nwin, out_rows, two_layer, stream0.element_size())
    single = not two_layer and plan_idx is None
    pidx, fblk, key = _gate_args(
        "route_passa_single" if single else "route_passa", plan_idx,
        fill_block, plan, prows, npanels, stream0.device)
    if not _on_cuda(stream0):
        return route_passa_plain(stream0, bases, plan, fill, npanels, nwin,
                                 plan_idx, out_rows, two_layer)
    _check_aligned(stream0=stream0, plan=plan)
    lib = _cuda.library()
    out = torch.empty((npanels * out_rows, LANES), dtype=stream0.dtype,
                      device=stream0.device)
    if npanels == 0:
        return out
    with torch.cuda.device(stream0.device):
        rc = lib.gt_route_passa(
            stream0.data_ptr(), bases.data_ptr(), plan.data_ptr(),
            out.data_ptr(), npanels, nwin, out_rows, int(two_layer),
            _DTYPES[stream0.dtype], float(fill), pidx, fblk,
            stream0.shape[0] // STRIPE, int(form == "staged"),
            _stream(stream0))
    LAUNCHES[key] += 1
    _cuda.check(rc, key)
    return out


def route_expand(x_ext, plan, weights, fill, npanels: int,
                 mul_kind: str = "none"):
    """K11: x_ext panels (npanels*32, 128) -> (npanels*64, 128)
    contribution panels: panel i's own 32-row x_ext block (4 source
    bands) routed two-layer, then ⊗ with the weight stream — K1's second
    stage alone. ``plan``: per panel [idx1 (32), sel_a, sel_b, idx3 (64
    each)]. Replaces ``panel_kernels.py::route_expand``.

    On the card, K11 runs on K1's plan ring: persistent blocks stage each
    panel's plan block and its x_ext block in shared memory with TMA bulk
    copies, two panels in flight a block (``expand_smem``), and resolve
    four slots a thread with K1's own expand stage
    (``csrc/panel_route.cu``)."""
    _check_2d("x_ext", x_ext, None, npanels * XROWS)
    _check_values("x_ext", x_ext, x_ext.device)
    _check_2d("plan", plan, torch.uint8, npanels * plan_rows(XROWS))
    if plan.device != x_ext.device:
        raise ValueError(f"plan on {plan.device}, expected {x_ext.device}")
    if mul_kind not in _MUL_KINDS:
        raise ValueError(f"mul_kind {mul_kind!r}")
    if weights is not None:
        _check_2d("weights", weights, x_ext.dtype, npanels * PROWS)
        _check_values("weights", weights, x_ext.device)
    if not _on_cuda(x_ext):
        return route_expand_plain(x_ext, plan, weights, fill, npanels,
                                  mul_kind)
    _check_aligned(x_ext=x_ext, plan=plan, weights=weights)
    lib = _cuda.library()
    out = torch.empty((npanels * PROWS, LANES), dtype=x_ext.dtype,
                      device=x_ext.device)
    if npanels == 0:
        return out
    with torch.cuda.device(x_ext.device):
        rc = lib.gt_route_expand(
            x_ext.data_ptr(), plan.data_ptr(),
            None if weights is None else weights.data_ptr(), out.data_ptr(),
            npanels, _DTYPES[x_ext.dtype],
            _MUL_KINDS[mul_kind] if weights is not None else 0, float(fill),
            _stream(x_ext))
    LAUNCHES["route_expand"] += 1
    _cuda.check(rc, "route_expand")
    return out


def fold_stripes(s1, reduce_kind: str, npanels: int):
    """K12 (pass B): (npanels*64, 128) -> (npanels*8, 128); row d of
    panel i is the ⊕ of its rows d*8 .. d*8+7, folded in that order.
    Replaces ``panel_kernels.py::fold_stripes``."""
    _check_2d("s1", s1, None, npanels * PROWS)
    _check_values("s1", s1, s1.device)
    if reduce_kind not in _REDUCE_KINDS:
        raise ValueError(f"fold_stripes: reduce_kind {reduce_kind!r}")
    if not _on_cuda(s1):
        return fold_stripes_plain(s1, reduce_kind, npanels)
    lib = _cuda.library()
    out = torch.empty((npanels * STRIPE, LANES), dtype=s1.dtype,
                      device=s1.device)
    if npanels == 0:
        return out
    with torch.cuda.device(s1.device):
        rc = lib.gt_fold_stripes(s1.data_ptr(), out.data_ptr(),
                                 npanels * STRIPE, _DTYPES[s1.dtype],
                                 _REDUCE_KINDS[reduce_kind], _stream(s1))
    LAUNCHES["fold_stripes"] += 1
    _cuda.check(rc, "fold_stripes")
    return out


def colsum_lists(chunk_dst, nblocks: int):
    """K13's row -> chunks lists, built once per upload (``panel_engine.
    staged_tables`` keeps them): (ptr (nblocks + 1,), idx (nchunks,)) of
    ``fold_order.row_lists``, ``longs``, the rows of more than
    COLSUM_LONG chunks, and ``pos``, their list positions; int32, on
    chunk_dst's device."""
    ptr, idx = row_lists(chunk_dst, nblocks)
    n = (ptr[1:] - ptr[:-1]).long()
    longs = torch.nonzero(n > COLSUM_LONG).squeeze(1)
    nl = n[longs]
    # each long row's positions ptr[r] .. ptr[r+1]-1, rows in order
    shift = ptr[:-1][longs].long() - (torch.cumsum(nl, 0) - nl)
    pos = (torch.repeat_interleave(shift, nl)
           + torch.arange(int(nl.sum()), device=nl.device))
    return ptr, idx, longs.to(torch.int32), pos.to(torch.int32)


def colsum_chunks(ystack, chunk_dst, nblocks: int, reduce_kind: str,
                  identity, lists=None):
    """K13: an (nblocks, 128) table; row d = identity ⊕ the column-⊕ of
    each chunk i (rows i*8 .. i*8+7 of ``ystack``, in row order) with
    ``chunk_dst[i] == d``, in ascending i: the Pallas grid's order, so
    float sums equal the plain version's bit for bit on every call.
    Replaces ``panel_kernels.py::colsum_chunks``. ``lists``: its
    ``colsum_lists(chunk_dst, nblocks)``, built here if None
    (``panel_engine.staged_tables`` keeps them); the plain version reads
    none. On the card a row of at most COLSUM_LONG chunks is one thread a
    lane; a longer one (a hub row) has its chunks' parts folded across
    the card first, then its chain run by blocks that stage the parts in
    shared memory. The chunk_dst values are not read back: callers build
    them from a validated meta (``panel_engine.staged_tables``)."""
    _check_2d("ystack", ystack)
    if ystack.shape[0] % STRIPE:
        raise ValueError("ystack rows must be a multiple of 8")
    _check_values("ystack", ystack, ystack.device)
    nchunks = ystack.shape[0] // STRIPE
    _check_idx("chunk_dst", chunk_dst, nchunks, ystack.device)
    if reduce_kind not in _REDUCE_OK[ystack.dtype]:
        raise ValueError(f"colsum_chunks: {reduce_kind} on {ystack.dtype}")
    if not _on_cuda(ystack):
        return colsum_chunks_plain(ystack, chunk_dst, nblocks, reduce_kind,
                                   identity)
    if lists is None:
        lists = colsum_lists(chunk_dst[:nchunks], nblocks)
    ptr, idx, longs, pos = lists
    for name, t, n in (("ptr", ptr, nblocks + 1), ("idx", idx, nchunks),
                       ("longs", longs, longs.shape[0]),
                       ("pos", pos, pos.shape[0])):
        if (t.dtype != torch.int32 or tuple(t.shape) != (n,)
                or not t.is_contiguous() or t.device != ystack.device):
            raise ValueError(f"colsum_chunks {name}: expected a contiguous "
                             f"({n},) int32 tensor on {ystack.device}")
    lib = _cuda.library()
    part = torch.empty((pos.shape[0], LANES), dtype=ystack.dtype,
                       device=ystack.device)
    y = torch.empty((nblocks, LANES), dtype=ystack.dtype,
                    device=ystack.device)
    with torch.cuda.device(ystack.device):
        rc = lib.gt_colsum_chunks(
            ystack.data_ptr(), ptr.data_ptr(), idx.data_ptr(),
            longs.data_ptr(), pos.data_ptr(), part.data_ptr(), y.data_ptr(),
            nblocks, longs.shape[0], pos.shape[0], COLSUM_LONG,
            _DTYPES[ystack.dtype], _REDUCE_KINDS[reduce_kind],
            float(identity), _stream(ystack))
    LAUNCHES["colsum_chunks"] += 1
    _cuda.check(rc, "colsum_chunks")
    return y


def route_fold(stream0, bases, plan, dst, seg, nrows: int, reduce_kind: str,
               fill, npanels: int, nwin: int, plan_idx=None,
               fill_block=None, lists=None, scratch=None):
    """K3: route as K2, then ⊕-fold each routed 8-row band into row
    ``seg[p]*min(nrows, 8192) + dst[p*8+ob]`` of an (nrows, 128) table
    that starts at the ⊕-identity. Replaces ``panel_kernels.py::
    route_fold``, static and gated (``plan_idx``; dst and seg stay panel
    p's); its per-segment ``ini`` reset is implied, because every row
    starts at the identity. Float sums fold in a fixed order, the plain
    version's: each band's 8 rows in order, then each y row's bands in
    ascending panel order (the Pallas grid's), in runs of
    ``fold_order.GROUP``. ``lists``: the row -> bands lists
    (``fold_order.fold_lists(fold_rows(dst, seg, nrows, npanels),
    nrows)``, built here if None); ``scratch``: the band and run partials
    (allocated here if None); the plain version reads neither.

    On the card, pass (a) runs persistent blocks, one an SM, that stage
    each panel's plan block in shared memory with TMA bulk copies, in a
    ring of ``fold_stages(nwin)`` stages (two to nwin 89, one to nwin
    202), and fold one (band, lane) a thread in registers; an nwin whose
    plan block exceeds a block's shared memory raises on any device."""
    _check_route_args(stream0, bases, plan, npanels, nwin)
    _check_idx("dst", dst, npanels * STRIPE, stream0.device)
    _check_idx("seg", seg, npanels, stream0.device)
    if reduce_kind not in _REDUCE_OK[stream0.dtype]:
        raise ValueError(f"route_fold: {reduce_kind} on {stream0.dtype}")
    seg_rows = min(nrows, FOLD_SEG_ROWS)
    if nrows % seg_rows:
        raise ValueError(f"nrows {nrows} is not whole {seg_rows}-row "
                         f"segments")
    stages = fold_stages(nwin)
    pidx, fblk, key = _gate_args("route_fold", plan_idx, fill_block, plan,
                                 plan_rows(nwin * STRIPE), npanels,
                                 stream0.device)
    if not _on_cuda(stream0):
        return route_fold_plain(stream0, bases, plan, dst, seg, nrows,
                                reduce_kind, fill, npanels, nwin, plan_idx)
    if lists is None:
        lists = fold_lists(fold_rows(dst, seg, nrows, npanels), nrows)
    rptr, gptr, idx, part, gpart = fold_args(
        lists, scratch, nrows, npanels * STRIPE, stream0.dtype,
        stream0.device)
    _check_aligned(plan=plan)
    lib = _cuda.library()
    y = torch.empty((nrows, LANES), dtype=stream0.dtype,
                    device=stream0.device)
    with torch.cuda.device(stream0.device):
        rc = lib.gt_route_fold(
            stream0.data_ptr(), bases.data_ptr(), plan.data_ptr(),
            rptr.data_ptr(), gptr.data_ptr(), idx.data_ptr(),
            part.data_ptr(), gpart.data_ptr(), y.data_ptr(), nrows,
            gptr.shape[0] - 1, npanels, nwin, stages,
            _DTYPES[stream0.dtype], _REDUCE_KINDS[reduce_kind], float(fill),
            pidx, fblk, _stream(stream0))
    LAUNCHES[key] += 1
    _cuda.check(rc, key)
    return y


def hub_fold(y_mid, hub_mask, reduce_kind: str):
    """K4: for each row whose hub code is 32, 64 or 128, every lane becomes
    the ⊕ of its aligned group of that many lanes, by the xor butterfly
    1, 2, 4, 8, 16 | 32 | 64; code-0 rows pass through. Replaces
    ``panel_kernels.py::hub_fold``."""
    _check_2d("y_mid", y_mid)
    _check_values("y_mid", y_mid, y_mid.device)
    _check_2d("hub_mask", hub_mask, torch.uint8)
    if hub_mask.shape != y_mid.shape or hub_mask.device != y_mid.device:
        raise ValueError("hub_mask must match y_mid's shape and device")
    if reduce_kind not in _REDUCE_OK[y_mid.dtype]:
        raise ValueError(f"hub_fold: {reduce_kind} on {y_mid.dtype}")
    if not _on_cuda(y_mid):
        return hub_fold_plain(y_mid, hub_mask, reduce_kind)
    lib = _cuda.library()
    out = torch.empty_like(y_mid)
    if y_mid.shape[0] == 0:
        return out
    with torch.cuda.device(y_mid.device):
        rc = lib.gt_hub_fold(y_mid.data_ptr(), hub_mask.data_ptr(),
                             out.data_ptr(), y_mid.shape[0],
                             _DTYPES[y_mid.dtype], _REDUCE_KINDS[reduce_kind],
                             _stream(y_mid))
    LAUNCHES["hub_fold"] += 1
    _cuda.check(rc, "hub_fold")
    return out


def _check_sources(name, src, bases, plan, npanels, nwin):
    """Checks shared by the routes: the windowed source, its block
    indices and the plan stream (whose row count each caller checks)."""
    _check_2d(name, src)
    if src.shape[0] % STRIPE:
        raise ValueError(f"{name} rows must be a multiple of 8")
    _check_values(name, src, src.device)
    _check_idx("bases", bases, npanels * nwin, src.device)
    _check_2d("plan", plan, torch.uint8)
    if plan.device != src.device:
        raise ValueError(f"plan on {plan.device}, expected {src.device}")


def _check_route_args(stream0, bases, plan, npanels, nwin):
    _check_sources("stream0", stream0, bases, plan, npanels, nwin)
    _check_2d("plan", plan, torch.uint8,
              npanels * plan_rows(nwin * STRIPE))
