"""The windowed-gather kernels of the v2 SpMV pipeline: CUDA wrappers,
plain torch versions, counts.

Counterpart of ``graphtap_tpu/kernels/gather_kernels.py``. Each of its two
Pallas kernels has here

  * a wrapper (``windowed_gather`` K9, ``windowed_gather64`` K10) that
    checks dtype, shape, device and contiguity, then runs the plain
    version for a CPU tensor or launches the hand-written Hopper kernel
    (``csrc/gather.cu``) for a CUDA tensor — never a fallback;
  * a plain torch version (``*_plain``) of the same function, which the
    CPU tests hold against the Pallas kernels and the ``gpu`` tests
    (``tests/test_torch_cuda.py``) hold against the CUDA kernels;
  * a launch count in ``LAUNCHES``, incremented only where the wrapper
    launches the CUDA kernel.

What both compute. Output step i covers ``block_rows`` rows (8 for K9, 64
for K10) of 128 lanes. For output slot (i, r, l) with m = meta[i, r, l],
sid = m >> 3 and j = m & 7, the slot holds

    src[wsel[i*nsub + sid]*8 + j, cidx[base[i] + sid, j, l]]

if sid < min(nact[i], nsub), else the fill (⊕-identity). K9 then applies
the optional ⊗ to every slot (``mul``: by w; ``add_sat``: saturating at
the fill) and sets sid-31 (``SID_INVALID``) slots back to the fill, so
under ``mul`` a slot with nact[i] <= sid < 31 holds fill * w, as in the
Pallas kernel. The TPU kernel walks (step, subop) on a sequential grid with
the source window in VMEM and one ``pallas_call`` per 2048-step segment
(its SMEM budget for ``wsel``/``nact``); here one launch covers every step,
K9 as one block per step that loads the step's scalars once and resolves
four slots a thread.
K10 stages each step's source windows in shared memory, so each is
fetched once for the step's 8,192 slots, as the Pallas kernel fetches it
once into VMEM.
The plan shapes, and so the segment rounding of ``seg_round_rows``, stay
the JAX package's, so the plans are the same bytes.

Plans come from ``kernels/gather_plan.py``; ``gather_engine.
validate_spmv2_meta`` checks every index K9 follows before a plan reaches
the card.
"""

from __future__ import annotations

import torch

from graphtap_tpu_torch.kernels import _cuda
from graphtap_tpu_torch.kernels.panel_kernels import (_DTYPES, _MUL_KINDS,
                                                      _check_aligned,
                                                      _on_cuda, _stream)
from graphtap_tpu_torch.kernels.shuffle_kernels import (_check,
                                                        _check_rows,
                                                        _check_values)

LANES = 128
SUB = 8
SID_INVALID = 31
SEG_STEPS = 2048     # 8-row steps per pallas_call in the JAX package
BLK64 = 64
SEG_STEPS64 = 1024   # 64-row steps per pallas_call in the JAX package

# launches of each CUDA kernel (the plain versions are not counted)
LAUNCHES = {"windowed_gather": 0, "windowed_gather64": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def seg_round_rows(rows: int) -> int:
    """A windowed_gather stage's out_rows rounded as the JAX package's
    segmented driver needs it (a multiple of 8*SEG_STEPS rows above one
    segment); the planner pads every stage with it."""
    steps = rows // SUB
    if steps > SEG_STEPS:
        steps = -(-steps // SEG_STEPS) * SEG_STEPS
    return steps * SUB


def seg_round_rows64(rows: int) -> int:
    """A windowed_gather64 out_rows rounded to a multiple of 64 (of
    64*SEG_STEPS64 when larger), as the JAX package rounds it."""
    steps = -(-rows // BLK64)
    if steps > SEG_STEPS64:
        steps = -(-steps // SEG_STEPS64) * SEG_STEPS64
    return steps * BLK64


# --------------------------------------------------------- plain versions
def gather_index(wsel, base, nact, cidx, meta, nsub: int) -> torch.Tensor:
    """The linear source slot (row*128 + lane) each output slot reads, as
    an (nsteps*block_rows, 128) int64 tensor; -1 where the slot keeps the
    fill."""
    nsteps, br = meta.shape[:2]
    dev = meta.device
    m = meta.long()
    sid, j = m >> 3, m & 7
    live = sid < nact.long().clamp(max=nsub)[:, None, None]
    s = torch.where(live, sid, 0)
    step = torch.arange(nsteps, device=dev)[:, None, None]
    win = wsel.long()[step * nsub + s]
    blk = torch.where(live, base.long()[:, None, None] + s, 0)
    lane = cidx[blk, j, torch.arange(LANES, device=dev)].long()
    src = (win * SUB + j) * LANES + lane
    return torch.where(live, src, -1).view(nsteps * br, LANES)


def _take(src, idx, fill):
    f = torch.tensor(fill, dtype=src.dtype, device=src.device)
    return torch.where(idx >= 0, src.reshape(-1)[idx.clamp(min=0)], f), f


def windowed_gather_plain(src, wsel, base, nact, cidx, meta, weights, fill,
                          nsub: int, mul_kind: str = "none"):
    """K9: see the module docstring."""
    out, f = _take(src, gather_index(wsel, base, nact, cidx, meta, nsub),
                   fill)
    if mul_kind == "none":
        return out
    w = weights.view(out.shape)
    if mul_kind == "mul":
        out = out * w
    else:
        out = torch.where(out >= f, f, out + w)
    invalid = (meta.view(out.shape) >> 3) == SID_INVALID
    return torch.where(invalid, f, out)


def windowed_gather64_plain(src, wsel, base, nact, cidx, meta, fill,
                            nsub: int):
    """K10: K9 over 64-row output steps, without ⊗."""
    return _take(src, gather_index(wsel, base, nact, cidx, meta, nsub),
                 fill)[0]


# --------------------------------------------------------------- wrappers
def _check_plan(src, wsel, base, nact, cidx, meta, nsub, block_rows):
    _check_values("src", src)
    dev = src.device
    _check_rows("src", src, dev)
    if src.shape[0] % SUB:
        raise ValueError(f"src: {src.shape[0]} rows, not whole {SUB}-row "
                         f"windows")
    if meta.dim() != 3 or tuple(meta.shape[1:]) != (block_rows, LANES):
        raise ValueError(f"meta: expected (nsteps, {block_rows}, {LANES}), "
                         f"got {tuple(meta.shape)}")
    nsteps = meta.shape[0]
    if not 1 <= nsub <= SID_INVALID:
        raise ValueError(f"nsub {nsub} outside [1, {SID_INVALID}]")
    _check("meta", meta, torch.uint8, device=dev)
    _check("wsel", wsel, torch.int32, (nsteps * nsub,), dev)
    _check("base", base, torch.int32, (nsteps,), dev)
    _check("nact", nact, torch.int32, (nsteps,), dev)
    if cidx.dim() != 3 or tuple(cidx.shape[1:]) != (SUB, LANES):
        raise ValueError(f"cidx: expected (blocks, {SUB}, {LANES}), got "
                         f"{tuple(cidx.shape)}")
    _check("cidx", cidx, torch.int8, device=dev)
    return nsteps


def windowed_gather(src, wsel, base, nact, cidx, meta, weights, fill,
                    nsub: int, mul_kind: str = "none"):
    """K9: (S, 128) source table -> (nsteps*8, 128), each slot gathered
    through its window as the module docstring says, then ⊗ w
    (``mul_kind``: 'none' | 'mul' | 'add_sat', weights (nsteps, 8, 128) of
    the source dtype, given iff mul_kind is not 'none'). ``meta`` is
    (nsteps, 8, 128): any other step height raises. On the card one block
    per 8-row step, four slots a thread (``csrc/gather.cu``). Replaces
    ``gather_kernels.py::windowed_gather``."""
    nsteps = _check_plan(src, wsel, base, nact, cidx, meta, nsub, SUB)
    dev = src.device
    if mul_kind not in _MUL_KINDS:
        raise ValueError(f"mul_kind {mul_kind!r}")
    if (weights is None) != (mul_kind == "none"):
        raise ValueError(f"mul_kind {mul_kind!r} with weights "
                         f"{'absent' if weights is None else 'given'}")
    if weights is not None:
        _check("weights", weights, src.dtype, (nsteps, SUB, LANES), dev)
    if not _on_cuda(src):
        return windowed_gather_plain(src, wsel, base, nact, cidx, meta,
                                     weights, fill, nsub, mul_kind)
    _check_aligned(meta=meta, weights=weights)
    lib = _cuda.library()
    out = torch.empty((nsteps * SUB, LANES), dtype=src.dtype, device=dev)
    if nsteps == 0:
        return out
    with torch.cuda.device(dev):
        rc = lib.gt_windowed_gather(
            src.data_ptr(), wsel.data_ptr(), base.data_ptr(),
            nact.data_ptr(), cidx.data_ptr(), meta.data_ptr(),
            None if weights is None else weights.data_ptr(), out.data_ptr(),
            nsteps, nsub, _DTYPES[src.dtype], _MUL_KINDS[mul_kind],
            float(fill), _stream(src))
    LAUNCHES["windowed_gather"] += 1
    _cuda.check(rc, "windowed_gather")
    return out


def windowed_gather64(src, wsel, base, nact, cidx, meta, fill, nsub: int):
    """K10: K9 with 64-row output steps and no ⊗: (S, 128) ->
    (nsteps*64, 128), meta (nsteps, 64, 128). Plans come from
    ``build_gather_plan(block_rows=64)``. On the card one block per step
    stages the step's source windows and cidx blocks in shared memory, a
    few subops ahead (``csrc/gather.cu``). Replaces ``gather_kernels.py::
    windowed_gather64``."""
    nsteps = _check_plan(src, wsel, base, nact, cidx, meta, nsub, BLK64)
    dev = src.device
    if not _on_cuda(src):
        return windowed_gather64_plain(src, wsel, base, nact, cidx, meta,
                                       fill, nsub)
    _check_aligned(src=src, cidx=cidx, meta=meta)
    lib = _cuda.library()
    out = torch.empty((nsteps * BLK64, LANES), dtype=src.dtype, device=dev)
    if nsteps == 0:
        return out
    with torch.cuda.device(dev):
        rc = lib.gt_windowed_gather64(
            src.data_ptr(), wsel.data_ptr(), base.data_ptr(),
            nact.data_ptr(), cidx.data_ptr(), meta.data_ptr(),
            out.data_ptr(), nsteps, nsub, src.shape[0] // SUB,
            cidx.shape[0], _DTYPES[src.dtype], float(fill), _stream(src))
    LAUNCHES["windowed_gather64"] += 1
    _cuda.check(rc, "windowed_gather64")
    return out
