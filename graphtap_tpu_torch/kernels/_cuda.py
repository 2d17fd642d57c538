"""Build and load the port's CUDA kernels (nvcc -> shared library -> ctypes).

The kernels in ``csrc/*.cu`` expose plain ``extern "C"`` launchers, so
they compile in seconds without PyTorch's headers. The library is built
at first use into ``graphtap_tpu_torch/build/`` under a name keyed on the
source and header bytes, so an edited source is never served by a stale
build: one nvcc per source, all started together, then one link.
Nothing here runs at import time: the CPU tests import every module on a
machine with neither nvcc nor a card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD = PKG / "build"
SOURCES = ("panel_route.cu", "shuffle.cu", "gather.cu", "onehot.cu",
           "probe.cu")
HEADERS = ("common.cuh",)
ARCH = "-gencode=arch=compute_90a,code=sm_90a"

_lib: Optional[ctypes.CDLL] = None
build_log = ""          # nvcc's output (ptxas register/smem report)

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_I32 = ctypes.c_int
_F64 = ctypes.c_double
# launcher name -> argtypes; every launcher returns cudaError_t as int.
# plan_idx is NULL for a static launch, else the (npanels,) int32 plan
# block of each panel (gated); fill_block is the route's all-fill block.
# rptr/gptr/idx are a fixed-order fold's row -> runs -> partials lists,
# part/gpart its scratch; chunks a chunk fold's list (kernels/
# fold_order.py).
_SIGNATURES = {
    # x2d, bases, plan, w, out, npanels, nwin, dtype, mul_kind, fill,
    # plan_idx, fill_block, stream
    "gt_route_xr_exp": [_P, _P, _P, _P, _P, _I64, _I32, _I32, _I32, _F64,
                        _P, _I32, _P],
    # src, bases, plan, out, npanels, nwin, out_rows, two_layer, dtype,
    # fill, plan_idx, fill_block, src_windows, staged, stream
    "gt_route_passa": [_P, _P, _P, _P, _I64, _I32, _I32, _I32, _I32, _F64,
                       _P, _I32, _I64, _I32, _P],
    # x_ext, plan, w, out, npanels, dtype, mul_kind, fill, stream
    "gt_route_expand": [_P, _P, _P, _P, _I64, _I32, _I32, _F64, _P],
    # s1, out, nrows_out, dtype, reduce_kind, stream
    "gt_fold_stripes": [_P, _P, _I64, _I32, _I32, _P],
    # ystack, ptr, idx, longs, pos, part, y, nblocks, nlong, npos, longest,
    # dtype, reduce_kind, identity, stream
    "gt_colsum_chunks": [_P, _P, _P, _P, _P, _P, _P, _I64, _I32, _I64, _I32,
                         _I32, _I32, _F64, _P],
    # src, bases, plan, rptr, gptr, idx, part, gpart, y, nrows, ngroups,
    # npanels, nwin, stages, dtype, reduce_kind, fill, plan_idx, fill_block,
    # stream
    "gt_route_fold": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I64, _I64, _I64,
                      _I32, _I32, _I32, _I32, _F64, _P, _I32, _P],
    # kernel (1: K1, 3: K3, 11: K11), dtype, nwin, stages, out (int*)
    "gt_ring_blocks_per_sm": [_I32, _I32, _I32, _I32, _P],
    # v, hub_mask, out, nrows, dtype, reduce_kind, stream
    "gt_hub_fold": [_P, _P, _P, _I64, _I32, _I32, _P],
    # x3d, grp, slot, lane, ev, w, out, rows, dtype, mul_kind, fill, stream
    "gt_expand_stream": [_P, _P, _P, _P, _P, _P, _P, _I64, _I32, _I32, _F64,
                         _P],
    # in, src, out, n, dtype, fill, stream
    "gt_group_gather": [_P, _P, _P, _I64, _I32, _F64, _P],
    # c, lr, ev, chunks, rptr, gptr, part, gpart, y, nitems, nblocks,
    # ngroups, dtype, reduce_kind, identity, stream
    "gt_grouped_reduce": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I64, _I64,
                          _I64, _I32, _I32, _F64, _P],
    # src, wsel, base, nact, cidx, meta, w, out, nsteps, nsub, dtype,
    # mul_kind, fill, stream
    "gt_windowed_gather": [_P, _P, _P, _P, _P, _P, _P, _P, _I64, _I32, _I32,
                           _I32, _F64, _P],
    # src, wsel, base, nact, cidx, meta, out, nsteps, nsub, src_windows,
    # cidx_blocks, dtype, fill, stream
    "gt_windowed_gather64": [_P, _P, _P, _P, _P, _P, _P, _I64, _I32, _I64,
                             _I64, _I32, _F64, _P],
    # contrib, lrows, chunks, rptr, gptr, part, gpart, y, nitems, nblocks,
    # ngroups, dtype, reduce_kind, identity, stream
    "gt_segment_reduce": [_P, _P, _P, _P, _P, _P, _P, _P, _I64, _I64, _I64,
                          _I32, _I32, _F64, _P],
    # x, ecol, edest, ew, eptr, lcount, chunks, rptr, gptr, part, gpart,
    # y, nitems, nblocks, ngroups, dtype, mul_kind, reduce_kind, identity,
    # stream
    "gt_segment_reduce_gather": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                 _P, _I64, _I64, _I64, _I32, _I32, _I32,
                                 _F64, _P],
    # x, y, rows, row_bytes, bm, bn_bytes, chunk_rows, pieces, piece_bytes,
    # stream
    "gt_probe_copy": [_P, _P, _I64, _I64, _I32, _I64, _I32, _I32, _I64, _P],
    # chunk_bytes, out (int*)
    "gt_probe_copy_blocks_per_sm": [_I64, _P],
    # a, b, c, d, out, nstreams, rows, lanes, bm, stream
    "gt_probe_stream_sum": [_P, _P, _P, _P, _P, _I32, _I64, _I32, _I32, _P],
    # x2d, bases, out, npanels, nwin, stream
    "gt_probe_route_like": [_P, _P, _P, _I64, _I32, _P],
}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def library_path() -> Path:
    h = hashlib.sha256()
    for s in SOURCES + HEADERS:
        h.update((CSRC / s).read_bytes())
    h.update(ARCH.encode())
    return BUILD / f"libgt_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels (if this source version is not built yet)."""
    global build_log
    out = library_path()
    if out.exists():
        return out
    BUILD.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{out.stem}.{os.getpid()}"
    objs = [BUILD / f"{tag}.{Path(s).stem}.o" for s in SOURCES]
    procs = [subprocess.Popen(
        [nvcc, ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas",
         "-v", "-c", "-o", str(o), str(CSRC / s)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for s, o in zip(SOURCES, objs)]
    logs, failed = [], []
    for s, p in zip(SOURCES, procs):
        logs.append(p.communicate(timeout=600)[0])
        if p.returncode != 0:
            failed.append(s)
    tmp = BUILD / f"{tag}.so.tmp"
    if not failed:
        res = subprocess.run([nvcc, ARCH, "-shared", "-o", str(tmp),
                              *map(str, objs)], capture_output=True,
                             text=True, timeout=300)
        logs.append(res.stdout + res.stderr)
        if res.returncode != 0:
            failed.append("link")
    for o in objs:
        o.unlink(missing_ok=True)
    build_log = "".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed ({', '.join(failed)}):\n"
                           f"{build_log}")
    os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.gt_error_string.argtypes = [ctypes.c_int]
        lib.gt_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(rc: int, name: str) -> None:
    """Raise if a launcher reported a CUDA error (cudaGetLastError)."""
    if rc != 0:
        msg = library().gt_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")
