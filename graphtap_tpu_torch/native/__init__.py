"""ctypes bindings for the native host-side ingest library.

Builds lazily with g++ on first use, from this directory's C++ sources,
into ``graphtap_tpu_torch/build/`` under a name keyed on the source bytes
and flags (so an edited source is never served by a stale build); all
entry points fall back to NumPy implementations if the toolchain is
unavailable, so the package works without the native library (but ingest
of large text files is ~10-30x slower). This file imports nothing of the
package: ``kernels/panel_plan.py``'s route workers load it by path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from typing import Optional, Tuple

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_BUILD = os.path.join(os.path.dirname(_DIR), "build")
_SOURCES = ("graphtap_host.cpp", "route_solver.cpp")
# no -march=native: a build directory copied to another host must still run
_CXXFLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-shared")
_lib = None
_tried = False


def library_path() -> str:
    h = hashlib.sha256(" ".join(_CXXFLAGS).encode())
    for s in _SOURCES:
        with open(os.path.join(_DIR, s), "rb") as f:
            h.update(f.read())
    return os.path.join(_BUILD, f"libgraphtap_host_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the library unless this source version is built; several
    processes may race here (route workers), so each builds to its own
    temporary file and renames it into place."""
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(_BUILD, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cxx = os.environ.get("CXX", "g++")
    subprocess.run([cxx, *_CXXFLAGS, "-o", tmp,
                    *(os.path.join(_DIR, s) for s in _SOURCES)],
                   check=True, capture_output=True, timeout=180)
    os.replace(tmp, out)
    return out


def _load():
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    try:
        path = build()
    except Exception:
        return None
    try:
        lib = ctypes.CDLL(path)
        lib.gt_parse_text.restype = ctypes.c_longlong
        lib.gt_parse_text.argtypes = [
            ctypes.c_char_p, ctypes.c_longlong,
            ctypes.POINTER(ctypes.c_uint), ctypes.c_longlong]
        lib.gt_sort_edges.restype = None
        lib.gt_sort_edges.argtypes = [
            ctypes.POINTER(ctypes.c_uint), ctypes.POINTER(ctypes.c_uint),
            ctypes.c_longlong, ctypes.POINTER(ctypes.c_longlong)]
        lib.gt_dedup_edges.restype = ctypes.c_longlong
        lib.gt_dedup_edges.argtypes = [
            ctypes.POINTER(ctypes.c_uint), ctypes.POINTER(ctypes.c_uint),
            ctypes.POINTER(ctypes.c_uint), ctypes.c_longlong]
        lib.gt_bin_edges.restype = None
        lib.gt_bin_edges.argtypes = [
            ctypes.POINTER(ctypes.c_uint), ctypes.POINTER(ctypes.c_uint),
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
            ctypes.c_longlong, ctypes.POINTER(ctypes.c_longlong),
            ctypes.POINTER(ctypes.c_longlong)]
        i32p = ctypes.POINTER(ctypes.c_int32)
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.gt_route_solve.restype = ctypes.c_longlong
        lib.gt_route_solve.argtypes = [
            i64p, i64p, i64p, i64p, i64p,
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
            ctypes.c_longlong, ctypes.c_longlong,
            ctypes.c_int, ctypes.c_int,
            i32p, i32p, i32p, i32p,
            ctypes.POINTER(ctypes.c_longlong)]
        _lib = lib
    except OSError:
        _lib = None
    return _lib


def available() -> bool:
    return _load() is not None


def _u32p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint))


def _i64p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong))


def parse_text(data: bytes, ncols: int) -> np.ndarray:
    """Parse whitespace-separated u32 text into an (n, ncols) array."""
    lib = _load()
    if lib is None:
        arr = np.array(data.split(), dtype=np.int64)
        return arr.reshape(-1, ncols)
    cap = max(16, len(data) // 2 + 2)
    out = np.empty(cap, dtype=np.uint32)
    n = lib.gt_parse_text(data, len(data), _u32p(out), cap)
    if n < 0:
        raise ValueError("malformed edge-list text")
    if n % ncols:
        raise ValueError(f"token count {n} not a multiple of {ncols}")
    return out[:n].astype(np.int64).reshape(-1, ncols)


def sort_edges(k1: np.ndarray, k2: np.ndarray) -> np.ndarray:
    """Stable argsort by (k1, k2)."""
    lib = _load()
    if lib is None:
        return np.lexsort((k2, k1))
    k1 = np.ascontiguousarray(k1, dtype=np.uint32)
    k2 = np.ascontiguousarray(k2, dtype=np.uint32)
    perm = np.empty(k1.size, dtype=np.int64)
    lib.gt_sort_edges(_u32p(k1), _u32p(k2), k1.size, _i64p(perm))
    return perm


def dedup_edges(r: np.ndarray, c: np.ndarray,
                w: Optional[np.ndarray]) -> Tuple[np.ndarray, np.ndarray,
                                                  Optional[np.ndarray]]:
    """Dedup a (r,c)-sorted edge list keeping min weight."""
    lib = _load()
    if lib is None:
        key = r.astype(np.int64) * (int(c.max(initial=0)) + 1) + c
        if w is None:
            keep = np.concatenate([[True], key[1:] != key[:-1]])
            return r[keep], c[keep], None
        order = np.lexsort((w, key))
        ks, rs, cs, ws = key[order], r[order], c[order], w[order]
        keep = np.concatenate([[True], ks[1:] != ks[:-1]])
        return rs[keep], cs[keep], ws[keep]
    r = np.ascontiguousarray(r, dtype=np.uint32)
    c = np.ascontiguousarray(c, dtype=np.uint32)
    wp = None
    if w is not None:
        w = np.ascontiguousarray(w, dtype=np.uint32)
        wp = _u32p(w)
    n = lib.gt_dedup_edges(_u32p(r), _u32p(c), wp, r.size)
    return (r[:n].astype(np.int64), c[:n].astype(np.int64),
            w[:n].astype(np.int32) if w is not None else None)


def bin_edges(r: np.ndarray, c: np.ndarray, L: int, R: int, C: int
              ) -> Tuple[np.ndarray, np.ndarray]:
    """Counting-sort permutation grouping edges by mesh device
    (parallel/layout.py semantics). Returns (perm, counts)."""
    lib = _load()
    D = R * C
    if lib is None:
        i = (r // L) % R
        j = (c // L) // R
        dev = i * C + j
        perm = np.argsort(dev, kind="stable")
        counts = np.bincount(dev, minlength=D)
        return perm, counts.astype(np.int64)
    r = np.ascontiguousarray(r, dtype=np.uint32)
    c = np.ascontiguousarray(c, dtype=np.uint32)
    perm = np.empty(r.size, dtype=np.int64)
    counts = np.empty(D, dtype=np.int64)
    lib.gt_bin_edges(_u32p(r), _u32p(c), r.size, L, R, C,
                     _i64p(perm), _i64p(counts))
    return perm, counts
