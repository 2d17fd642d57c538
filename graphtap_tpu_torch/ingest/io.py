"""Edge-list I/O: binary/text readers with byte-range parallel ingest.

Re-creates the behavior of the reference loader
(reference: Graph::load / parread_binary / parread_text,
graph.hpp:104-372): every ingest process reads only its 1/nprocs share of
the file, then applies the per-edge transforms (self-loop removal, acyclic
swap, transpose, undirected mirroring) at read time. File-type detection is
by extension/magic sniffing rather than ``popen("file -b")``
(graph.hpp:119-145).

Binary layout: little-endian ``(u32 row, u32 col[, u32 weight])`` records,
identical to the reference's ``data/*.bin`` fixtures (triple.hpp:10-18).
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np


def _looks_binary(path: str) -> bool:
    if path.endswith(".bin"):
        return True
    if path.endswith((".txt", ".el", ".edges", ".mtx")):
        return False
    with open(path, "rb") as f:
        head = f.read(4096)
    if not head:
        return True
    # text files are ASCII digits/whitespace
    printable = sum(1 for b in head if 32 <= b < 127 or b in (9, 10, 13))
    return printable / len(head) < 0.95


def read_edge_list(
    path: str,
    has_weight: bool = False,
    process_index: int = 0,
    process_count: int = 1,
) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
    """Read this process's share of an edge list.

    Returns (rows, cols, weights|None) as int64/int64/int32 arrays, before
    any transform. The byte range is split evenly across processes like the
    reference's seek-based parallel read (graph.hpp:234-240, 316-324).
    """
    if _looks_binary(path):
        return _read_binary(path, has_weight, process_index, process_count)
    return _read_text(path, has_weight, process_index, process_count)


def _read_binary(path, has_weight, pidx, pcnt):
    rec = 12 if has_weight else 8
    size = os.path.getsize(path)
    if size % rec:
        raise ValueError(f"{path}: size {size} not a multiple of record size {rec}")
    nrec = size // rec
    lo = (nrec * pidx) // pcnt
    hi = (nrec * (pidx + 1)) // pcnt
    with open(path, "rb") as f:
        f.seek(lo * rec)
        buf = np.fromfile(f, dtype=np.uint32, count=(hi - lo) * (rec // 4))
    buf = buf.reshape(-1, rec // 4)
    r = buf[:, 0].astype(np.int64)
    c = buf[:, 1].astype(np.int64)
    w = buf[:, 2].astype(np.int32) if has_weight else None
    return r, c, w


def _read_text(path, has_weight, pidx, pcnt):
    size = os.path.getsize(path)
    lo = (size * pidx) // pcnt
    hi = (size * (pidx + 1)) // pcnt
    with open(path, "rb") as f:
        # advance lo to the next line start (like parread_text, graph.hpp:234)
        if lo > 0:
            f.seek(lo - 1)
            chunk = f.read(1)
            if chunk != b"\n":
                f.readline()
            lo = f.tell()
        f.seek(hi)
        if hi < size:
            f.readline()
            hi = f.tell()
        f.seek(lo)
        data = f.read(hi - lo)
    if not data.strip():
        z = np.zeros(0, dtype=np.int64)
        return z, z.copy(), (np.zeros(0, dtype=np.int32) if has_weight else None)
    ncol = 3 if has_weight else 2
    # native hand-rolled parser when the host library is built (the
    # reference's parread_text analog, graph.hpp:234-306: ~10-30x faster
    # than tokenizing in Python); parse_text falls back to NumPy itself
    # when the toolchain is unavailable
    from graphtap_tpu_torch import native
    arr = native.parse_text(data, ncol)
    w = arr[:, 2].astype(np.int32) if has_weight else None
    return arr[:, 0], arr[:, 1], w


def apply_transforms(
    r: np.ndarray,
    c: np.ndarray,
    w: Optional[np.ndarray],
    directed: bool = True,
    transpose: bool = False,
    self_loops: bool = True,
    acyclic: bool = False,
) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
    """Per-edge read-time transforms, in the reference's order
    (graph.hpp:266-292): self-loop filter -> acyclic swap -> transpose ->
    undirected mirror."""
    if not self_loops:
        keep = r != c
        r, c = r[keep], c[keep]
        w = w[keep] if w is not None else None
    if acyclic:
        r2 = np.minimum(r, c)
        c2 = np.maximum(r, c)
        r, c = r2, c2
    if transpose:
        r, c = c, r
    if not directed:
        r0, c0 = r, c
        r = np.concatenate([r0, c0])
        c = np.concatenate([c0, r0])
        if w is not None:
            w = np.concatenate([w, w])
    return r, c, w


def write_binary(path: str, r: np.ndarray, c: np.ndarray,
                 w: Optional[np.ndarray] = None) -> None:
    cols = [np.asarray(r, np.uint32), np.asarray(c, np.uint32)]
    if w is not None:
        cols.append(np.asarray(w, np.uint32))
    np.stack(cols, axis=1).tofile(path)
