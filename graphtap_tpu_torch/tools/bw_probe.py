"""Device-memory streaming probe (P1, P2): the copy rate the card reaches.

Counterpart of ``tools_dev/bw_probe.py``. Every "bound" the port writes
down divides the bytes a kernel must move by the card's 3.35 TB/s spec
rate; this probe measures the rate a hand-written kernel really reaches,
through blocked copy kernels across block geometries (P1), streams summed
into one output (P2), and two calibration rows: torch's ``x + 1``
(elementwise, the TPU table's XLA row) and ``Tensor.copy_`` (the library
copy). Arrays of about 268 MB; each timed region chains NCHAIN = 8
dependent calls, timed by CUDA events after a warm call; GB/s counts read
+ write bytes.

  * ``copy_1d(rows_per_block, lanes, dtype)``: a (rows, lanes) array in
    (rows_per_block, lanes) blocks;
  * ``copy_2d(bm, bn)``: an (m, 8192) f32 array in (bm, bn) blocks;
  * ``multi_stream_sum(nstreams)``: 2 or 4 f32 (rows, 1024) streams
    summed into one output, cut in (64, 1024) blocks (on the card each
    CUDA block sums a 16 KB chunk of every stream, whatever the blocks).

Each returns (its output tensor, GB/s). On the card the kernels of
``csrc/probe.cu`` run (``copy_blocks``, ``stream_sum``, each counted in
``LAUNCHES``); a CPU tensor takes the plain version (``x.clone()``, a sum
of the streams in order) and the rate is None: a CPU run gives no device
rate.

P1 on the card measures TMA bulk copies, global -> shared -> global, on
an mbarrier, no value in registers. The copy is cut in tile order into
chunks of whole rows of one tile (``copy_chunks``: at most CHUNK_BYTES a
chunk; a row segment wider than that splits into pieces), one one-warp
block a chunk; the SM's resident blocks are the ring
(``copy_blocks_per_sm`` chunks in flight). The panel kernels' plan rings
use the same copies from persistent blocks, which ran about 3% behind
one block a chunk on the H100 (PERF.md).

    python -m graphtap_tpu_torch.tools.bw_probe [quick]

prints the table with the card's name and power limit; it needs a card.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from typing import List, NamedTuple, Optional, Tuple

import torch

from graphtap_tpu_torch.kernels import _cuda
from graphtap_tpu_torch.kernels.panel_kernels import _on_cuda, _stream

MB = 1 << 20
TARGET_BYTES = 268 * MB
NCHAIN = 8
WIDE = 8192                  # columns of copy_2d's array

# P1's chunks on the card: at most CHUNK_BYTES each
CHUNK_BYTES = 32 * 1024

# launches of each CUDA kernel (the plain versions are not counted)
LAUNCHES = {"copy_blocks": 0, "stream_sum": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# --------------------------------------------------------- plain versions
def copy_blocks_plain(x: torch.Tensor, bm: int, bn: int) -> torch.Tensor:
    return x.clone()


def stream_sum_plain(xs: List[torch.Tensor]) -> torch.Tensor:
    """((x0 + x1) + x2) + x3: the streams summed in order."""
    acc = xs[0] + xs[1]
    for x in xs[2:]:
        acc = acc + x
    return acc


# ------------------------------------------------------------ P1's chunks
class CopyChunks(NamedTuple):
    chunk_rows: int     # rows of a chunk (the last of a tile may hold fewer)
    pieces: int         # pieces of a row segment (1 while it fits a chunk)
    piece_bytes: int    # bytes of a piece (the last piece holds the rest)


def copy_chunks(rows: int, row_bytes: int, bm: int,
                bn_bytes: int) -> CopyChunks:
    """How P1 cuts a (rows, row_bytes) array in (bm, bn_bytes) tiles into
    chunks: up to ``chunk_rows`` consecutive rows of one tile, the most
    whose row segments fit CHUNK_BYTES; a segment wider than CHUNK_BYTES
    is one row cut into ``pieces`` of ``piece_bytes``. A tile's chunks
    are rows-major, pieces-minor, and the tiles row-major."""
    if (bm <= 0 or bn_bytes <= 0 or bn_bytes % 16 or row_bytes % bn_bytes
            or rows % bm):
        raise ValueError(f"copy_chunks: ({rows}, {row_bytes} bytes) in "
                         f"({bm}, {bn_bytes} bytes) tiles of whole 16-byte "
                         f"rows")
    piece = min(bn_bytes, CHUNK_BYTES)
    return CopyChunks(min(bm, CHUNK_BYTES // piece), -(-bn_bytes // piece),
                      piece)


def copy_blocks_per_sm(ch: CopyChunks) -> int:
    """P1's blocks (chunks in flight) one SM of the current card holds at
    once for chunks ``ch``."""
    out = ctypes.c_int(0)
    rc = _cuda.library().gt_probe_copy_blocks_per_sm(
        ch.chunk_rows * ch.piece_bytes, ctypes.addressof(out))
    _cuda.check(rc, "copy_blocks_per_sm")
    return out.value


# --------------------------------------------------------------- wrappers
def copy_blocks(x: torch.Tensor, bm: int, bn: int) -> torch.Tensor:
    """P1: a copy of the 2-D ``x`` in (bm, bn) tiles, tile by tile.
    Replaces ``tools_dev/bw_probe.py``'s ``_copy_kernel`` calls. On the
    card, one block a chunk (``copy_chunks``) copies it with TMA bulk
    copies through shared memory."""
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError("copy_blocks: expected a contiguous 2-D tensor")
    rows, cols = x.shape
    if rows % bm or cols % bn or (bn * x.element_size()) % 16:
        raise ValueError(f"copy_blocks: ({rows}, {cols}) in ({bm}, {bn}) "
                         f"tiles of whole 16-byte rows")
    if not _on_cuda(x):
        return copy_blocks_plain(x, bm, bn)
    lib = _cuda.library()
    y = torch.empty_like(x)
    es = x.element_size()
    ch = copy_chunks(rows, cols * es, bm, bn * es)
    with torch.cuda.device(x.device):
        rc = lib.gt_probe_copy(x.data_ptr(), y.data_ptr(), rows, cols * es,
                               bm, bn * es, *ch, _stream(x))
    LAUNCHES["copy_blocks"] += 1
    _cuda.check(rc, "copy_blocks")
    return y


def stream_sum(xs: List[torch.Tensor], bm: int = 64) -> torch.Tensor:
    """P2: ((x0 + x1) + x2) + x3 of 2 or 4 f32 (rows, lanes) streams, cut
    in (bm, lanes) blocks as the Pallas probe cuts them. On the card the
    grid does not follow bm: each block sums a 16 KB chunk of every
    stream. Replaces ``tools_dev/bw_probe.py``'s ``multi_stream_sum``
    kernel."""
    if len(xs) not in (2, 4):
        raise ValueError("stream_sum: 2 or 4 streams")
    x0 = xs[0]
    for x in xs:
        if (x.dtype != torch.float32 or x.dim() != 2 or x.shape != x0.shape
                or not x.is_contiguous() or x.device != x0.device):
            raise ValueError("stream_sum: contiguous f32 (rows, lanes) "
                             "streams of one shape and device")
    rows, lanes = x0.shape
    if rows % bm or lanes % 4:
        raise ValueError(f"stream_sum: ({rows}, {lanes}) in ({bm}, "
                         f"{lanes}) blocks")
    if not _on_cuda(x0):
        return stream_sum_plain(xs)
    lib = _cuda.library()
    out = torch.empty_like(x0)
    four = len(xs) == 4
    with torch.cuda.device(x0.device):
        rc = lib.gt_probe_stream_sum(
            xs[0].data_ptr(), xs[1].data_ptr(),
            xs[2].data_ptr() if four else None,
            xs[3].data_ptr() if four else None, out.data_ptr(), len(xs),
            rows, lanes, bm, _stream(x0))
    LAUNCHES["stream_sum"] += 1
    _cuda.check(rc, "stream_sum")
    return out


# ------------------------------------------------------------- measurement
def chained_gbs(fn, nbytes: int, device) -> Tuple[torch.Tensor,
                                                  Optional[float]]:
    """(the output of ``fn()``, its rate): ``fn`` runs NCHAIN dependent
    calls and moves ``nbytes`` in all. On the card: one warm call, then
    CUDA events around one timed call; on the CPU the rate is None."""
    out = fn()
    if torch.device(device).type != "cuda":
        return out, None
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize(device)
    return out, nbytes / (start.elapsed_time(end) * 1e-3) / 1e9


def _chain(call, x):
    def run():
        y = x
        for _ in range(NCHAIN):
            y = call(y)
        return y
    return run


def _itemsize(dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def shape_1d(rows_per_block: int, lanes: int, dtype=torch.float32,
             target_bytes: int = TARGET_BYTES) -> Tuple[int, int]:
    """copy_1d's array: (rows, lanes), rows whole blocks."""
    rows = target_bytes // (lanes * _itemsize(dtype))
    return rows - rows % rows_per_block, lanes


def shape_2d(bm: int, dtype=torch.float32,
             target_bytes: int = TARGET_BYTES) -> Tuple[int, int]:
    """copy_2d's array: (m, WIDE), m whole blocks."""
    m = target_bytes // (WIDE * _itemsize(dtype))
    return m - m % bm, WIDE


def copy_shapes(quick: bool = False):
    """(table label, array shape, dtype, bm, bn, copy) of each P1 row of
    ``table``, in its order; ``copy(bm, bn, dtype, device)`` is the row's
    probe, ``copy_1d`` or ``copy_2d``."""
    out = [(f"cuda copy 1D ({rb},1024)", shape_1d(rb, 1024), torch.float32,
            rb, 1024, copy_1d)
           for rb in ((8, 256) if quick else (8, 64, 256, 1024))]
    out += [(f"cuda copy 2D ({bm},{bn})", shape_2d(bm), torch.float32, bm,
             bn, copy_2d) for bm, bn in (((8, 128), (256, 512)) if quick else (
                 (8, 128), (64, 128), (256, 128), (256, 512), (512, 1024)))]
    if not quick:
        out.append(("cuda copy int8 (64,1024) byte rate",
                    shape_1d(64, 1024, torch.int8), torch.int8, 64, 1024,
                    copy_1d))
    return out


def copy_1d(rows_per_block: int, lanes: int, dtype=torch.float32,
            device="cuda", target_bytes: int = TARGET_BYTES):
    """(rows, lanes) ones in (rows_per_block, lanes) blocks, NCHAIN chained
    copies; (output, read+write GB/s)."""
    x = torch.ones(shape_1d(rows_per_block, lanes, dtype, target_bytes),
                   dtype=dtype, device=device)
    return chained_gbs(_chain(lambda y: copy_blocks(y, rows_per_block,
                                                    lanes), x),
                       2 * x.numel() * x.element_size() * NCHAIN, device)


def copy_2d(bm: int, bn: int, dtype=torch.float32, device="cuda",
            target_bytes: int = TARGET_BYTES):
    """(m, 8192) ones in (bm, bn) blocks, NCHAIN chained copies; (output,
    read+write GB/s)."""
    if WIDE % bn:
        raise ValueError(f"copy_2d: bn {bn} does not divide {WIDE}")
    x = torch.ones(shape_2d(bm, dtype, target_bytes), dtype=dtype,
                   device=device)
    return chained_gbs(_chain(lambda y: copy_blocks(y, bm, bn), x),
                       2 * x.numel() * x.element_size() * NCHAIN, device)


def multi_stream_sum(nstreams: int, rows_per_block: int = 64,
                     lanes: int = 1024, device="cuda",
                     target_bytes: int = TARGET_BYTES):
    """nstreams f32 streams, stream i all (i + 1), summed into one output;
    the output is summed with streams 1.. again, NCHAIN calls in all;
    (output, (nstreams + 1) x bytes x NCHAIN / s in GB/s)."""
    rows = target_bytes // (lanes * 4 * nstreams)
    rows -= rows % rows_per_block
    xs = [torch.full((rows, lanes), float(i + 1), device=device)
          for i in range(nstreams)]

    def run():
        y = stream_sum(xs, rows_per_block)
        for _ in range(NCHAIN - 1):
            y = stream_sum([y] + xs[1:], rows_per_block)
        return y
    nbytes = (nstreams + 1) * xs[0].numel() * 4 * NCHAIN
    return chained_gbs(run, nbytes, device)


def elementwise(device="cuda", target_bytes: int = TARGET_BYTES):
    """torch's ``x + 1`` chained NCHAIN times (the TPU table's XLA
    elementwise row); (output, GB/s)."""
    x = torch.ones((target_bytes // (1024 * 4), 1024), device=device)
    return chained_gbs(_chain(lambda y: y + 1.0, x),
                       2 * x.numel() * 4 * NCHAIN, device)


def library_copy(device="cuda", target_bytes: int = TARGET_BYTES):
    """``Tensor.copy_`` between two buffers, NCHAIN times (the library
    copy); (output, GB/s)."""
    x = torch.ones((target_bytes // (1024 * 4), 1024), device=device)
    y = torch.empty_like(x)

    def run():
        a, b = x, y
        for _ in range(NCHAIN):
            b.copy_(a)
            a, b = b, a
        return a
    return chained_gbs(run, 2 * x.numel() * 4 * NCHAIN, device)


def table(quick: bool = False, device="cuda") -> List[Tuple[str, float]]:
    """The probe's rows, (config, read+write GB/s), as
    ``tools_dev/bw_probe.py`` lists them, with torch's ``x + 1`` for the
    XLA row and ``Tensor.copy_`` beside it."""
    rows = [("torch elementwise x+1", elementwise(device)[1]),
            ("torch Tensor.copy_", library_copy(device)[1])]
    for label, _, dtype, bm, bn, copy in copy_shapes(quick):
        rows.append((label, copy(bm, bn, dtype, device)[1]))
    rows.append(("2-stream sum -> 1 out (64,1024)",
                 multi_stream_sum(2, device=device)[1]))
    rows.append(("4-stream sum -> 1 out (64,1024)",
                 multi_stream_sum(4, device=device)[1]))
    return rows


def card() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()


def format_table(rows) -> str:
    lines = [f"{'config':44s}  GB/s (read+write)"]
    lines += [f"{name:44s}  {gbs:7.1f}" for name, gbs in rows]
    return "\n".join(lines)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("bw_probe: no CUDA device; the probe measures the card",
              file=sys.stderr)
        return 1
    print(f"{card()} ({torch.cuda.get_device_name(0)})")
    print(format_table(table(quick=bool(argv) and argv[0] == "quick")))
    return 0


if __name__ == "__main__":
    sys.exit(main())
