"""Route-kernel cost probe (P3): what one panel costs under K1-K3's gather.

Counterpart of ``tools_dev/route_cost_probe.py``. The panel pipeline's
route kernels read ``nwin`` data-dependent (8, 128) windows of a source
table per panel and write one (64, 128) panel. This probe isolates that
access pattern on synthetic data:

  * what one panel costs as a function of nwin (a fixed floor against a
    marginal window);
  * whether the windows' locality matters (every panel reading the same
    window against uniformly random windows).

``route_like(x2d, bases, npanels, nwin)``: per panel i, the sum of its
nwin windows ``x2d[bases[i*nwin + t]*8 : +8]`` in order t = 0 .. nwin-1,
tiled 8 times into the (64, 128) output panel — on the card the kernel of
``csrc/probe.cu`` (counted in ``LAUNCHES``), for a CPU tensor the plain
version. ``route_like_library`` is the same function as one indexed sum
(``x.view(-1, 8, 128)[bases].view(npanels, nwin, 8, 128).sum(1)`` plus the
tiling), the yardstick; the port never calls it. ``measure`` gives µs per
panel on the card.

    python -m graphtap_tpu_torch.tools.route_cost_probe [npanels]

prints the table with the card's name and power limit; it needs a card.
"""

from __future__ import annotations

import sys
import weakref

import numpy as np
import torch

from graphtap_tpu_torch.kernels import _cuda
from graphtap_tpu_torch.kernels.panel_kernels import _on_cuda, _stream
from graphtap_tpu_torch.tools.bw_probe import card

STRIPE, LANES, PROWS = 8, 128, 64
XBLOCKS = 4096          # source table: 4096 8-row blocks (16 MB f32)
REPS = 10               # timed calls per measurement

# launches of the CUDA kernel (the plain version is not counted)
LAUNCHES = {"route_like": 0}
# the bases tensor last checked in range (a weak reference, its version
# and the table's block count), so that timed calls on it read nothing
# back to the host
_checked = (None, -1, -1)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _windows(x2d, bases, npanels: int, nwin: int):
    return x2d.view(-1, STRIPE, LANES)[bases[:npanels * nwin].long()].view(
        npanels, nwin, STRIPE, LANES)


def route_like_plain(x2d, bases, npanels: int, nwin: int) -> torch.Tensor:
    """The windows summed in order t = 0 .. nwin-1 (the kernel's and the
    Pallas body's order), tiled to (npanels*64, 128)."""
    w = _windows(x2d, bases, npanels, nwin)
    acc = w[:, 0]
    for t in range(1, nwin):
        acc = acc + w[:, t]
    return acc.repeat(1, PROWS // STRIPE, 1).view(npanels * PROWS, LANES)


def route_like_library(x2d, bases, npanels: int, nwin: int) -> torch.Tensor:
    """One indexed sum and the tiling: the library yardstick."""
    return _windows(x2d, bases, npanels, nwin).sum(1).repeat(
        1, PROWS // STRIPE, 1).view(npanels * PROWS, LANES)


def route_like(x2d, bases, npanels: int, nwin: int) -> torch.Tensor:
    """P3 on the f32 table ``x2d`` (blocks*8, 128) and int32 ``bases``
    (npanels*nwin,) in [0, blocks). Replaces ``tools_dev/
    route_cost_probe.py::route_like``; the table is passed once."""
    if (x2d.dtype != torch.float32 or x2d.dim() != 2
            or x2d.shape[1] != LANES or x2d.shape[0] % STRIPE
            or not x2d.is_contiguous()):
        raise ValueError("route_like: a contiguous f32 (blocks*8, 128) "
                         "table")
    if (bases.dtype != torch.int32 or tuple(bases.shape) !=
            (npanels * nwin,) or bases.device != x2d.device
            or not bases.is_contiguous()):
        raise ValueError(f"route_like: int32 bases ({npanels * nwin},) on "
                         f"{x2d.device}")
    nblk = x2d.shape[0] // STRIPE
    if npanels < 1 or nwin < 1:
        raise ValueError(f"route_like: {npanels} panels of {nwin} windows")
    _check_bases(bases, nblk)
    if not _on_cuda(x2d):
        return route_like_plain(x2d, bases, npanels, nwin)
    lib = _cuda.library()
    out = torch.empty((npanels * PROWS, LANES), dtype=x2d.dtype,
                      device=x2d.device)
    with torch.cuda.device(x2d.device):
        rc = lib.gt_probe_route_like(x2d.data_ptr(), bases.data_ptr(),
                                     out.data_ptr(), npanels, nwin,
                                     _stream(x2d))
    LAUNCHES["route_like"] += 1
    _cuda.check(rc, "route_like")
    return out


def _check_bases(bases, nblk: int) -> None:
    """Raise unless every base lies in [0, nblk); a bases tensor checked
    last, and not written since, is not read again."""
    global _checked
    ref, version, blocks = _checked
    if ref is not None and ref() is bases and version == bases._version \
            and blocks == nblk:
        return
    if int(bases.min()) < 0 or int(bases.max()) >= nblk:
        raise ValueError(f"route_like: bases outside [0, {nblk})")
    _checked = (weakref.ref(bases), bases._version, nblk)


def make_inputs(npanels: int, nwin: int, mode: str = "random",
                device="cuda"):
    """(x2d of ones (4096*8, 128), bases): all 0 for "same", uniformly
    random blocks (numpy seed 7) for "random"."""
    x = torch.ones((XBLOCKS * STRIPE, LANES), dtype=torch.float32,
                   device=device)
    if mode == "same":
        b = np.zeros(npanels * nwin, np.int32)
    else:
        b = np.random.default_rng(7).integers(
            0, XBLOCKS, size=npanels * nwin).astype(np.int32)
    return x, torch.from_numpy(b).to(device)


def _us_per_panel(fn, npanels: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) * 1e3 / REPS / npanels


def measure(npanels: int, nwin: int, mode: str = "random",
            library: bool = False):
    """(output, µs per panel) of route_like (or, with ``library``, of
    route_like_library) on the card, CUDA events over REPS calls after a
    warm one."""
    x, b = make_inputs(npanels, nwin, mode)
    fn = (lambda: route_like_library(x, b, npanels, nwin)) if library \
        else (lambda: route_like(x, b, npanels, nwin))
    us = _us_per_panel(fn, npanels)
    return fn(), us


def table(npanels: int = 2048):
    """(label, kernel µs/panel, library µs/panel) for nwin 4, 12, 20, 31
    (random bases) and for all-same against random bases at nwin 20."""
    rows = [(f"nwin {nwin:2d} random", measure(npanels, nwin)[1],
             measure(npanels, nwin, library=True)[1])
            for nwin in (4, 12, 20, 31)]
    rows.append(("nwin 20 same", measure(npanels, 20, "same")[1],
                  measure(npanels, 20, "same", library=True)[1]))
    return rows


def format_table(rows, npanels: int) -> str:
    lines = [f"{'bases':16s}  us/panel kernel  library  (npanels="
             f"{npanels})"]
    lines += [f"{lab:16s}  {k:15.4f}  {lib:7.4f}" for lab, k, lib in rows]
    return "\n".join(lines)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("route_cost_probe: no CUDA device; the probe measures the "
              "card", file=sys.stderr)
        return 1
    npanels = int(argv[0]) if argv else 2048
    print(f"{card()} ({torch.cuda.get_device_name(0)})")
    print(format_table(table(npanels), npanels))
    return 0


if __name__ == "__main__":
    sys.exit(main())
