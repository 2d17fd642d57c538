"""The kernel lab's comparison table: every variant over one graph.

Counterpart of ``tools_dev/lab_table.py``: runs the kernel-lab variants
(0-8, ``tools/kernel_lab.py``) over the same RMAT graph and renders one
markdown table of time, GTEPS, streamed slots, pad factor, checksum and
memory, with the reference's cross-variant gates (singlenode/main.slurm:
31-40, csc_spmv.hpp:222-228): operations equal, and checksums within
1e-5 relative of each other.

Resumable: rows land in ``graphtap_tpu_torch/build/lab/LAB_RMAT<scale>
.jsonl``, one per line, and a rerun skips recorded variants; the table is
written beside it as ``LAB_RMAT<scale>.md`` (``--render``: from the jsonl
alone). The RMAT edge file comes from ``tools/artifact_cache.py``'s
``cached_rmat``, in the same directory.

Usage: python -m graphtap_tpu_torch.tools.lab_table [--scale 18]
[--iters 20] [--device cuda|cpu] [--render]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

from graphtap_tpu_torch.tools.kernel_lab import VARIANTS, run_variant

OUT_DIR = Path(__file__).resolve().parent.parent / "build" / "lab"
CHECKSUM_RTOL = 1e-5


def run_rows(path: str, nvertices: int, niters: int, variants=None,
             device="cuda", done=(), sink=None, printer=None) -> list:
    """The rows of ``variants`` (default: all, in order) on the edge file
    ``path``; each row is ``run_variant``'s dict with ``which`` and its
    wall ``total_seconds``. Variants in ``done`` are skipped; ``sink``
    (an open text file) gets each row as a JSON line, ``printer`` a
    progress line."""
    rows = []
    for which in sorted(VARIANTS) if variants is None else variants:
        if which in done:
            continue
        t0 = time.perf_counter()
        r = run_variant(which, path, nvertices, niters, device=device)
        r["which"] = which
        r["total_seconds"] = time.perf_counter() - t0
        rows.append(r)
        if sink is not None:
            sink.write(json.dumps(r) + "\n")
            sink.flush()
        if printer is not None:
            printer(f"[lab] {which} {r['variant']}: {r['gteps']:.4f} GTEPS "
                    f"cs={r['checksum']!r} (+{r['total_seconds']:.1f} s)")
    return rows


def gates(rows, rtol: float = CHECKSUM_RTOL) -> None:
    """The cross-variant gates: operations equal across ``rows``, and
    their checksums within ``rtol`` relative. Raises AssertionError."""
    ops = {r["operations"] for r in rows}
    assert len(ops) == 1, f"op-count mismatch across variants: {ops}"
    cs = [r["checksum"] for r in rows]
    assert max(cs) - min(cs) <= rtol * max(abs(c) for c in cs), cs


def render(scale, rows, note: str = "") -> str:
    """The markdown table of ``rows`` (sorted by variant), then the
    cross-check line; ``note`` names the card and run."""
    rows = sorted(rows, key=lambda r: r["which"])
    lines = [f"# Kernel lab comparison — RMAT-{scale}", ""]
    if note:
        lines += [note, ""]
    lines += [
        "PageRank, the same graph and iterations for every variant. "
        "`operations` comes from each variant's own tile set, so its "
        "equality across variants is a format invariant; `slots` is the "
        "padded work the variant streams.",
        "",
        "| # | variant | seconds | GTEPS | slots streamed | pad | checksum "
        "| memory GB |",
        "|---|---------|---------|-------|----------------|-----|----------"
        "|-----------|",
    ]
    for r in rows:
        lines.append(
            f"| {r['which']} | {r['variant']} | {r['seconds']:.4f} | "
            f"{r['gteps']:.4f} | {r['slots']:,} | x{r['pad_factor']:.2f} | "
            f"{r['checksum']!r} | {r['memory_gb']:.6g} |")
    if rows:
        ops = {r["operations"] for r in rows}
        cs = [r["checksum"] for r in rows]
        spread = (max(cs) - min(cs)) / max(abs(c) for c in cs)
        lines += ["", f"Cross-checks: operations "
                  f"{'EQUAL' if len(ops) == 1 else sorted(ops)} "
                  f"({rows[0]['operations']:,}); checksums within "
                  f"{spread:.3e} relative across all {len(rows)} variants."]
    return "\n".join(lines) + "\n"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="graphtap_tpu_torch.tools.lab_table")
    p.add_argument("--scale", type=int, default=18)
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--render", action="store_true")
    args = p.parse_args(argv)
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    jsonl = OUT_DIR / f"LAB_RMAT{args.scale}.jsonl"
    rows = []
    if jsonl.exists():
        rows = [json.loads(ln) for ln in jsonl.read_text().splitlines()
                if ln.strip()]
    if not args.render:
        from graphtap_tpu_torch.tools.artifact_cache import cached_rmat
        cached_rmat(args.scale, 16, 1, OUT_DIR)     # materialize the .bin
        path = os.path.join(OUT_DIR, f"rmat{args.scale}_ef16_s1.bin")
        with open(jsonl, "a") as fh:
            rows += run_rows(path, (1 << args.scale) + 1, args.iters,
                             device=args.device,
                             done={r["which"] for r in rows}, sink=fh,
                             printer=lambda s: print(s, file=sys.stderr))
        gates(rows)
    md = OUT_DIR / f"LAB_RMAT{args.scale}.md"
    md.write_text(render(args.scale, rows))
    print(f"wrote {md}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
