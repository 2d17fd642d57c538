"""Validation oracles beyond checksum/display.

Counterpart of ``graphtap_tpu/tools/oracle.py``: the analog of the
reference's ``checksum1()`` (vertex_program.hpp:1963-2119), which gathers
all states to the master and prints count / mean / stddev / mode /
skewness / max over the reachable states.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def state_stats(values: np.ndarray, infinity) -> Dict[str, float]:
    """Summary statistics over reachable states (state != infinity)."""
    vals = np.asarray(values, dtype=np.float64)
    mask = vals != np.float64(infinity)
    v = vals[mask]
    if v.size == 0:
        return {"count": 0, "mean": 0.0, "std": 0.0, "mode": 0.0,
                "skew": 0.0, "max": 0.0}
    mean = float(v.mean())
    std = float(v.std())
    # mode of the rounded values (the reference modes integer states)
    vr = np.round(v).astype(np.int64)
    uniq, counts = np.unique(vr, return_counts=True)
    mode = float(uniq[counts.argmax()])
    # Pearson's second skewness coefficient: 3(mean - median)/std, as a
    # cheap stand-in for the reference's mode-based skew
    skew = float(3 * (mean - float(np.median(v))) / std) if std > 0 else 0.0
    return {"count": int(v.size), "mean": mean, "std": std, "mode": mode,
            "skew": skew, "max": float(v.max())}
