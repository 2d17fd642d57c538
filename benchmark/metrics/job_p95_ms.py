"""The 95th percentile of the latency of every job of the window, each
from its ``initialize`` to the end of its ``execute`` (a device
synchronize), in milliseconds (numpy's linear interpolation)."""

import numpy as np


def read(ctx):
    return float(np.percentile(ctx["window"]["latencies"], 95)) * 1e3
