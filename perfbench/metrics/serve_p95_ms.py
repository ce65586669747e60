"""The 95th percentile of every call's latency in the window (CUDA events
stamped at the host's call and at the class map's completion)."""

import numpy as np


def read(run):
    return float(np.percentile(run.obs["latencies_ms"], 95))
