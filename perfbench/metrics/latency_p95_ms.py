"""latency_p95_ms: the 95th percentile of the window's calls, each timed
from the call to its outputs synchronised (numpy's linear rule)."""

import numpy as np


def read(run):
    return float(np.percentile(np.asarray(run.latencies) * 1e3, 95))
