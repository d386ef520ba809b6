"""The 95th percentile of the latency of every call in the window, ms."""

import numpy as np


def read(run):
    return float(np.percentile(run.latencies_s, 95)) * 1e3
