"""The 95th percentile (nearest rank) of every take's latency in the window,
from the call until its answer is on the host.  Host clock; ms."""

import numpy as np

from bench.cell import nearest_rank


def read(record):
    if record.mix != "take" or not record.latencies_s:
        return None
    return float(nearest_rank(np.sort(record.latencies_s), 0.95)) * 1e3
