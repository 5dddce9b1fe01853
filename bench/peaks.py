"""The published memory bandwidth of one NVIDIA H100 SXM (NVIDIA's data
sheet, at the full 700 W power limit) and the work each mix needs, so that
a roofline share is defined on the operation and not on the kernels that
happen to serve it.

A take or a scan does no arithmetic beyond moving its result, so its bound
is the memory bound: the result's bytes (values, and validity at one bit a
row) written once and read once, at ``HBM_BYTES_PER_S``.
"""

from __future__ import annotations

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # HBM3, 80 GB


def result_bytes(validity: np.ndarray, values: np.ndarray) -> int:
    """Bytes an answer must hold: its values and one validity bit a row."""
    return int(np.asarray(values).nbytes) + (len(validity) + 7) // 8


def memory_bound_s(nbytes: int) -> float:
    """Least device time to write ``nbytes`` once and read them once."""
    return 2 * nbytes / HBM_BYTES_PER_S
