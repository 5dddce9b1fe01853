"""The plain reference: what a take or a scan must return, from the source
buffers the benchmark generated, and the exact comparison that decides
``correct``.  NumPy alone; nothing of the port.

A column is a validity vector and a value array (one row a row: a scalar, or
a fixed-size list as a row of a 2-D array).  The guarantees every
configuration states: a take returns exactly the requested rows' values and
validity, in request order; a scan returns every row, in row order.  A null
row's value slot is not compared.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

# every number compared, and its limit: an exact comparison has the limit 0
LIMITS = {"missing_rows": 0, "wrong_validity": 0, "wrong_values": 0}


@dataclasses.dataclass
class Column:
    validity: np.ndarray  # bool, one a row
    values: np.ndarray  # (rows,) or (rows, list size)

    def __len__(self) -> int:
        return len(self.validity)


def take(col: Column, rows: np.ndarray) -> Column:
    rows = np.asarray(rows, dtype=np.int64)
    return Column(col.validity[rows], col.values[rows])


def scan(col: Column) -> Column:
    return col


def compare(want: Column, got_validity, got_values) -> Dict[str, int]:
    """Counts of rows that break the guarantees: rows missing from (or added
    to) the answer, rows whose validity differs, and valid rows whose value
    differs in any element (compared bit for bit, so a float that changed
    in its last bit, or a NaN, counts)."""
    got_validity = np.asarray(got_validity, dtype=bool).reshape(-1)
    got_values = np.asarray(got_values)
    n = min(len(want), len(got_validity), len(got_values))
    counts = {"missing_rows": max(len(want), len(got_validity), len(got_values)) - n,
              "wrong_validity": int((want.validity[:n] != got_validity[:n]).sum()),
              "wrong_values": 0}
    if (got_values.shape[1:] != want.values.shape[1:]
            or got_values.dtype != want.values.dtype):
        counts["wrong_values"] = int(want.validity[:n].sum())
        return counts
    bits = np.dtype(f"u{want.values.dtype.itemsize}")
    differs = (want.values[:n].view(bits) != got_values[:n].view(bits))
    differs = differs.reshape(n, -1).any(axis=1)
    counts["wrong_values"] = int((differs & want.validity[:n]).sum())
    return counts
