"""Controls: the reference put in the program's place with one defect, to
show that the comparison in ``reference.compare`` catches it.

* ``precision``: the values computed one precision below the one the
  configuration states (float32 -> bfloat16, int32 -> int16, ...), then
  widened back, as a cheaper decode would;
* ``request_order`` (takes): the rows returned in ascending row order, not
  in request order, as a take that skipped its final permutation would;
* ``row_order`` (scans): the fragments returned rotated by one (a single
  fragment's halves swapped), as a scan that gathered its fragments out of
  order would.

NumPy alone; nothing of the port.
"""

from __future__ import annotations

import numpy as np

from . import reference
from .reference import Column

# the nearest precision below each stated one
LOWER = {"float64": "float32", "float32": "bfloat16", "int64": "int32",
         "uint64": "uint32", "int32": "int16", "uint32": "uint16",
         "int16": "int8", "uint16": "uint8"}
CONTROLS = {"take": ("precision", "request_order"),
            "scan": ("precision", "row_order")}


def lower_precision(values: np.ndarray) -> np.ndarray:
    """``values`` rounded to the next lower precision and widened back."""
    dt = values.dtype
    low = LOWER[dt.name]
    if low == "bfloat16":
        bits = values.view(np.uint32).astype(np.uint64)
        bits = (bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000  # round to nearest even
        return bits.astype(np.uint32).view(np.float32)
    return values.astype(low).astype(dt)


class ControlReader:
    """Stands where the port's ``DatasetReader`` stands in a run: takes and
    scans the source column, with the named control's defect."""

    def __init__(self, col: Column, fragments: int, control: str):
        self.col, self.fragments, self.control = col, int(fragments), control

    def _answer(self, want: Column) -> Column:
        if self.control == "precision":
            return Column(want.validity, lower_precision(want.values))
        return want

    def take(self, column: str, rows) -> Column:
        rows = np.asarray(rows, dtype=np.int64)
        if self.control == "request_order":
            rows = np.sort(rows)
        return self._answer(reference.take(self.col, rows))

    def scan(self, column: str) -> Column:
        want = reference.scan(self.col)
        if self.control == "row_order":
            # the port's writer cuts fragments at these bounds; one
            # fragment has its halves swapped
            bounds = np.linspace(0, len(want), self.fragments + 1).astype(np.int64)
            shift = int(bounds[1]) if self.fragments > 1 else len(want) // 2
            want = Column(np.roll(want.validity, -shift), np.roll(want.values, -shift, axis=0))
        return self._answer(want)
