"""The Lance paper's §6.1 ``vector`` type: ``FixedSizeList<float32, 768>``
(3 KiB a row) of standard-normal values, 10% of rows null.

A frozen copy of the port's ``data/synth.py`` ``paper_type("vector")`` rule
(validity ``random() >= 0.10``, standard-normal values), drawn in float32 at
once rather than through float64.
"""

from __future__ import annotations

import numpy as np

from ..reference import Column

NULL_FRACTION = 0.10


def make(spec: dict, rows: int, rng: np.random.Generator) -> Column:
    validity = rng.random(rows) >= NULL_FRACTION
    values = rng.standard_normal((rows, int(spec["size"])), dtype=np.float32)
    return Column(validity=validity, values=values)
