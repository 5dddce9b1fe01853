"""Adaptive structural-encoding selection (the paper's headline idea, §4).

Lance 2.1 alternates between two structural encodings based on data width:

* values >= 128 bytes  -> **full-zip** (cheap per-value access, no search
  cache, 1-2 IOPS random access);
* values <  128 bytes  -> **mini-block** (vectorized chunk decode, opaque
  compression, small search cache, chunk-sized read amplification).

The 128 B/value threshold is the paper's experimentally-derived constant
(§4.1).  The decision is per *leaf column* after shredding, using the same
average-size statistic the Lance writer uses.
"""

from __future__ import annotations

from .encodings_base import avg_value_bytes
from .shred import ShreddedLeaf

__all__ = ["FULLZIP_THRESHOLD_BYTES", "choose_encoding"]

FULLZIP_THRESHOLD_BYTES = 128


def choose_encoding(leaf: ShreddedLeaf) -> str:
    """'fullzip' for large values, 'miniblock' for small ones."""
    return "fullzip" if avg_value_bytes(leaf) >= FULLZIP_THRESHOLD_BYTES else "miniblock"
