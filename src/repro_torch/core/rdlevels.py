"""Repetition/definition level physical encodings.

Two forms are used by the structural encodings:

* **Control words** (full-zip, paper §4.1.1): rep and def are bit-packed side
  by side into a fixed 1–4 byte little-endian word per value, with no
  chunking or RLE, so the width is constant across the column chunk and a
  repetition index can point at a value's control word directly.
* **Packed streams** (mini-block, paper §4.2): rep and def are each bit-packed
  into their own per-chunk buffer (vectorized decode).
"""

from __future__ import annotations

import numpy as np

from .compression import bitpack, bitunpack

__all__ = [
    "level_bits",
    "control_word_width",
    "pack_control_words",
    "unpack_control_words",
    "gather_le",
    "pack_levels",
    "unpack_levels",
]


def level_bits(max_level: int) -> int:
    """Bits to store levels in [0, max_level]; 0 when the stream is absent."""
    return int(max_level).bit_length() if max_level > 0 else 0


def control_word_width(max_rep: int, max_def: int) -> int:
    """Bytes per control word (0 when neither stream exists)."""
    bits = level_bits(max_rep) + level_bits(max_def)
    if bits == 0:
        return 0
    w = (bits + 7) // 8
    assert w <= 4, "control words are 1-4 bytes (paper sec 4.1.1)"
    return w


def pack_control_words(rep, defs, max_rep: int, max_def: int) -> np.ndarray:
    """rep/def -> uint8 buffer of fixed-width little-endian control words.

    Layout: ``word = (rep << def_bits) | def`` — matching the paper's Fig. 6
    where the repetition bit sits above the definition bits.
    """
    w = control_word_width(max_rep, max_def)
    db = level_bits(max_def)
    n = len(rep) if rep is not None else len(defs)
    word = np.zeros(n, dtype=np.uint32)
    if defs is not None:
        word |= defs.astype(np.uint32)
    if rep is not None:
        word |= rep.astype(np.uint32) << np.uint32(db)
    out = np.zeros((n, w), dtype=np.uint8)
    for b in range(w):
        out[:, b] = (word >> np.uint32(8 * b)).astype(np.uint8)
    return out.reshape(-1)


def unpack_control_words(buf: np.ndarray, n: int, max_rep: int, max_def: int):
    """Inverse of :func:`pack_control_words` -> (rep|None, def|None)."""
    w = control_word_width(max_rep, max_def)
    db = level_bits(max_def)
    rb = level_bits(max_rep)
    b = np.ascontiguousarray(buf[: n * w], dtype=np.uint8).reshape(n, w)
    word = np.zeros(n, dtype=np.uint32)
    for i in range(w):
        word |= b[:, i].astype(np.uint32) << np.uint32(8 * i)
    defs = (word & np.uint32((1 << db) - 1)).astype(np.uint8) if db else None
    rep = ((word >> np.uint32(db)) & np.uint32((1 << rb) - 1)).astype(np.uint8) if rb else None
    return rep, defs


def gather_le(buf: np.ndarray, pos: np.ndarray, width: int) -> np.ndarray:
    """Gather ``width``-byte little-endian ints at byte positions ``pos``.

    The row-parallel full-zip walk reads control words and length prefixes at
    many buffer positions per vectorized step; this is its one gather
    primitive.  Positions are clipped to the buffer so speculative reads past
    the end (an invalid trailing entry, a truncated scan window) return
    garbage instead of faulting — callers mask those lanes.
    """
    if len(pos) == 0 or width == 0 or len(buf) == 0:
        return np.zeros(len(pos), dtype=np.uint64)
    top = max(len(buf) - 1, 0)
    out = np.zeros(len(pos), dtype=np.uint64)
    p = np.asarray(pos, dtype=np.int64)
    for b in range(width):
        out |= buf[np.minimum(p + b, top)].astype(np.uint64) << np.uint64(8 * b)
    return out


def pack_levels(levels: np.ndarray, max_level: int) -> np.ndarray:
    """Bit-pack one level stream (mini-block buffers)."""
    return bitpack(levels.astype(np.uint64), level_bits(max_level))


def unpack_levels(buf: np.ndarray, n: int, max_level: int) -> np.ndarray:
    return bitunpack(buf, n, level_bits(max_level)).astype(np.uint8)
