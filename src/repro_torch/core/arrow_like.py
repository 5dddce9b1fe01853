"""Arrow-style structural encoding (paper §3.2) — the second baseline.

The nested array is stored as Arrow's dense flat buffers: one validity
bitmap per nullable level, one offsets buffer per list / var-width level, and
a values buffer.  No pages, no rep/def levels, no search cache.  Random
access must chase offsets level by level — the paper's Fig. 4 shows 5 IOPS in
3 dependent phases for ``List<String>``; this reader reproduces exactly those
counts.  Optional whole-buffer compression renders the column opaque, which
is why compressed Arrow files cannot do random access (§6.2).

This is also the structural encoding of the Lance 2.0 format that the paper
benchmarks as its "Arrow-style" representative (§5.3).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np

from . import arrays as A
from . import types as T
from .encodings_base import EncodedColumn, pad_to

# one codec-selection point for the whole repo: compression.py already
# resolves zstandard-or-zlib, so Arrow buffers use the exact same pair
from .compression import _ZSTD_C as _C, _ZSTD_D as _D

__all__ = ["encode_arrow", "ArrowReader"]


def _collect_buffers(arr: A.Array, path: str, out: List[Tuple[str, str, np.ndarray, int]]):
    """Flatten into (name, role, bytes, logical_len) buffers, Arrow layout."""
    n = len(arr)
    if arr.type.nullable:
        out.append((path, "validity", np.packbits(arr.validity, bitorder="little"), n))
    if isinstance(arr, A.PrimitiveArray):
        out.append((path, "values", np.frombuffer(np.ascontiguousarray(arr.values).tobytes(), np.uint8), n))
    elif isinstance(arr, A.FixedSizeListArray):
        out.append((path, "values", np.frombuffer(np.ascontiguousarray(arr.values).tobytes(), np.uint8), n))
    elif isinstance(arr, A.VarBinaryArray):
        out.append((path, "offsets", np.frombuffer(arr.offsets.tobytes(), np.uint8), n + 1))
        out.append((path, "data", arr.data, int(arr.offsets[-1])))
    elif isinstance(arr, A.ListArray):
        out.append((path, "offsets", np.frombuffer(arr.offsets.tobytes(), np.uint8), n + 1))
        _collect_buffers(arr.child, path + ".item", out)
    elif isinstance(arr, A.StructArray):
        for name, c in arr.children:
            _collect_buffers(c, path + "." + name, out)
    else:  # pragma: no cover
        raise TypeError(type(arr))


def encode_arrow(arr: A.Array, compress: bool = False) -> EncodedColumn:
    bufs: List[Tuple[str, str, np.ndarray, int]] = []
    _collect_buffers(arr, "c", bufs)
    payload = b""
    meta_bufs = []
    for name, role, data, ln in bufs:
        raw = data.tobytes()
        if compress:
            raw = _C.compress(raw)
        off = len(payload)
        payload += pad_to(raw)
        meta_bufs.append({"name": name, "role": role, "offset": off,
                          "size": len(raw), "len": ln})
    meta = {
        "encoding": "arrow",
        "buffers": meta_bufs,
        "n_rows": len(arr),
        "compressed": compress,
    }
    # Arrow needs no search cache: buffer locations are footer metadata.
    return EncodedColumn("arrow", payload, meta, search_cache_bytes=0)


@dataclasses.dataclass
class _Buf:
    offset: int
    size: int
    len: int


class ArrowReader:
    """Reads the Arrow layout.  Returns nested ``Array`` values directly
    (this encoding has no rep/def streams)."""

    def __init__(self, meta: Dict, base: int, typ: T.DataType):
        self.meta = meta
        self.base = base
        self.type = typ
        self.bufs: Dict[Tuple[str, str], _Buf] = {
            (b["name"], b["role"]): _Buf(b["offset"], b["size"], b["len"])
            for b in meta["buffers"]
        }
        self._full_cache: Dict[Tuple[str, str], np.ndarray] = {}

    # -- raw access helpers ----------------------------------------------
    def _read_full(self, io, key, phase=0) -> np.ndarray:
        if key in self._full_cache:
            return self._full_cache[key]
        b = self.bufs[key]
        raw = io.read(self.base + b.offset, b.size, phase=phase)
        if self.meta["compressed"]:
            raw = np.frombuffer(_D.decompress(raw.tobytes()), np.uint8)
        self._full_cache[key] = raw
        return raw

    def _read_slices(self, io, key, byte_lo: np.ndarray, byte_hi: np.ndarray,
                     phase: int):
        """Batched per-buffer slice reads: all spans of one buffer go out as
        a single ``read_many`` dispatch (one logical op per span, exactly
        the trace the per-row reader produced); opaque (compressed) buffers
        are fetched whole once and sliced in memory.  Returns
        ``(data, doffs)``."""
        sizes = byte_hi - byte_lo
        if self.meta["compressed"]:
            # opaque: the entire buffer is fetched (once) + decompressed
            full = self._read_full(io, key, phase)
            doffs = np.zeros(len(sizes) + 1, dtype=np.int64)
            np.cumsum(sizes, out=doffs[1:])
            src = A.ragged_indices(byte_lo, sizes)
            return (full[src] if len(src) else np.zeros(0, np.uint8)), doffs
        b = self.bufs[key]
        return io.read_many(self.base + b.offset + byte_lo, sizes, phase=phase)

    # -- take --------------------------------------------------------------
    def take(self, rows: np.ndarray, io) -> A.Array:
        # cold random access: opaque (compressed) buffers must be re-fetched
        # per operation -- this is why compressed Arrow cannot random access
        # (paper sec 6.2)
        self._full_cache = {}
        rows = np.asarray(rows, dtype=np.int64)
        if len(rows) == 0:
            return A.from_pylist([], self.type)
        out = self._take_node(io, self.type, "c", rows, rows + 1, 0)
        io.note_useful(_array_nbytes(out))
        return out

    def _take_node(self, io, typ: T.DataType, path: str, lo: np.ndarray,
                   hi: np.ndarray, phase: int) -> A.Array:
        """Fetch the row ranges ``[lo_k, hi_k)`` of the node at ``path`` for
        all requested rows at once; ``phase`` counts the dependent round
        trips needed to learn the ranges.  Per-row spans are identical to
        the historical one-row-at-a-time reader — only the dispatch is
        batched (one ``read_many`` per buffer per level) and the extraction
        vectorized."""
        n_per = hi - lo
        n = int(n_per.sum())
        if typ.nullable:
            byte_lo = lo // 8
            byte_hi = (hi - 1) // 8 + 1  # empty ranges collapse to 0 bytes
            raw, doffs = self._read_slices(io, (path, "validity"), byte_lo,
                                           byte_hi, phase)
            bits = np.unpackbits(raw, bitorder="little")
            src = A.ragged_indices(doffs[:-1] * 8 + (lo - byte_lo * 8), n_per)
            validity = bits[src].astype(bool) if n else np.zeros(0, bool)
        else:
            validity = np.ones(n, bool)
        if isinstance(typ, (T.Primitive, T.FixedSizeList)):
            if isinstance(typ, T.Primitive):
                dt, w = np.dtype(typ.dtype), np.dtype(typ.dtype).itemsize
            else:
                dt = np.dtype(typ.child.dtype)
                w = dt.itemsize * typ.size
            raw, _ = self._read_slices(io, (path, "values"), lo * w, hi * w,
                                       phase)
            vals = np.frombuffer(raw.tobytes(), dt)
            if isinstance(typ, T.Primitive):
                return A.PrimitiveArray(typ, validity, vals[:n])
            return A.FixedSizeListArray(typ, validity,
                                        vals.reshape(n, typ.size))
        if isinstance(typ, (T.Utf8, T.Binary, T.List)):
            offs, local = self._offsets_vectors(io, path, lo, hi, phase)
            clo, chi = offs[:, 0], offs[:, 1]
            if isinstance(typ, T.List):
                child = self._take_node(io, typ.child, path + ".item", clo,
                                        chi, phase + 1)
                return A.ListArray(typ, validity, local, child)
            data, _ = self._read_slices(io, (path, "data"), clo, chi,
                                        phase + 1)
            return A.VarBinaryArray(typ, validity, local, np.asarray(data))
        if isinstance(typ, T.Struct):
            children = tuple(
                (nm, self._take_node(io, ft, path + "." + nm, lo, hi, phase))
                for nm, ft in typ.fields
            )
            return A.StructArray(typ, validity, children)
        raise TypeError(typ)  # pragma: no cover

    def _offsets_vectors(self, io, path: str, lo: np.ndarray, hi: np.ndarray,
                         phase: int):
        """Fetch each range's ``n_k + 1`` offsets in one batched dispatch.
        Returns ``(ranges, local)``: per-range ``(first, last)`` child
        bounds, plus the concatenated request-order offsets vector rebased
        so ranges chain contiguously (what ``A.concat`` built row by row)."""
        raw, doffs = self._read_slices(io, (path, "offsets"), lo * 8,
                                       (hi + 1) * 8, phase)
        all_offs = np.frombuffer(raw.tobytes(), np.int64)
        n_per = hi - lo
        first = all_offs[doffs[:-1] // 8]
        last = all_offs[doffs[1:] // 8 - 1]
        # request-order lengths: drop each range's leading offset, diff the rest
        keep = np.ones(len(all_offs), dtype=bool)
        keep[doffs[:-1] // 8] = False
        lens = all_offs[keep] - all_offs[
            np.nonzero(keep)[0] - 1] if keep.any() else np.zeros(0, np.int64)
        local = np.zeros(int(n_per.sum()) + 1, dtype=np.int64)
        np.cumsum(lens, out=local[1:])
        return np.stack([first, last], axis=1), local

    # -- scan ----------------------------------------------------------------
    def scan(self, io) -> A.Array:
        self._full_cache = {}
        arr = self._scan_node(io, self.type, "c")
        return arr

    def _scan_node(self, io, typ: T.DataType, path: str) -> A.Array:
        if typ.nullable:
            raw = self._read_full(io, (path, "validity"))
            n = self.bufs[(path, "validity")].len
            validity = np.unpackbits(raw, bitorder="little")[:n].astype(bool)
        else:
            n = None
            validity = None
        if isinstance(typ, T.Primitive):
            raw = self._read_full(io, (path, "values"))
            vals = np.frombuffer(raw.tobytes(), np.dtype(typ.dtype))
            n = self.bufs[(path, "values")].len
            vals = vals[:n]
            v = validity if validity is not None else np.ones(n, bool)
            return A.PrimitiveArray(typ, v, vals)
        if isinstance(typ, T.FixedSizeList):
            raw = self._read_full(io, (path, "values"))
            n = self.bufs[(path, "values")].len
            vals = np.frombuffer(raw.tobytes(), np.dtype(typ.child.dtype))[: n * typ.size]
            v = validity if validity is not None else np.ones(n, bool)
            return A.FixedSizeListArray(typ, v, vals.reshape(n, typ.size))
        if isinstance(typ, (T.Utf8, T.Binary)):
            offs_raw = self._read_full(io, (path, "offsets"))
            n = self.bufs[(path, "offsets")].len - 1
            offs = np.frombuffer(offs_raw.tobytes(), np.int64, count=n + 1)
            data = self._read_full(io, (path, "data"))[: int(offs[-1])]
            v = validity if validity is not None else np.ones(n, bool)
            return A.VarBinaryArray(typ, v, offs.copy(), np.asarray(data))
        if isinstance(typ, T.List):
            offs_raw = self._read_full(io, (path, "offsets"))
            n = self.bufs[(path, "offsets")].len - 1
            offs = np.frombuffer(offs_raw.tobytes(), np.int64, count=n + 1)
            child = self._scan_node(io, typ.child, path + ".item")
            v = validity if validity is not None else np.ones(n, bool)
            return A.ListArray(typ, v, offs.copy(), child)
        if isinstance(typ, T.Struct):
            children = tuple((nm, self._scan_node(io, ft, path + "." + nm)) for nm, ft in typ.fields)
            n = len(children[0][1])
            v = validity if validity is not None else np.ones(n, bool)
            return A.StructArray(typ, v, children)
        raise TypeError(typ)  # pragma: no cover


def _array_nbytes(arr: A.Array) -> int:
    if isinstance(arr, (A.PrimitiveArray, A.FixedSizeListArray)):
        return int(arr.values.nbytes)
    if isinstance(arr, A.VarBinaryArray):
        return int(arr.offsets[-1])
    if isinstance(arr, A.ListArray):
        return _array_nbytes(arr.child)
    if isinstance(arr, A.StructArray):
        return sum(_array_nbytes(c) for _, c in arr.children)
    return 0
