"""Host (numpy-backed) array model, Arrow-flavoured.

Arrays carry their logical :mod:`repro_torch.core.types` type, a validity mask
(boolean, ``True`` = valid) and type-specific buffers.  This is the in-memory
interchange representation: the structural encodings in ``miniblock.py`` /
``fullzip.py`` / ``parquet_like.py`` / ``arrow_like.py`` consume and produce
these arrays.

Validity is stored as an unpacked boolean numpy array for convenience; the
*encodings* decide how validity is physically represented (rep/def levels,
bitmaps, control words...).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from . import types as T

__all__ = [
    "Array",
    "PrimitiveArray",
    "FixedSizeListArray",
    "ListArray",
    "VarBinaryArray",
    "StructArray",
    "from_pylist",
    "to_pylist",
    "concat",
    "ragged_indices",
]


def ragged_indices(starts: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """Flat source indices of ragged segments: ``[starts[k], starts[k] +
    lengths[k])`` for every segment, concatenated.

    The one repeat/arange idiom behind every vectorized ragged gather in the
    repo (var-binary/list takes, zipped value-byte slicing, arrow span
    extraction): ``out[cum[k] + i] = starts[k] + i``.
    """
    lengths = np.asarray(lengths, dtype=np.int64)
    offs = np.zeros(len(lengths) + 1, dtype=np.int64)
    np.cumsum(lengths, out=offs[1:])
    total = int(offs[-1])
    return np.repeat(np.asarray(starts, dtype=np.int64) - offs[:-1], lengths) + np.arange(
        total, dtype=np.int64
    )


def _as_validity(validity, n: int) -> np.ndarray:
    if validity is None:
        return np.ones(n, dtype=bool)
    v = np.asarray(validity, dtype=bool)
    assert v.shape == (n,), (v.shape, n)
    return v


@dataclasses.dataclass
class Array:
    """Base class; concrete arrays define buffers."""

    type: T.DataType
    validity: np.ndarray  # bool[n], True = valid

    def __len__(self) -> int:
        return int(self.validity.shape[0])

    # Subclasses implement take/slice/equality helpers.
    def take(self, indices: np.ndarray) -> "Array":
        raise NotImplementedError

    def slice(self, start: int, stop: int) -> "Array":
        return self.take(np.arange(start, stop, dtype=np.int64))


@dataclasses.dataclass
class PrimitiveArray(Array):
    values: np.ndarray = None  # dtype matches type.dtype; garbage where invalid

    @staticmethod
    def build(values, validity=None, nullable: bool = True) -> "PrimitiveArray":
        values = np.asarray(values)
        v = _as_validity(validity, len(values))
        return PrimitiveArray(
            T.Primitive(values.dtype.name, nullable), v, values
        )

    def take(self, indices: np.ndarray) -> "PrimitiveArray":
        idx = np.asarray(indices, dtype=np.int64)
        return PrimitiveArray(self.type, self.validity[idx], self.values[idx])


@dataclasses.dataclass
class FixedSizeListArray(Array):
    # values has shape (n, size) flattened child values (child non-nullable)
    values: np.ndarray = None

    @staticmethod
    def build(values, validity=None, nullable: bool = True) -> "FixedSizeListArray":
        values = np.asarray(values)
        assert values.ndim == 2
        v = _as_validity(validity, len(values))
        child = T.Primitive(values.dtype.name, nullable=False)
        return FixedSizeListArray(
            T.FixedSizeList(child, int(values.shape[1]), nullable), v, values
        )

    def take(self, indices: np.ndarray) -> "FixedSizeListArray":
        idx = np.asarray(indices, dtype=np.int64)
        return FixedSizeListArray(self.type, self.validity[idx], self.values[idx])


@dataclasses.dataclass
class VarBinaryArray(Array):
    """Utf8 or Binary: offsets[n+1] int64 + data uint8."""

    offsets: np.ndarray = None
    data: np.ndarray = None

    @staticmethod
    def build(values: Sequence[Optional[bytes]], utf8: bool = False, nullable: bool = True) -> "VarBinaryArray":
        n = len(values)
        validity = np.array([v is not None for v in values], dtype=bool)
        lengths = np.array([0 if v is None else len(v) for v in values], dtype=np.int64)
        offsets = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(lengths, out=offsets[1:])
        data = np.frombuffer(
            b"".join(v for v in values if v is not None), dtype=np.uint8
        ).copy() if n else np.zeros(0, dtype=np.uint8)
        typ = T.Utf8(nullable) if utf8 else T.Binary(nullable)
        return VarBinaryArray(typ, validity, offsets, data)

    def value(self, i: int) -> Optional[bytes]:
        if not self.validity[i]:
            return None
        return self.data[self.offsets[i] : self.offsets[i + 1]].tobytes()

    def take(self, indices: np.ndarray) -> "VarBinaryArray":
        idx = np.asarray(indices, dtype=np.int64)
        # lengths of the taken rows only (not a diff of every row: the
        # writers take chunk by chunk, so that would be quadratic)
        starts = self.offsets[:-1][idx]
        lengths = self.offsets[1:][idx] - starts
        new_off = np.zeros(len(idx) + 1, dtype=np.int64)
        np.cumsum(lengths, out=new_off[1:])
        # one repeat/arange gather instead of a per-value copy loop
        src = ragged_indices(starts, lengths)
        out = self.data[src] if len(src) else np.zeros(0, dtype=np.uint8)
        return VarBinaryArray(self.type, self.validity[idx], new_off, out)


@dataclasses.dataclass
class ListArray(Array):
    offsets: np.ndarray = None  # int64[n+1]
    child: Array = None

    @staticmethod
    def build(child: Array, offsets, validity=None, nullable: bool = True) -> "ListArray":
        offsets = np.asarray(offsets, dtype=np.int64)
        v = _as_validity(validity, len(offsets) - 1)
        return ListArray(T.List(child.type, nullable), v, offsets, child)

    def take(self, indices: np.ndarray) -> "ListArray":
        idx = np.asarray(indices, dtype=np.int64)
        starts = self.offsets[:-1][idx]
        lengths = self.offsets[1:][idx] - starts
        new_off = np.zeros(len(idx) + 1, dtype=np.int64)
        np.cumsum(lengths, out=new_off[1:])
        child_idx = ragged_indices(starts, lengths)
        return ListArray(self.type, self.validity[idx], new_off, self.child.take(child_idx))


@dataclasses.dataclass
class StructArray(Array):
    children: tuple = ()  # tuple[(name, Array), ...]

    @staticmethod
    def build(children, validity=None, nullable: bool = True) -> "StructArray":
        children = tuple(children)
        n = len(children[0][1])
        for _, c in children:
            assert len(c) == n
        v = _as_validity(validity, n)
        typ = T.Struct(tuple((nm, c.type) for nm, c in children), nullable)
        return StructArray(typ, v, children)

    def field(self, name: str) -> Array:
        for n, c in self.children:
            if n == name:
                return c
        raise KeyError(name)

    def take(self, indices: np.ndarray) -> "StructArray":
        idx = np.asarray(indices, dtype=np.int64)
        return StructArray(
            self.type,
            self.validity[idx],
            tuple((n, c.take(idx)) for n, c in self.children),
        )


# ---------------------------------------------------------------------------
# Python interchange (used by tests & the hypothesis strategies)
# ---------------------------------------------------------------------------

def from_pylist(pyvals, typ: T.DataType) -> Array:
    """Build an Array of ``typ`` from nested python values (None = null)."""
    n = len(pyvals)
    validity = np.array([v is not None for v in pyvals], dtype=bool)
    if isinstance(typ, T.Primitive):
        dt = np.dtype(typ.dtype)
        vals = np.array([v if v is not None else 0 for v in pyvals], dtype=dt)
        return PrimitiveArray(typ, validity, vals)
    if isinstance(typ, (T.Utf8, T.Binary)):
        bs = [None if v is None else (v.encode() if isinstance(v, str) else bytes(v)) for v in pyvals]
        arr = VarBinaryArray.build(bs, utf8=isinstance(typ, T.Utf8), nullable=typ.nullable)
        return dataclasses.replace(arr, type=typ)
    if isinstance(typ, T.FixedSizeList):
        dt = np.dtype(typ.child.dtype)
        vals = np.zeros((n, typ.size), dtype=dt)
        for i, v in enumerate(pyvals):
            if v is not None:
                vals[i] = np.asarray(v, dtype=dt)
        return FixedSizeListArray(typ, validity, vals)
    if isinstance(typ, T.List):
        lengths = np.array([0 if v is None else len(v) for v in pyvals], dtype=np.int64)
        offsets = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(lengths, out=offsets[1:])
        flat = []
        for v in pyvals:
            if v is not None:
                flat.extend(v)
        child = from_pylist(flat, typ.child)
        return ListArray(typ, validity, offsets, child)
    if isinstance(typ, T.Struct):
        children = []
        for name, ftyp in typ.fields:
            fvals = [None if v is None else v.get(name) for v in pyvals]
            children.append((name, from_pylist(fvals, ftyp)))
        return StructArray(typ, validity, tuple(children))
    raise TypeError(typ)


def to_pylist(arr: Array):
    """Inverse of :func:`from_pylist` (numpy scalars converted to python)."""
    typ = arr.type
    out = []
    if isinstance(typ, T.Primitive):
        for i in range(len(arr)):
            out.append(arr.values[i].item() if arr.validity[i] else None)
        return out
    if isinstance(typ, (T.Utf8, T.Binary)):
        for i in range(len(arr)):
            v = arr.value(i)
            if v is None:
                out.append(None)
            else:
                out.append(v.decode() if isinstance(typ, T.Utf8) else v)
        return out
    if isinstance(typ, T.FixedSizeList):
        for i in range(len(arr)):
            out.append(list(arr.values[i].tolist()) if arr.validity[i] else None)
        return out
    if isinstance(typ, T.List):
        child = to_pylist(arr.child)
        for i in range(len(arr)):
            if not arr.validity[i]:
                out.append(None)
            else:
                out.append(child[arr.offsets[i] : arr.offsets[i + 1]])
        return out
    if isinstance(typ, T.Struct):
        kids = {n: to_pylist(c) for n, c in arr.children}
        for i in range(len(arr)):
            if not arr.validity[i]:
                out.append(None)
            else:
                out.append({n: kids[n][i] for n, _ in arr.children})
        return out
    raise TypeError(typ)


def concat(arrays: Sequence[Array]) -> Array:
    """Concatenate arrays of identical type (used by the scan paths)."""
    assert arrays
    if len(arrays) == 1:
        return arrays[0]
    # Cheap generic path via python interchange would be slow; implement the
    # common cases directly.
    a0 = arrays[0]
    validity = np.concatenate([a.validity for a in arrays])
    if isinstance(a0, PrimitiveArray):
        return PrimitiveArray(a0.type, validity, np.concatenate([a.values for a in arrays]))
    if isinstance(a0, FixedSizeListArray):
        return FixedSizeListArray(a0.type, validity, np.concatenate([a.values for a in arrays]))
    if isinstance(a0, VarBinaryArray):
        datas = np.concatenate([a.data for a in arrays])
        offs = [arrays[0].offsets]
        base = arrays[0].offsets[-1]
        for a in arrays[1:]:
            offs.append(a.offsets[1:] + base)
            base = base + a.offsets[-1]
        return VarBinaryArray(a0.type, validity, np.concatenate(offs), datas)
    if isinstance(a0, ListArray):
        child = concat([a.child for a in arrays])
        offs = [arrays[0].offsets]
        base = arrays[0].offsets[-1]
        for a in arrays[1:]:
            offs.append(a.offsets[1:] + base)
            base = base + a.offsets[-1]
        return ListArray(a0.type, validity, np.concatenate(offs), child)
    if isinstance(a0, StructArray):
        children = []
        for k, (name, _) in enumerate(a0.children):
            children.append((name, concat([a.children[k][1] for a in arrays])))
        return StructArray(a0.type, validity, tuple(children))
    raise TypeError(type(a0))
