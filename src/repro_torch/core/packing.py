"""Struct packing (paper §4.3).

A packed struct stores all fields of a struct in one column: each child is
compressed *individually* (vectorized columnar compression), then the
compressed child values are zipped row-major.  Random access fetches every
field of a row in one IOP; projecting a single field during a scan must read
(and discard) the whole struct — the trade-off measured in Fig. 18.

Fixed-width structs (all children fixed width) produce a fixed row stride:
``[validity byte?][f0 bytes][f1 bytes]...``.  If any child is variable width
the whole struct becomes variable width with a repetition-index-style row
offset table (the paper's 'packing the entire record' row-format extreme).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from . import arrays as A
from . import types as T
from .compression import Encoded, get_fixed_codec
from .encodings_base import EncodedColumn

__all__ = ["encode_packed_struct", "PackedStructReader"]


def encode_packed_struct(arr: A.StructArray, fixed_codec: str = "plain") -> EncodedColumn:
    n = len(arr)
    child_meta: List[Dict] = []
    mats: List[np.ndarray] = []
    has_validity = arr.type.nullable or any(c.type.nullable for _, c in arr.children)
    if has_validity:
        vbyte = arr.validity.astype(np.uint8)
        bit = 1
        for _, c in arr.children:
            if c.type.nullable:
                vbyte = vbyte | (c.validity.astype(np.uint8) << bit)
                bit += 1
            if bit > 7:
                raise ValueError("packed struct supports <= 7 nullable children")
        mats.append(vbyte.reshape(n, 1))
        child_meta.append({"name": "__validity__", "width": 1})
    for name, c in arr.children:
        fc = get_fixed_codec("plain" if (not hasattr(c, "values") or c.values.dtype.kind == "f") else fixed_codec)
        if isinstance(c, (A.PrimitiveArray, A.FixedSizeListArray)):
            enc = fc.encode(c.values)
            w = fc.encoded_width(enc)
            if w is None:
                raise ValueError("packed struct children need transparent fixed codecs")
            mats.append(enc.data.reshape(n, w))
            child_meta.append({"name": name, "width": w, "codec": fc.name, "codec_meta": enc.meta})
        else:
            raise NotImplementedError("variable-width packed structs: pack at file level")
    stride = sum(m.shape[1] for m in mats)
    out = np.concatenate(mats, axis=1) if mats else np.zeros((n, 0), np.uint8)
    meta = {
        "encoding": "packed_struct",
        "stride": stride,
        "n_rows": n,
        "children": child_meta,
        "has_validity": has_validity,
    }
    return EncodedColumn("packed_struct", np.ascontiguousarray(out).tobytes(), meta, 0)


class PackedStructReader:
    def __init__(self, meta: Dict, base: int, typ: T.Struct):
        self.meta = meta
        self.base = base
        self.type = typ

    def _decode_rows(self, raw: np.ndarray, n: int, fields=None) -> A.StructArray:
        mat = raw[: n * self.meta["stride"]].reshape(n, self.meta["stride"])
        pos = 0
        validity = np.ones(n, bool)
        child_validity: Dict[str, np.ndarray] = {}
        children = []
        bit = 1
        for cm in self.meta["children"]:
            w = cm["width"]
            block = mat[:, pos : pos + w]
            pos += w
            if cm["name"] == "__validity__":
                vb = block[:, 0]
                if self.type.nullable:
                    validity = (vb & 1).astype(bool)
                for fname, ft in self.type.fields:
                    if ft.nullable:
                        child_validity[fname] = ((vb >> bit) & 1).astype(bool)
                        bit += 1
                continue
            if fields is not None and cm["name"] not in fields:
                continue
            ft = self.type.field(cm["name"])
            fc = get_fixed_codec(cm["codec"])
            flat = fc.decode(Encoded(np.ascontiguousarray(block).reshape(-1), cm["codec_meta"]), n)
            cv = child_validity.get(cm["name"], np.ones(n, bool))
            if isinstance(ft, T.FixedSizeList):
                children.append((cm["name"], A.FixedSizeListArray(ft, cv, np.asarray(flat).reshape(n, ft.size))))
            else:
                children.append((cm["name"], A.PrimitiveArray(ft, cv, np.asarray(flat))))
        typ = self.type if fields is None else T.Struct(
            tuple((nm, ft) for nm, ft in self.type.fields if nm in fields), self.type.nullable
        )
        return A.StructArray(typ, validity, tuple(children))

    def take(self, rows: np.ndarray, io) -> A.StructArray:
        """Batched random access: unique rows are fetched in one phase-0
        ``read_many`` dispatch, decoded in a single pass, and gathered back
        to request order (duplicates never re-read)."""
        rows = np.asarray(rows, dtype=np.int64)
        stride = self.meta["stride"]
        if len(rows) == 0:
            return self._decode_rows(np.zeros(0, np.uint8), 0)
        urows, inv = np.unique(rows, return_inverse=True)
        if urows[0] < 0 or urows[-1] >= self.meta["n_rows"]:
            raise IndexError(
                f"take rows out of bounds for {self.meta['n_rows']}-row column"
            )
        data, _ = io.read_many(
            self.base + urows * stride,
            np.full(len(urows), stride, dtype=np.int64), phase=0)
        # useful bytes over *unique* rows (duplicates are never re-read)
        io.note_useful(stride * len(urows))
        return self._decode_rows(data, len(urows)).take(inv)

    def scan(self, io, fields=None, io_chunk: int = 8 << 20) -> A.StructArray:
        n = self.meta["n_rows"]
        total = n * self.meta["stride"]
        parts = []
        for p in range(0, total, io_chunk):
            parts.append(io.read(self.base + p, min(io_chunk, total - p), phase=0))
        raw = np.concatenate(parts) if parts else np.zeros(0, np.uint8)
        return self._decode_rows(raw, n, fields=fields)
