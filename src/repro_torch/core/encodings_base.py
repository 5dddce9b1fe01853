"""Shared interface for structural encodings.

A structural encoding turns one :class:`~repro_torch.core.shred.ShreddedLeaf` (or,
for the Arrow-style baseline, the original nested array) into a contiguous
byte payload ("column chunk" / Lance "disk page") plus metadata.  Readers
issue every read through the :class:`~repro_torch.store.ReadBatch` handle the file
layer passes to ``take``/``scan``, so the batched IO scheduler owns
coalescing, tier classification and exact IOPS / read-amplification
accounting.

Readers return leaf *slices* as ``(rep, defs, values)`` aligned entry streams
for the requested rows; ``repro_torch.core.shred.unshred`` turns those back into
nested arrays at the file layer.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

from . import arrays as A
from . import types as T
from .shred import ShreddedLeaf

__all__ = [
    "EncodedColumn",
    "ColumnReader",
    "align8",
    "pad_to",
    "leaf_slice",
    "avg_value_bytes",
    "reorder_leaf_rows",
    "concat_leaves",
    "empty_leaf",
    "empty_values",
    "value_bytes",
]


def align8(n: int) -> int:
    return (n + 7) & ~7


def pad_to(buf: bytes, align: int = 8) -> bytes:
    pad = (-len(buf)) % align
    return buf + b"\x00" * pad


@dataclasses.dataclass
class EncodedColumn:
    """Result of encoding one leaf column."""

    encoding: str
    payload: bytes  # contiguous bytes written to the data section
    meta: Dict  # column metadata (written to the footer)
    # RAM-resident bytes needed for warm random access (the paper's "search
    # cache"; sec. 2.3).  0.1% of data size is the stated goal.
    search_cache_bytes: int


class ColumnReader:
    """Random access + scan against an encoded column.

    ``base`` is the payload's offset inside the file; all reads go through
    the ``io`` handle (a :class:`~repro_torch.store.ReadBatch`) supplied per
    operation by the file layer.
    """

    def __init__(self, meta: Dict, base: int, leaf_proto: ShreddedLeaf):
        self.meta = meta
        self.base = base
        self.proto = leaf_proto  # carries path/type_path/max levels, no data

    def take(self, rows: np.ndarray, io) -> ShreddedLeaf:
        raise NotImplementedError

    def scan(self, io) -> ShreddedLeaf:
        raise NotImplementedError


def leaf_slice(proto: ShreddedLeaf, rep, defs, values: A.Array, n_rows: int) -> ShreddedLeaf:
    """Build a ShreddedLeaf result with the prototype's static fields."""
    n = len(rep) if rep is not None else (len(defs) if defs is not None else len(values))
    return ShreddedLeaf(
        path=proto.path,
        type_path=proto.type_path,
        leaf_type=proto.leaf_type,
        rep=rep,
        defs=defs,
        values=values,
        n_entries=n,
        max_rep=proto.max_rep,
        max_def=proto.max_def,
        def_meanings=proto.def_meanings,
        null_item_code=proto.null_item_code,
        n_rows=n_rows,
    )


def avg_value_bytes(leaf: ShreddedLeaf) -> float:
    """Average bytes per leaf value — drives the adaptive encoding choice."""
    vals = leaf.values
    if isinstance(vals, A.VarBinaryArray):
        n = max(1, len(vals))
        return float(vals.offsets[-1]) / n
    if isinstance(vals, A.FixedSizeListArray):
        return float(vals.values.dtype.itemsize * vals.values.shape[1])
    return float(vals.values.dtype.itemsize)


def row_starts_from_rep(rep: Optional[np.ndarray], max_rep: int, n_entries: int) -> np.ndarray:
    """Boolean mask of entries that begin a new top-level row."""
    if max_rep == 0 or rep is None:
        return np.ones(n_entries, dtype=bool)
    return rep == max_rep


def reorder_leaf_rows(leaf: ShreddedLeaf, order: np.ndarray) -> ShreddedLeaf:
    """Gather a leaf's rows at ``order`` (any order, duplicates allowed).

    The take pipelines decode each needed row exactly once; this single
    segment-id permutation then fans the decoded rows back out to the request
    order.  Everything is one stable argsort-free pass: per-row entry spans
    come from one cumsum over row starts, the entry permutation from one
    ``np.repeat``/``arange`` expansion, and the (sparse) value gather from
    one cumsum over the validity mask — O(entries + output entries) total.
    """
    order = np.asarray(order, dtype=np.int64)
    starts = row_starts_from_rep(leaf.rep, leaf.max_rep, leaf.n_entries)
    seg = np.cumsum(starts) - 1
    n_src = int(seg[-1]) + 1 if len(seg) else 0
    row_lens = np.bincount(seg, minlength=n_src).astype(np.int64) if n_src else np.zeros(0, np.int64)
    row_offs = np.zeros(n_src + 1, dtype=np.int64)
    np.cumsum(row_lens, out=row_offs[1:])
    out_lens = row_lens[order]
    out_offs = np.zeros(len(order) + 1, dtype=np.int64)
    np.cumsum(out_lens, out=out_offs[1:])
    total = int(out_offs[-1])
    perm = np.repeat(row_offs[order] - out_offs[:-1], out_lens) + np.arange(
        total, dtype=np.int64
    )
    rep = leaf.rep[perm] if leaf.rep is not None else None
    defs = leaf.defs[perm] if leaf.defs is not None else None
    vmask = (leaf.defs == 0) if leaf.defs is not None else np.ones(leaf.n_entries, bool)
    vslot = np.cumsum(vmask) - 1
    sel = perm[vmask[perm]]
    vals = leaf.values.take(vslot[sel])
    return leaf_slice(leaf, rep, defs, vals, len(order))


def concat_leaves(leaves) -> ShreddedLeaf:
    """Concatenate leaf slices of one schema leaf, row-wise.

    The dataset layer takes each fragment's rows independently and stitches
    the per-fragment results back together before the final request-order
    permutation (:func:`reorder_leaf_rows`); rep/def streams and sparse
    values concatenate directly because every slice carries complete rows.
    """
    if len(leaves) == 1:
        return leaves[0]
    l0 = leaves[0]
    rep = (np.concatenate([l.rep for l in leaves])
           if l0.rep is not None else None)
    defs = (np.concatenate([l.defs for l in leaves])
            if l0.defs is not None else None)
    vals = A.concat([l.values for l in leaves])
    return leaf_slice(l0, rep, defs, vals, sum(l.n_rows for l in leaves))


def empty_leaf(proto: ShreddedLeaf) -> ShreddedLeaf:
    """A zero-row leaf slice with the prototype's static fields."""
    return leaf_slice(
        proto,
        np.zeros(0, np.uint8) if proto.max_rep > 0 else None,
        np.zeros(0, np.uint8) if proto.max_def > 0 else None,
        empty_values(proto.leaf_type), 0)


def empty_values(leaf_type: T.DataType) -> A.Array:
    """A zero-length values array of ``leaf_type`` (non-nullable)."""
    if isinstance(leaf_type, (T.Utf8, T.Binary)):
        return A.VarBinaryArray(
            leaf_type.with_nullable(False), np.ones(0, bool),
            np.zeros(1, np.int64), np.zeros(0, np.uint8)
        )
    if isinstance(leaf_type, T.FixedSizeList):
        return A.FixedSizeListArray(
            leaf_type.with_nullable(False),
            np.ones(0, bool),
            np.zeros((0, leaf_type.size), dtype=np.dtype(leaf_type.child.dtype)),
        )
    return A.PrimitiveArray(
        leaf_type.with_nullable(False), np.ones(0, bool),
        np.zeros(0, np.dtype(leaf_type.dtype))
    )


def value_bytes(vals: A.Array) -> int:
    """Payload bytes of a values array (the take paths' useful-bytes unit)."""
    if isinstance(vals, A.VarBinaryArray):
        return int(len(vals.data))
    return int(vals.values.nbytes)
