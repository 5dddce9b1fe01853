"""The full-zip structural encoding (paper §4.1).

For large data types (≥128 B/value) the control word (bit-packed rep/def,
§4.1.1), the per-value length (§4.1.2) and the transparently-compressed value
bytes (§4.1.3) are zipped row-major into a single buffer.  A bit-packed
**repetition index** (§4.1.4) of row start offsets enables random access in at
most 2 IOPS regardless of nesting; fixed-width columns without repetition
need no index at all (1 IOP).  Nulls in fixed-width columns are dense filler
bytes; variable-width nulls are a control word only.  There is **no search
cache** (§4.2.4) beyond any codec dictionary/symbol table.

Random access is batched (see :meth:`FullZipReader.take`): requested rows
are deduplicated before any IO, all index reads go out as one phase-0
``read_many`` batch and all zipped spans as one phase-1 batch, the
concatenated spans are decoded in a single pass, and one permutation fans
the decoded rows back out to request order.  Per-unique-row IOPS and bytes
match the historical per-row reader exactly.

Decode is **row-parallel**, not per-value.  Variable-width entry positions
depend on embedded lengths (the paper's §6.3/Fig 17 decode cost), but the
dependency chain only runs *within* a row: ``take`` already knows every
row's ``[lo, hi)`` byte span from the repetition index, so a vectorized
numpy frontier advances one entry *per row* per step — iterations are
bounded by max-entries-per-row, not total values, and flat columns (one
entry per row) decode in a single fully-vectorized step.  ``scan`` has no
row spans (the repetition index is never read on a scan, §4.1.4) and uses
log-step pointer doubling over each bounded window instead: the
entry-successor map is built for every byte position in one vectorized
pass, then squared ``log2(entries)`` times to enumerate all entry starts.
Once entry positions are known, control words, length prefixes and value
bytes are all sliced out in one gather pass each.

Fixed-stride columns additionally have a fused device gather route
(``decode="device"``): the request-order fan-out permutation runs as one
``kernels.fullzip_gather`` launch over the unique zipped rows instead of a
host permutation.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from . import arrays as A
from . import types as T
from .compression import Encoded, get_bytes_codec, get_fixed_codec
from .encodings_base import (
    ColumnReader,
    EncodedColumn,
    empty_leaf,
    leaf_slice,
    reorder_leaf_rows,
)
from ..kernels import ops
from .rdlevels import (
    control_word_width,
    gather_le,
    level_bits,
    pack_control_words,
    unpack_control_words,
)
from .shred import ShreddedLeaf

__all__ = ["encode_fullzip", "FullZipReader"]


def _len_field_width(max_len: int) -> int:
    """Per-value length prefix, bit-packed to the nearest byte (<=8 bytes)."""
    w = max(1, (int(max_len).bit_length() + 7) // 8)
    assert w <= 8
    return w


def _le_bytes(values: np.ndarray, width: int) -> np.ndarray:
    """(n, width) little-endian byte matrix for non-negative ints."""
    v = values.astype(np.uint64)
    shifts = np.arange(width, dtype=np.uint64) * np.uint64(8)
    return ((v[:, None] >> shifts[None, :]) & np.uint64(0xFF)).astype(np.uint8)


def _from_le(mat: np.ndarray) -> np.ndarray:
    shifts = np.arange(mat.shape[1], dtype=np.uint64) * np.uint64(8)
    return (mat.astype(np.uint64) << shifts[None, :]).sum(axis=1, dtype=np.uint64)


def encode_fullzip(
    leaf: ShreddedLeaf,
    fixed_codec: str = "plain",
    bytes_codec: str = "plain_bytes",
) -> EncodedColumn:
    n = leaf.n_entries
    W = control_word_width(leaf.max_rep, leaf.max_def)
    cw = (
        pack_control_words(leaf.rep, leaf.defs, leaf.max_rep, leaf.max_def).reshape(n, W)
        if W
        else np.zeros((n, 0), dtype=np.uint8)
    )
    valid = (leaf.defs == 0) if leaf.defs is not None else np.ones(n, bool)
    n_valid = int(valid.sum())

    is_var = isinstance(leaf.leaf_type, (T.Utf8, T.Binary))
    search_cache = 0
    if is_var:
        bc = get_bytes_codec(bytes_codec)
        assert bc.transparent, "full-zip requires transparent compression (paper 4.1.3)"
        lengths = (leaf.values.offsets[1:] - leaf.values.offsets[:-1]).astype(np.uint64)
        enc = bc.encode(lengths, leaf.values.data)
        vlens = np.asarray(enc.out_lengths, dtype=np.int64)
        L = _len_field_width(int(vlens.max()) if len(vlens) else 1)
        # entry sizes: cw + (len field + bytes) for valid; cw only for null
        sizes = np.full(n, W, dtype=np.int64)
        sizes[valid] += L + vlens
        offs = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(sizes, out=offs[1:])
        out = np.zeros(int(offs[-1]), dtype=np.uint8)
        for b in range(W):
            out[offs[:-1] + b] = cw[:, b]
        vpos = offs[:-1][valid] + W
        lmat = _le_bytes(vlens.astype(np.uint64), L)
        for b in range(L):
            out[vpos + b] = lmat[:, b]
        # scatter value bytes
        out[A.ragged_indices(vpos + L, vlens)] = enc.data
        codec_meta = {k: v for k, v in enc.meta.items()}
        if "syms" in codec_meta:
            search_cache += sum(len(s) + 2 for s in codec_meta["syms"])
        vw = None
    else:
        fc = get_fixed_codec(fixed_codec)
        assert fc.transparent
        if isinstance(leaf.leaf_type, T.FixedSizeList):
            enc = fc.encode(leaf.values.values.reshape(-1))
            elem_w = fc.encoded_width(enc)
            assert elem_w is not None, "full-zip fixed path needs byte-aligned codec"
            vw = elem_w * leaf.leaf_type.size
        else:
            enc = fc.encode(leaf.values.values)
            vw = fc.encoded_width(enc)
            assert vw is not None, "full-zip fixed path needs byte-aligned codec"
        L = 0
        stride = W + vw
        out = np.zeros(n * stride, dtype=np.uint8)
        view = out.reshape(n, stride)
        if W:
            view[:, :W] = cw
        # dense: filler zeros where invalid (paper 4.1.3)
        vmat = enc.data.reshape(n_valid, vw) if n_valid else np.zeros((0, vw), np.uint8)
        view[valid, W:] = vmat
        codec_meta = enc.meta
        if "dict" in codec_meta:
            search_cache += int(np.asarray(codec_meta["dict"]).nbytes)
        offs = (np.arange(n + 1, dtype=np.int64) * stride)

    # repetition index: row start byte offsets (+ total), needed when rows
    # are not fixed-stride addressable
    has_rep_index = leaf.max_rep > 0 or is_var
    if leaf.max_rep > 0:
        row_start_mask = leaf.rep == leaf.max_rep
    else:
        row_start_mask = np.ones(n, dtype=bool)
    if has_rep_index:
        row_offsets = np.concatenate([offs[:-1][row_start_mask], offs[-1:]])
        R = _len_field_width(int(offs[-1]) if n else 1)
        ri_bytes = _le_bytes(row_offsets.astype(np.uint64), R).reshape(-1)
        payload = ri_bytes.tobytes() + out.tobytes()
        zip_base = len(ri_bytes)
    else:
        R = 0
        payload = out.tobytes()
        zip_base = 0

    meta = {
        "encoding": "fullzip",
        "W": W,
        "L": L,
        "vw": vw,
        "R": R,
        "zip_base": zip_base,
        "zip_bytes": int(offs[-1]),
        "n_rows": leaf.n_rows,
        "n_entries": n,
        "has_rep_index": has_rep_index,
        "fixed_codec": fixed_codec,
        "bytes_codec": bytes_codec,
        "codec_meta": codec_meta,
    }
    return EncodedColumn("fullzip", payload, meta, search_cache)


class FullZipReader(ColumnReader):
    """Full-zip random access + scan with row-parallel decode.

    ``decode`` selects the fixed-stride take's fan-out route: ``"numpy"``
    (host :func:`reorder_leaf_rows` permutation) or ``"device"`` (one
    ``kernels.fullzip_gather`` launch over the unique zipped rows on
    ``device``).  The logical IO trace is identical either way.
    """

    _DECODE_WINDOW = 1 << 20  # chain-discovery sub-window (see scan)

    def __init__(self, meta: Dict, base: int, leaf_proto: ShreddedLeaf,
                 decode: str = "numpy", device=None):
        super().__init__(meta, base, leaf_proto)
        if decode not in ("numpy", "device"):
            raise ValueError(f"decode must be 'numpy'|'device', got {decode!r}")
        self.decode = decode
        self.device = device

    # -- fixed-stride decode -------------------------------------------
    def _decode_fixed(self, raw: np.ndarray):
        """Strided decode of ``[control word | value bytes]`` entries."""
        m = self.meta
        W, vw = m["W"], m["vw"]
        max_rep, max_def = self.proto.max_rep, self.proto.max_def
        stride = W + vw
        n = len(raw) // stride
        mat = raw[: n * stride].reshape(n, stride)
        rep, defs = (
            unpack_control_words(mat[:, :W].reshape(-1), n, max_rep, max_def)
            if W
            else (None, None)
        )
        valid = (defs == 0) if defs is not None else np.ones(n, bool)
        vbytes = mat[valid, W:].reshape(-1)
        fc = get_fixed_codec(m["fixed_codec"])
        enc = Encoded(vbytes, m["codec_meta"])
        n_valid = int(valid.sum())
        if isinstance(self.proto.leaf_type, T.FixedSizeList):
            size = self.proto.leaf_type.size
            flat = fc.decode(enc, n_valid * size)
            vals = A.FixedSizeListArray(
                self.proto.leaf_type.with_nullable(False),
                np.ones(n_valid, bool),
                np.asarray(flat).reshape(n_valid, size),
            )
        else:
            vals = A.PrimitiveArray(
                self.proto.leaf_type.with_nullable(False),
                np.ones(n_valid, bool),
                np.asarray(fc.decode(enc, n_valid)),
            )
        return rep, defs, vals

    # -- variable-width entry discovery --------------------------------
    def _advance_at(self, raw: np.ndarray, pos: np.ndarray):
        """Vectorized entry-size probe: for control words at byte positions
        ``pos`` return ``(advance, valid, vlen)``.  Reads past the buffer
        end return garbage (clipped gathers); callers bound ``pos`` so only
        lanes whose header truly fits are trusted."""
        m = self.meta
        W, L = m["W"], m["L"]
        db = level_bits(self.proto.max_def)
        if W and db:
            word = gather_le(raw, pos, W)
            valid = (word & np.uint64((1 << db) - 1)) == 0
        else:
            valid = np.ones(len(pos), dtype=bool)
        vlen = np.where(valid, gather_le(raw, pos + W, L), 0).astype(np.int64)
        adv = W + np.where(valid, L + vlen, 0)
        return adv, valid, vlen

    def _entry_starts_rows(self, raw: np.ndarray, seg_offs: np.ndarray) -> np.ndarray:
        """Row-parallel frontier walk: ``seg_offs`` are the ``n_seg + 1``
        byte bounds of independent row segments inside ``raw``.  One
        frontier position per row advances one entry per vectorized step, so
        steps are bounded by max-entries-per-row; flat columns finish in one
        step.  Returns every entry's control-word position in buffer order.
        """
        pos = seg_offs[:-1].astype(np.int64).copy()
        ends = seg_offs[1:].astype(np.int64)
        n_seg = len(pos)
        active = np.nonzero(pos < ends)[0]
        pos_steps: List[np.ndarray] = []
        row_steps: List[np.ndarray] = []
        while len(active):
            cur = pos[active]
            pos_steps.append(cur)
            row_steps.append(active)
            adv, _, _ = self._advance_at(raw, cur)
            pos[active] = cur + adv
            active = active[pos[active] < ends[active]]
        if not pos_steps:
            return np.zeros(0, dtype=np.int64)
        # entries were emitted step-major; rebuild buffer (row-major) order
        # with one direct index computation: entry s of row r lands at
        # row_entry_offset[r] + s
        rows_cat = np.concatenate(row_steps)
        per_row = np.bincount(rows_cat, minlength=n_seg)
        row_off = np.zeros(n_seg + 1, dtype=np.int64)
        np.cumsum(per_row, out=row_off[1:])
        out = np.zeros(len(rows_cat), dtype=np.int64)
        for s, (rws, ps) in enumerate(zip(row_steps, pos_steps)):
            out[row_off[rws] + s] = ps
        return out

    def _entry_starts_chain(self, raw: np.ndarray, limit: int) -> Tuple[np.ndarray, int]:
        """Pointer-doubling entry discovery for a buffer with no known row
        bounds (the scan path).  Builds the entry-successor map for every
        byte position in one vectorized pass, then squares it
        ``log2(entries)`` times to enumerate up to ``limit`` *complete*
        entry starts.  Returns ``(entry_positions, consumed_bytes)`` —
        ``consumed_bytes`` stops before a trailing partial entry, so scan
        windows can carry the tail into the next window."""
        total = len(raw)
        if total == 0 or limit <= 0:
            return np.zeros(0, dtype=np.int64), 0
        m = self.meta
        W, L = m["W"], m["L"]
        db = level_bits(self.proto.max_def)
        # successor map for every byte position, built from shifted views of
        # a zero-padded copy (the contiguous domain needs no gathers; zero
        # padding makes a truncated length prefix read as >= 0, so the
        # end-fits test below covers header truncation too)
        pad = np.zeros(total + W + L, dtype=np.uint8)
        pad[:total] = raw
        if W and db:
            if W == 1:
                valid = (pad[:total] & np.uint8((1 << db) - 1)) == 0
            else:
                word = pad[:total].astype(np.uint32)
                for b in range(1, W):
                    word |= pad[b : b + total].astype(np.uint32) << np.uint32(8 * b)
                valid = (word & np.uint32((1 << db) - 1)) == 0
        else:
            valid = None  # no null entries: every entry carries a value
        vlen = pad[W : W + total].astype(np.intp) if L else np.zeros(total, np.intp)
        for b in range(1, L):
            vlen |= pad[W + b : W + b + total].astype(np.intp) << np.intp(8 * b)
        # `end`: one-entry-advanced position for every byte position
        end = vlen + np.intp(W + L) if valid is None else np.where(
            valid, vlen + np.intp(W + L), np.intp(W))
        end += np.arange(total, dtype=np.intp)
        # intp successor map: np.take squares it without index-dtype casts;
        # an entry whose end overruns the buffer is incomplete -> sentinel
        nxt = np.empty(total + 1, dtype=np.intp)
        np.minimum(end, total, out=nxt[:total])
        nxt[total] = total
        # capped pointer doubling: square the jump table (O(total) each) only
        # until it spans WAVE entries, then enumerate in O(WAVE)-sized waves
        WAVE = 4096
        parts = [np.zeros(1, dtype=np.intp)]  # the chain starts at offset 0
        lastk = parts[0]
        count = 1
        jump, span = nxt, 1
        scratch = np.empty_like(nxt)
        while count < limit and lastk[-1] < total:
            new = np.take(jump, lastk[-span:])
            parts.append(new)
            count += len(new)
            lastk = np.concatenate([lastk, new])[-WAVE:]
            if span < WAVE and span * 2 <= count:
                np.take(jump, jump, out=scratch, mode="clip")
                jump, scratch = scratch, jump
                span *= 2
        known = np.concatenate(parts)
        starts = known[known < total][:limit].astype(np.int64, copy=False)
        # only entries that are themselves complete count; the chain stops
        # advancing at the first incomplete one by construction of `nxt`
        starts = starts[end[starts] <= total]
        consumed = int(end[starts[-1]]) if len(starts) else 0
        return starts, consumed

    # -- variable-width decode -----------------------------------------
    def _decode_var_at(self, raw: np.ndarray, entry_pos: np.ndarray):
        """Decode all entries whose control words sit at ``entry_pos`` in
        one vectorized pass: control-word gather, length-prefix gather, and
        a single repeat/arange value-byte gather."""
        m = self.meta
        W, L = m["W"], m["L"]
        max_rep, max_def = self.proto.max_rep, self.proto.max_def
        n = len(entry_pos)
        if W:
            wb = raw[
                np.minimum(entry_pos[:, None] + np.arange(W, dtype=np.int64),
                           max(len(raw) - 1, 0))
            ]
            rep, defs = unpack_control_words(wb.reshape(-1), n, max_rep, max_def)
        else:
            rep, defs = None, None
        valid = (defs == 0) if defs is not None else np.ones(n, bool)
        vpos = entry_pos[valid] + W
        vlens = gather_le(raw, vpos, L).astype(np.int64)
        src = A.ragged_indices(vpos + L, vlens)
        blob = raw[src] if len(src) else np.zeros(0, np.uint8)
        bc = get_bytes_codec(m["bytes_codec"])
        out_lens, out_data = bc.decode(Encoded(blob, m["codec_meta"]), vlens)
        offsets = np.zeros(len(out_lens) + 1, dtype=np.int64)
        np.cumsum(out_lens, out=offsets[1:])
        vals = A.VarBinaryArray(
            self.proto.leaf_type.with_nullable(False),
            np.ones(len(out_lens), bool),
            offsets,
            out_data,
        )
        return rep, defs, vals

    # ------------------------------------------------------------------
    def _decode_entries(self, raw: np.ndarray, n_hint: Optional[int] = None,
                        seg_offs: Optional[np.ndarray] = None):
        """Zipped bytes -> ``(rep, defs, values)``.  Fixed-width entries are
        strided; variable-width entries are located row-parallel (frontier
        over ``seg_offs`` row bounds when given, pointer doubling otherwise)
        and then decoded in one vectorized pass."""
        if self.meta["vw"] is not None:
            return self._decode_fixed(raw)
        if seg_offs is not None:
            entry_pos = self._entry_starts_rows(raw, seg_offs)
        else:
            limit = n_hint if n_hint is not None else len(raw)
            entry_pos, _ = self._entry_starts_chain(raw, limit)
        return self._decode_var_at(raw, entry_pos)

    # ------------------------------------------------------------------
    def take(self, rows: np.ndarray, io) -> ShreddedLeaf:
        """Batched random access: rows are deduplicated before IO, every
        span is fetched in one phase-grouped ``read_many`` dispatch (index
        reads in phase 0, zipped spans in phase 1), all rows are decoded
        simultaneously (strided for fixed entries, row-parallel frontier for
        variable), and the decoded rows are fanned back out to request
        order (duplicates materialized by the final permutation — a host
        permutation, or one device gather under ``decode='device'`` —
        never re-read)."""
        rows = np.asarray(rows, dtype=np.int64)
        m = self.meta
        if len(rows) == 0:
            return empty_leaf(self.proto)
        urows, inv = np.unique(rows, return_inverse=True)
        if urows[0] < 0 or urows[-1] >= m["n_rows"]:
            raise IndexError(
                f"take rows out of bounds for {m['n_rows']}-row column"
            )
        n_unique = len(urows)
        if not m["has_rep_index"]:
            stride = m["W"] + m["vw"]
            data, _ = io.read_many(
                self.base + urows * stride,
                np.full(n_unique, stride, dtype=np.int64), phase=0)
            # useful bytes over *unique* rows: duplicates are fanned out from
            # the decoded result, never re-read, so amplification stays >= 1
            io.note_useful(stride * n_unique)
            if self.decode == "device":
                return self._take_fixed_device(data, n_unique, stride, inv)
            rep, defs, vals = self._decode_fixed(data)
        else:
            if self.decode == "device":
                # the rep-indexed path decodes variable-stride entries on the
                # host frontier; the fused gather kernel needs fixed strides
                ops.note_fallback("fullzip", "variable-stride",
                                  getattr(io, "tracer", None),
                                  n_rows=int(n_unique))
            R = m["R"]
            # one IOP per row covers both adjacent index entries (start & end)
            idx, _ = io.read_many(
                self.base + urows * R,
                np.full(n_unique, 2 * R, dtype=np.int64), phase=0)
            mat = idx.reshape(n_unique, 2 * R)
            lo = _from_le(mat[:, :R]).astype(np.int64)
            hi = _from_le(mat[:, R:]).astype(np.int64)
            data, _ = io.read_many(self.base + m["zip_base"] + lo, hi - lo,
                                   phase=1)
            # the fetched [lo, hi) spans are the row bounds: decode all rows
            # in lockstep instead of walking the concatenation per value
            seg_offs = np.zeros(n_unique + 1, dtype=np.int64)
            np.cumsum(hi - lo, out=seg_offs[1:])
            rep, defs, vals = self._decode_entries(data, seg_offs=seg_offs)
            io.note_useful(int((hi - lo).sum()))
        dec = leaf_slice(self.proto, rep, defs, vals, n_unique)
        return reorder_leaf_rows(dec, inv)

    def _take_fixed_device(self, data: np.ndarray, n_unique: int, stride: int,
                           inv: np.ndarray) -> ShreddedLeaf:
        """Fused gather route: one ``fullzip_gather`` launch fans the unique
        zipped rows out to request order on the device, then the
        request-order matrix is decoded strided — bit-identical to the host
        ``reorder_leaf_rows`` permutation (fixed-stride entries are rows)."""
        zipped = np.ascontiguousarray(data[: n_unique * stride]).reshape(
            n_unique, stride)
        gathered = ops.to_host(ops.fullzip_gather(
            ops.to_device(zipped, self.device),
            ops.to_device(inv.astype(np.int32), self.device)))
        rep, defs, vals = self._decode_fixed(gathered.reshape(-1))
        return leaf_slice(self.proto, rep, defs, vals, len(inv))

    def scan(self, io, io_chunk: int = 8 << 20) -> ShreddedLeaf:
        """Full scan in bounded-memory windows: each ``io_chunk`` window is
        read and decoded at entry boundaries (pointer-doubling entry
        discovery; the partial-entry tail is carried into the next window),
        so peak raw-buffer RSS is O(window) instead of O(column).  The
        logical IO trace is unchanged — the repetition index is never read
        on a full scan (paper 4.1.4)."""
        m = self.meta
        total = m["zip_bytes"]
        remaining = m["n_entries"]
        fixed_stride = None if m["vw"] is None else m["W"] + m["vw"]
        tail = np.zeros(0, dtype=np.uint8)
        reps, dfs, vals = [], [], []
        for p in range(0, total, io_chunk):
            part = io.read(self.base + m["zip_base"] + p,
                           min(io_chunk, total - p), phase=0)
            window = np.concatenate([tail, part]) if len(tail) else part
            if fixed_stride is not None:
                n_here = min(len(window) // fixed_stride, remaining)
                consumed = n_here * fixed_stride
                if n_here:
                    r, d, v = self._decode_fixed(window[:consumed])
                    reps.append(r)
                    dfs.append(d)
                    vals.append(v)
                    remaining -= n_here
            else:
                # decode in sub-windows so the chain's per-byte successor
                # arrays (~34 B/byte transiently) are bounded by
                # _DECODE_WINDOW, not io_chunk; the cap widens only when a
                # single entry outgrows it
                consumed = 0
                cap = self._DECODE_WINDOW
                while consumed < len(window):
                    sub = window[consumed: consumed + cap]
                    entry_pos, used = self._entry_starts_chain(sub, remaining)
                    if not len(entry_pos):
                        if len(sub) < len(window) - consumed:
                            cap *= 2  # entry larger than the sub-window
                            continue
                        break  # partial entry: need the next io window
                    r, d, v = self._decode_var_at(sub, entry_pos)
                    reps.append(r)
                    dfs.append(d)
                    vals.append(v)
                    remaining -= len(entry_pos)
                    consumed += used
                    cap = self._DECODE_WINDOW
            tail = window[consumed:]
        if not vals:
            rep, defs, vls = self._decode_entries(
                np.zeros(0, np.uint8), n_hint=m["n_entries"])
            return leaf_slice(self.proto, rep, defs, vls, m["n_rows"])
        rep = np.concatenate(reps) if reps[0] is not None else None
        defs = np.concatenate(dfs) if dfs[0] is not None else None
        return leaf_slice(self.proto, rep, defs, A.concat(vals), m["n_rows"])
