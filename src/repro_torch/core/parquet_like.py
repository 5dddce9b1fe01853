"""Parquet-style structural encoding (paper §3.1) — the primary baseline.

Leaf columns are stored as a sequence of **pages**; each page holds the
repetition levels, definition levels, and sparsely-stored values for a run of
complete top-level rows (Parquet pages begin on record boundaries).  A **page
offset index** — (offset, size, first row) per page — is the search cache
(20 in-memory bytes per page, the parquet-rs figure from §4.2.4); binary
search maps a row to exactly one page, so random access costs one IOP with
page-sized read amplification.

Dictionary encoding is modelled faithfully: the dictionary is a page at the
start of the column chunk, and a cold reader must fetch + decode it on every
take (the paper's "2% of ideal" pathology, §6.1.1) unless ``dict_cached``
(Lance-style search-cache placement) is set.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional

import numpy as np

from . import arrays as A
from .compression import bitpack, bitunpack, min_bits
from .encodings_base import (
    ColumnReader,
    EncodedColumn,
    empty_leaf,
    empty_values,
    leaf_slice,
    pad_to,
    reorder_leaf_rows,
    value_bytes,
)
from .miniblock import _decode_chunk_values, _encode_chunk_values
from .rdlevels import pack_levels, unpack_levels
from .shred import ShreddedLeaf

__all__ = ["encode_parquet", "ParquetReader", "PAGE_INDEX_BYTES_PER_PAGE"]

PAGE_INDEX_BYTES_PER_PAGE = 20  # parquet-rs in-memory page index entry


def encode_parquet(
    leaf: ShreddedLeaf,
    page_bytes: int = 8 * 1024,
    fixed_codec: Optional[str] = None,
    bytes_codec: str = "zstd_chunk",
    dict_encode: bool = False,
) -> EncodedColumn:
    n = leaf.n_entries
    valid_mask = (leaf.defs == 0) if leaf.defs is not None else np.ones(n, bool)
    value_slot = np.cumsum(valid_mask) - 1
    if leaf.max_rep > 0:
        row_start = leaf.rep == leaf.max_rep
    else:
        row_start = np.ones(n, dtype=bool)
    row_start_pos = np.nonzero(row_start)[0]
    n_rows = len(row_start_pos)

    # ---- optional dictionary over the whole column chunk -------------
    dict_page = b""
    dict_meta: Dict = {}
    codes = None
    if dict_encode:
        vals = leaf.values
        if isinstance(vals, A.VarBinaryArray):
            lens = vals.offsets[1:] - vals.offsets[:-1]
            keys = [vals.data[vals.offsets[i]: vals.offsets[i + 1]].tobytes() for i in range(len(vals))]
            uniq, codes = np.unique(np.array(keys, dtype=object), return_inverse=True)
            u_lens = np.array([len(u) for u in uniq], dtype=np.uint64)
            u_data = np.frombuffer(b"".join(uniq), dtype=np.uint8) if len(uniq) else np.zeros(0, np.uint8)
            lb = bitpack(u_lens, min_bits(u_lens))
            dict_page = pad_to(struct.pack("<II", len(uniq), len(lb))) + pad_to(lb.tobytes()) + pad_to(u_data.tobytes())
            dict_meta = {"kind": "var", "n": int(len(uniq)), "lbits": min_bits(u_lens)}
        else:
            flat = vals.values.reshape(len(vals), -1) if vals.values.ndim > 1 else vals.values
            uniq, codes = np.unique(flat, axis=0, return_inverse=True)
            dict_page = pad_to(np.ascontiguousarray(uniq).tobytes())
            dict_meta = {"kind": "fixed", "n": int(len(uniq)), "dtype": vals.values.dtype.name,
                         "shape1": 0 if vals.values.ndim == 1 else vals.values.shape[1]}
        codes = codes.astype(np.uint64)
        dict_meta["cbits"] = min_bits(codes)

    # ---- paginate on row boundaries -----------------------------------
    # estimate rows per page from average entry footprint
    pages: List[bytes] = []
    page_meta: List[Dict] = []
    offsets_in_payload: List[int] = []
    pos = len(dict_page)
    r = 0
    while r < n_rows or (n_rows == 0 and not pages):
        # grow the page until its *encoded* size crosses page_bytes
        lo_entry = row_start_pos[r] if n_rows else 0
        rows_here = max(1, n_rows - r) if n_rows else 0
        # binary grow: start from an estimate, double/halve on encode size
        guess = _estimate_rows(leaf, value_slot, valid_mask, row_start_pos, r, page_bytes)
        rows_here = min(max(1, guess), n_rows - r) if n_rows else 0
        while True:
            hi_entry = row_start_pos[r + rows_here] if r + rows_here < n_rows else n
            blob, meta = _encode_page(
                leaf, lo_entry, hi_entry, value_slot, valid_mask,
                fixed_codec, bytes_codec, codes,
            )
            if len(blob) <= page_bytes * 2 or rows_here <= 1:
                break
            rows_here = max(1, rows_here // 2)
        pages.append(blob)
        meta["first_row"] = r
        meta["n_rows"] = rows_here
        page_meta.append(meta)
        offsets_in_payload.append(pos)
        pos += len(blob)
        r += rows_here
        if n_rows == 0:
            break

    payload = dict_page + b"".join(pages)
    meta = {
        "encoding": "parquet",
        "fixed_codec": fixed_codec or "auto",
        "bytes_codec": bytes_codec,
        "dict": dict_meta if dict_encode else None,
        "dict_page_bytes": len(dict_page),
        "pages": page_meta,
        "page_offsets": offsets_in_payload,
        "n_rows": n_rows if n_rows else leaf.n_rows,
        "n_entries": n,
    }
    return EncodedColumn(
        "parquet", payload, meta,
        search_cache_bytes=PAGE_INDEX_BYTES_PER_PAGE * len(pages),
    )


def _estimate_rows(leaf, value_slot, valid_mask, row_start_pos, r, page_bytes) -> int:
    n_rows = len(row_start_pos)
    if n_rows == 0:
        return 0
    vals = leaf.values
    if isinstance(vals, A.VarBinaryArray):
        avg_v = float(vals.offsets[-1]) / max(1, len(vals))
    elif vals.values.ndim > 1:
        avg_v = vals.values.dtype.itemsize * vals.values.shape[1]
    else:
        avg_v = vals.values.dtype.itemsize
    entries_per_row = leaf.n_entries / n_rows
    per_row = entries_per_row * (avg_v * 0.6 + 0.4)  # assume mild compression
    return max(1, int(page_bytes / max(per_row, 1e-9)))


def _encode_page(leaf, lo, hi, value_slot, valid_mask, fixed_codec, bytes_codec, codes):
    vm = valid_mask[lo:hi]
    bufs: List[bytes] = []
    metas: List[Dict] = []
    if leaf.rep is not None:
        bufs.append(pack_levels(leaf.rep[lo:hi], leaf.max_rep).tobytes())
        metas.append({"stream": "rep"})
    if leaf.defs is not None:
        bufs.append(pack_levels(leaf.defs[lo:hi], leaf.max_def).tobytes())
        metas.append({"stream": "def"})
    if codes is not None:
        page_codes = codes[value_slot[lo:hi][vm]]
        cbits = min_bits(codes)
        bufs.append(bitpack(page_codes, cbits).tobytes())
        metas.append({"stream": "codes", "cbits": cbits})
    else:
        from .miniblock import _default_fixed_codec

        fc = fixed_codec or _default_fixed_codec(leaf.values)
        vals = leaf.values.take(value_slot[lo:hi][vm])
        for enc in _encode_chunk_values(leaf.leaf_type, vals, fc, bytes_codec):
            bufs.append(enc.data.tobytes())
            metas.append(enc.meta)
    blob = _serialize_page(bufs)
    return blob, {"n_entries": hi - lo, "n_values": int(vm.sum()), "bufmeta": metas,
                  "size": len(blob)}


def _serialize_page(buffers: List[bytes]) -> bytes:
    head = struct.pack("<I", len(buffers)) + b"".join(
        struct.pack("<I", len(b)) for b in buffers
    )
    out = pad_to(head)
    for b in buffers:
        out += pad_to(b)
    return out


def _parse_page(raw: np.ndarray) -> List[np.ndarray]:
    data = raw.tobytes()
    (nb,) = struct.unpack_from("<I", data, 0)
    sizes = struct.unpack_from(f"<{nb}I", data, 4)
    pos = (4 + 4 * nb + 7) & ~7
    bufs = []
    for s in sizes:
        bufs.append(raw[pos : pos + s])
        pos = (pos + s + 7) & ~7
    return bufs


class ParquetReader(ColumnReader):
    def __init__(self, meta, base, leaf_proto, dict_cached: bool = False):
        super().__init__(meta, base, leaf_proto)
        self.dict_cached = dict_cached
        self._dict_cache = None
        self._first_rows = np.array([p["first_row"] for p in meta["pages"]], dtype=np.int64)

    # -- dictionary -----------------------------------------------------
    def _load_dict(self, io, phase: int = 0):
        # Cold (non-cached) behavior is modelled by take() dropping the cache
        # at the start of each operation; within one operation the dictionary
        # is fetched once.
        if self._dict_cache is not None:
            return self._dict_cache
        dm = self.meta["dict"]
        raw = io.read(self.base, self.meta["dict_page_bytes"], phase=phase)
        if dm["kind"] == "var":
            n, lb_sz = struct.unpack_from("<II", raw.tobytes(), 0)
            pos = 8
            pos = (pos + 7) & ~7
            lens = bitunpack(raw[pos : pos + lb_sz], n, dm["lbits"]).astype(np.int64)
            pos = (pos + lb_sz + 7) & ~7
            offs = np.zeros(n + 1, np.int64)
            np.cumsum(lens, out=offs[1:])
            data = raw[pos : pos + int(offs[-1])]
            d = ("var", offs, np.asarray(data))
        else:
            dt = np.dtype(dm["dtype"])
            s1 = dm.get("shape1", 0)
            flat = np.frombuffer(raw.tobytes(), dtype=dt, count=dm["n"] * (s1 or 1))
            d = ("fixed", flat.reshape(dm["n"], s1) if s1 else flat)
        self._dict_cache = d
        return d

    def search_cache_bytes_effective(self) -> int:
        sc = PAGE_INDEX_BYTES_PER_PAGE * len(self.meta["pages"])
        if self.dict_cached and self.meta["dict"] is not None:
            sc += self.meta["dict_page_bytes"]
        return sc

    # -- decode ----------------------------------------------------------
    def _decode_page(self, pi: int, raw: np.ndarray, io):
        pm = self.meta["pages"][pi]
        bufs = _parse_page(raw)
        k = pm["n_entries"]
        bi = 0
        rep = defs = None
        if self.proto.max_rep > 0:
            rep = unpack_levels(bufs[bi], k, self.proto.max_rep)
            bi += 1
        if self.proto.max_def > 0:
            defs = unpack_levels(bufs[bi], k, self.proto.max_def)
            bi += 1
        if self.meta["dict"] is not None:
            codes = bitunpack(bufs[bi], pm["n_values"], pm["bufmeta"][bi]["cbits"]).astype(np.int64)
            d = self._load_dict(io, phase=0)
            if d[0] == "var":
                _, offs, data = d
                lens = (offs[1:] - offs[:-1])[codes]
                noffs = np.zeros(len(codes) + 1, np.int64)
                np.cumsum(lens, out=noffs[1:])
                out = np.zeros(int(noffs[-1]), np.uint8)
                src = np.repeat(offs[:-1][codes], lens) + (
                    np.arange(int(noffs[-1])) - np.repeat(noffs[:-1], lens)
                )
                out[:] = data[src]
                vals = A.VarBinaryArray(
                    self.proto.leaf_type.with_nullable(False),
                    np.ones(len(codes), bool), noffs, out,
                )
            else:
                flat = d[1][codes]
                if flat.ndim > 1:
                    vals = A.FixedSizeListArray(self.proto.leaf_type.with_nullable(False),
                                                np.ones(len(codes), bool), flat)
                else:
                    vals = A.PrimitiveArray(self.proto.leaf_type.with_nullable(False),
                                            np.ones(len(codes), bool), flat)
        else:
            vals = _decode_chunk_values(
                self.proto.leaf_type, bufs[bi:], pm["bufmeta"][bi:], pm["n_values"],
                self.meta["fixed_codec"], self.meta["bytes_codec"],
            )
        return rep, defs, vals

    # -- access ----------------------------------------------------------
    def take(self, rows: np.ndarray, io) -> ShreddedLeaf:
        """Batched random access: one ``searchsorted`` maps all
        rows to pages, every needed page is fetched in a single phase-0
        ``read_many`` dispatch and decoded exactly once, row extraction is
        one vectorized segment-id pass over the concatenated entry streams,
        and a single :func:`reorder_leaf_rows` permutation fans the decoded
        rows out to request order (duplicates never re-extracted)."""
        rows = np.asarray(rows, dtype=np.int64)
        if len(rows) == 0:
            return empty_leaf(self.proto)
        if self.meta["dict"] is not None and not self.dict_cached:
            self._dict_cache = None  # cold: must refetch per take (parquet-rs behavior)
            self._load_dict(io, phase=0)
        pis = np.searchsorted(self._first_rows, rows, side="right") - 1
        needed = np.unique(pis)
        offs = np.asarray(self.meta["page_offsets"], dtype=np.int64)
        sizes = np.array([self.meta["pages"][p]["size"] for p in needed],
                         dtype=np.int64)
        data, doffs = io.read_many(self.base + offs[needed], sizes, phase=0)
        decoded = [
            self._decode_page(int(p), data[doffs[i]: doffs[i + 1]], io)
            for i, p in enumerate(needed)
        ]
        lens = np.array([self.meta["pages"][p]["n_entries"] for p in needed],
                        dtype=np.int64)
        reps = [d[0] for d in decoded]
        dfs = [d[1] for d in decoded]
        rep_all = np.concatenate(reps) if reps[0] is not None else None
        def_all = np.concatenate(dfs) if dfs[0] is not None else None
        vals_all = A.concat([d[2] for d in decoded])
        total = int(lens.sum())

        # global row id per entry (pages start on record boundaries, so each
        # page's cumsum of row starts is offset by its first_row)
        if self.proto.max_rep > 0:
            starts = rep_all == self.proto.max_rep
        else:
            starts = np.ones(total, dtype=bool)
        cs = np.cumsum(starts)
        page_off = np.zeros(len(needed) + 1, dtype=np.int64)
        np.cumsum(lens, out=page_off[1:])
        cs_pre = np.concatenate([[0], cs])[page_off[:-1]]
        first_rows = self._first_rows[needed]
        row_id = cs - 1 - np.repeat(cs_pre, lens) + np.repeat(first_rows, lens)

        # select the entries of all requested rows in one pass
        urows, inv = np.unique(rows, return_inverse=True)
        pos = np.searchsorted(urows, row_id)
        pos_c = np.minimum(pos, len(urows) - 1)
        sel = urows[pos_c] == row_id
        vmask = (def_all == 0) if def_all is not None else np.ones(total, bool)
        vslot = np.cumsum(vmask) - 1
        rep_sel = rep_all[sel] if rep_all is not None else None
        def_sel = def_all[sel] if def_all is not None else None
        val_sel = vals_all.take(vslot[sel & vmask])
        dec = leaf_slice(self.proto, rep_sel, def_sel, val_sel, len(urows))
        out = reorder_leaf_rows(dec, inv)
        # useful bytes over the *request* (duplicates included), identical to
        # the historical per-row extraction's accounting
        io.note_useful(value_bytes(out.values))
        return out

    def scan(self, io, io_chunk: int = 8 << 20) -> ShreddedLeaf:
        """Full scan in bounded-memory windows: pages are decoded as soon as
        their bytes are fully buffered and the consumed prefix is dropped,
        so peak raw-buffer RSS is O(window + max page) instead of O(column).
        The logical read sequence is unchanged."""
        if self.meta["dict"] is not None:
            self._load_dict(io, phase=0)
        offs = self.meta["page_offsets"]
        total = (offs[-1] + self.meta["pages"][-1]["size"]) if offs else 0
        start = self.meta["dict_page_bytes"]
        reps, dfs, vals = [], [], []
        buf = np.zeros(0, dtype=np.uint8)
        buf_start = start  # file offset of buf[0]
        pi = 0
        for p in range(start, total, io_chunk):
            part = io.read(self.base + p, min(io_chunk, total - p), phase=0)
            buf = np.concatenate([buf, part]) if len(buf) else part
            while pi < len(offs):
                off, sz = offs[pi], self.meta["pages"][pi]["size"]
                if off + sz > buf_start + len(buf):
                    break
                r, d, v = self._decode_page(
                    pi, buf[off - buf_start: off - buf_start + sz], io)
                reps.append(r)
                dfs.append(d)
                vals.append(v)
                pi += 1
            if pi < len(offs):  # drop bytes before the next undecoded page
                keep = offs[pi]
                buf = buf[keep - buf_start:]
                buf_start = keep
            else:
                buf = np.zeros(0, dtype=np.uint8)
                buf_start = p + len(part)
        rep = np.concatenate(reps) if reps and reps[0] is not None else None
        defs = np.concatenate(dfs) if dfs and dfs[0] is not None else None
        values = A.concat(vals) if vals else empty_values(self.proto.leaf_type)
        return leaf_slice(self.proto, rep, defs, values, self.meta["n_rows"])
