"""The mini-block structural encoding (paper §4.2).

Small data types are chunked into compressed mini-blocks of 1–2 disk sectors
(4–8 KiB target, hard ceiling 32 KiB from the 12-bit word count), each chunk
holding bit-packed repetition levels, definition levels and value buffers.
Whole chunks are decoded at once, so opaque compression is allowed; random
access pays chunk-sized read amplification plus decode work — the trade the
paper accepts for small types.

Chunk rules implemented exactly as §4.2.1/4.2.2:
* power-of-two number of entries per chunk (last chunk may be ragged),
  at most 4096;
* chunk payload padded to 8-byte words; on-disk chunk meta is 2 bytes
  (12-bit word count, 4-bit log2(num values));
* chunk = [u16 n_buffers][u16 size x n_buffers][8-aligned buffers...];
* buffers: [rep][def][values...] (absent streams are skipped);
* a repetition index with N+1 = 2 counters per chunk supports one level of
  random access (§4.2.3), handling rows that split across chunks.

Search cache (§4.2.4): 24 in-memory bytes per chunk without a repetition
index, 41 with — we model exactly those numbers.

Random access runs as a batched decode-once pipeline (see
:class:`MiniBlockReader`): one vectorized repetition-index lookup for all
rows, one phase-grouped ``read_many`` IO dispatch, each chunk decoded
exactly once (optionally on the GPU via the ``decode='device'`` knob — the
power-of-two/8-aligned chunk rules make the kernel's fixed per-chunk tiling
possible), and a single segment-id permutation back to request order.  The
logical IOPS/byte trace is the same on either route.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional

import numpy as np

from . import arrays as A
from . import types as T
from .compression import Encoded, get_bytes_codec, get_fixed_codec, min_bits
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
from ..kernels import ops
from .rdlevels import level_bits, pack_levels, unpack_levels
from .shred import ShreddedLeaf

__all__ = ["encode_miniblock", "MiniBlockReader"]

MAX_CHUNK_VALUES = ops.MAX_ENTRIES  # the format's per-chunk ceiling (sec 4.2.1)
TARGET_CHUNK_BYTES = 8 * 1024  # 1-2 disk sectors compressed
MAX_CHUNK_WORDS = (1 << 12) - 1  # 12-bit word count
MIN_CHUNK_VALUES = 32

# in-memory search-cache cost model from the paper (sec 4.2.4)
CACHE_BYTES_PER_CHUNK = 24
CACHE_BYTES_PER_CHUNK_WITH_REP = 41


def _default_fixed_codec(values: A.Array) -> str:
    dt = values.values.dtype if not isinstance(values, A.VarBinaryArray) else None
    if dt is not None and dt.kind in ("i", "u"):
        return "bitpack"
    return "plain"


def _encode_chunk_values(
    leaf_type: T.DataType,
    values: A.Array,
    fixed_codec: str,
    bytes_codec: str,
) -> List[Encoded]:
    """Encode the (sparse) values of one chunk into 1-2 buffers."""
    if isinstance(leaf_type, (T.Utf8, T.Binary)):
        lengths = (values.offsets[1:] - values.offsets[:-1]).astype(np.uint64)
        bc = get_bytes_codec(bytes_codec)
        enc_data = bc.encode(lengths, values.data)
        stored = enc_data.out_lengths if enc_data.out_lengths is not None else lengths
        enc_lens = get_fixed_codec(fixed_codec if fixed_codec != "plain" else "bitpack").encode(
            np.asarray(stored, dtype=np.uint64)
        )
        return [enc_lens, enc_data]
    if isinstance(leaf_type, T.FixedSizeList):
        flat = values.values.reshape(-1)
        codec = get_fixed_codec("plain" if flat.dtype.kind == "f" else fixed_codec)
        enc = codec.encode(flat)
        enc.meta["fsl"] = leaf_type.size
        enc.meta["codec"] = codec.name
        return [enc]
    codec = get_fixed_codec("plain" if values.values.dtype.kind == "f" else fixed_codec)
    enc = codec.encode(values.values)
    enc.meta["codec"] = codec.name
    return [enc]


def _decode_chunk_values(
    leaf_type: T.DataType,
    bufs: List[np.ndarray],
    metas: List[Dict],
    n_values: int,
    fixed_codec: str,
    bytes_codec: str,
) -> A.Array:
    if isinstance(leaf_type, (T.Utf8, T.Binary)):
        lens_codec = get_fixed_codec(metas[0].get("codec", "bitpack"))
        stored = lens_codec.decode(Encoded(bufs[0], metas[0]), n_values).astype(np.int64)
        bc = get_bytes_codec(bytes_codec)
        out_lens, out_data = bc.decode(Encoded(bufs[1], metas[1]), stored)
        offsets = np.zeros(n_values + 1, dtype=np.int64)
        np.cumsum(out_lens, out=offsets[1:])
        return A.VarBinaryArray(
            leaf_type.with_nullable(False), np.ones(n_values, bool), offsets, out_data
        )
    codec = get_fixed_codec(metas[0]["codec"])
    if isinstance(leaf_type, T.FixedSizeList):
        flat = codec.decode(Encoded(bufs[0], metas[0]), n_values * leaf_type.size)
        return A.FixedSizeListArray(
            leaf_type.with_nullable(False),
            np.ones(n_values, bool),
            np.asarray(flat).reshape(n_values, leaf_type.size),
        )
    vals = codec.decode(Encoded(bufs[0], metas[0]), n_values)
    return A.PrimitiveArray(
        leaf_type.with_nullable(False), np.ones(n_values, bool), np.asarray(vals)
    )


def _serialize_chunk(buffers: List[bytes]) -> bytes:
    """[u16 n_buffers][u16 size each][8-aligned buffer bytes ...] padded to 8."""
    for b in buffers:
        if len(b) > 0xFFFF:
            raise ValueError("buffer exceeds u16 size field")
    head = struct.pack("<H", len(buffers)) + b"".join(
        struct.pack("<H", len(b)) for b in buffers
    )
    out = pad_to(head)
    for b in buffers:
        out += pad_to(b)
    return pad_to(out)


def _parse_chunk(raw: np.ndarray) -> List[np.ndarray]:
    data = raw.tobytes()
    (nb,) = struct.unpack_from("<H", data, 0)
    sizes = struct.unpack_from(f"<{nb}H", data, 2)
    pos = (2 + 2 * nb + 7) & ~7
    bufs = []
    for s in sizes:
        bufs.append(raw[pos : pos + s])
        pos = (pos + s + 7) & ~7
    return bufs


def encode_miniblock(
    leaf: ShreddedLeaf,
    fixed_codec: Optional[str] = None,
    bytes_codec: str = "zstd_chunk",
) -> EncodedColumn:
    fixed_codec = fixed_codec or _default_fixed_codec(leaf.values)
    n_entries = leaf.n_entries

    # map each entry to its value slot (sparse values: def==0 entries only)
    valid_mask = (leaf.defs == 0) if leaf.defs is not None else np.ones(n_entries, bool)
    value_slot = np.cumsum(valid_mask) - 1

    # rows: entries that start a top-level row
    if leaf.max_rep > 0:
        row_start = leaf.rep == leaf.max_rep
    else:
        row_start = np.ones(n_entries, dtype=bool)

    chunks: List[bytes] = []
    chunk_meta: List[Dict] = []
    rep_index: List[tuple] = []  # (rows_started_before_chunk, first_entry_is_row_start)
    payload_offsets: List[int] = []
    pos = 0
    start = 0
    rows_before = 0
    while start < n_entries or (n_entries == 0 and not chunks):
        k = min(MAX_CHUNK_VALUES, n_entries - start) if n_entries else 0
        if k > 0:
            # round down to power of two unless it's the ragged tail
            if start + k < n_entries:
                k = 1 << (k.bit_length() - 1)
        while True:
            end = start + k
            e_rep = leaf.rep[start:end] if leaf.rep is not None else None
            e_def = leaf.defs[start:end] if leaf.defs is not None else None
            vm = valid_mask[start:end]
            vals = leaf.values.take(value_slot[start:end][vm])
            bufs: List[bytes] = []
            metas: List[Dict] = []
            if e_rep is not None:
                bufs.append(pack_levels(e_rep, leaf.max_rep).tobytes())
                metas.append({"stream": "rep"})
            if e_def is not None:
                bufs.append(pack_levels(e_def, leaf.max_def).tobytes())
                metas.append({"stream": "def"})
            encs = _encode_chunk_values(leaf.leaf_type, vals, fixed_codec, bytes_codec)
            for enc in encs:
                bufs.append(enc.data.tobytes())
                metas.append(enc.meta)
            try:
                blob = _serialize_chunk(bufs)
            except ValueError:
                blob = None
            if (
                blob is not None
                and (len(blob) <= TARGET_CHUNK_BYTES or k <= MIN_CHUNK_VALUES)
                and len(blob) // 8 <= MAX_CHUNK_WORDS
            ):
                break
            if k <= 1:
                raise ValueError("single value exceeds miniblock limits; "
                                 "use full-zip for large types")
            k = max(1, k // 2)
        n_vals = int(vm.sum())
        chunks.append(blob)
        chunk_meta.append(
            {
                "n_entries": k,
                "n_values": n_vals,
                "words": len(blob) // 8,
                "bufmeta": metas,
            }
        )
        rep_index.append((rows_before, bool(row_start[start]) if k else True))
        rows_before += int(row_start[start:end].sum())
        payload_offsets.append(pos)
        pos += len(blob)
        start = end
        if n_entries == 0:
            break

    payload = b"".join(chunks)
    has_rep = leaf.max_rep > 0
    per_chunk = CACHE_BYTES_PER_CHUNK_WITH_REP if has_rep else CACHE_BYTES_PER_CHUNK
    meta = {
        "encoding": "miniblock",
        "fixed_codec": fixed_codec,
        "bytes_codec": bytes_codec,
        "chunks": chunk_meta,
        "chunk_offsets": payload_offsets,
        "rep_index": rep_index,
        "n_rows": leaf.n_rows,
        "n_entries": n_entries,
    }
    return EncodedColumn(
        encoding="miniblock",
        payload=payload,
        meta=meta,
        search_cache_bytes=per_chunk * len(chunks),
    )


class MiniBlockReader(ColumnReader):
    """Mini-block random access + scan.

    ``take`` runs as a batched, decode-once pipeline: one vectorized
    ``searchsorted`` maps all requested rows to chunk ranges, every needed
    chunk is fetched in a single phase-0 :meth:`~repro_torch.store.ReadBatch.read_many`
    dispatch and decoded exactly once, row extraction is a single
    segment-id/gather permutation over the concatenated entry streams, and
    the result is fanned back out to request order with one
    :func:`~repro_torch.core.encodings_base.reorder_leaf_rows` pass.

    ``decode`` selects the chunk decoder: ``"numpy"`` (host) or ``"device"``
    (the ``miniblock_decode`` kernel of :mod:`repro_torch.kernels` on
    ``device``; integer chunks are batch-decoded in one launch, other codecs
    fall back to numpy per chunk).
    """

    def __init__(self, meta: Dict, base: int, leaf_proto: ShreddedLeaf,
                 decode: str = "numpy", device=None):
        super().__init__(meta, base, leaf_proto)
        if decode not in ("numpy", "device"):
            raise ValueError(f"decode must be 'numpy'|'device', got {decode!r}")
        self.decode = decode
        self.device = device

    def _decode_chunk(self, ci: int, raw: np.ndarray):
        cm = self.meta["chunks"][ci]
        bufs = _parse_chunk(raw)
        k = cm["n_entries"]
        bi = 0
        rep = defs = None
        if self.proto.max_rep > 0:
            rep = unpack_levels(bufs[bi], k, self.proto.max_rep)
            bi += 1
        if self.proto.max_def > 0:
            defs = unpack_levels(bufs[bi], k, self.proto.max_def)
            bi += 1
        vals = _decode_chunk_values(
            self.proto.leaf_type,
            bufs[bi:],
            cm["bufmeta"][bi:],
            cm["n_values"],
            self.meta["fixed_codec"],
            self.meta["bytes_codec"],
        )
        return rep, defs, vals

    # ------------------------------------------------------------------
    def _chunk_ranges_for_rows(self, urows: np.ndarray):
        """Vectorized §4.2.3 repetition-index lookup: sorted unique row ids ->
        per-row inclusive chunk ranges ``(c0, c1)``, one ``searchsorted``
        over all rows instead of one per row."""
        ri = self.meta["rep_index"]
        rows_before = np.array([r[0] for r in ri], dtype=np.int64)
        first_is_start = np.array([r[1] for r in ri], dtype=bool)
        n_chunks = len(ri)
        c0 = np.searchsorted(rows_before, urows, side="right") - 1
        # chunk where row r+1 starts; if that chunk *begins* with row r+1,
        # row r ends in the previous chunk
        c1 = np.searchsorted(rows_before, urows + 1, side="right") - 1
        back = (c1 > c0) & (rows_before[c1] == urows + 1) & first_is_start[c1]
        c1 = np.minimum(c1 - back, n_chunks - 1)
        return c0, c1, rows_before

    def take(self, rows: np.ndarray, io) -> ShreddedLeaf:
        rows = np.asarray(rows, dtype=np.int64)
        if len(rows) == 0:
            return empty_leaf(self.proto)
        urows, inv = np.unique(rows, return_inverse=True)
        if urows[0] < 0 or urows[-1] >= self.meta["n_rows"]:
            raise IndexError(
                f"take rows out of bounds for {self.meta['n_rows']}-row column"
            )
        c0, c1, rows_before = self._chunk_ranges_for_rows(urows)
        n_chunks = len(rows_before)
        # union of the [c0, c1] ranges via a coverage diff (O(chunks + rows))
        cover = np.zeros(n_chunks + 1, dtype=np.int64)
        np.add.at(cover, c0, 1)
        np.add.at(cover, c1 + 1, -1)
        needed = np.nonzero(np.cumsum(cover[:-1]) > 0)[0]

        # IO: every needed chunk exactly once, one phase-0 batch dispatch
        offs = np.asarray(self.meta["chunk_offsets"], dtype=np.int64)
        sizes = np.array([self.meta["chunks"][c]["words"] * 8 for c in needed],
                         dtype=np.int64)
        data, doffs = io.read_many(self.base + offs[needed], sizes, phase=0)
        raws = [data[doffs[i]: doffs[i + 1]] for i in range(len(needed))]

        # decode each chunk exactly once (numpy or batched on the device)
        decoded = self._decode_chunks(needed, raws,
                                      tracer=getattr(io, "tracer", None))
        lens = np.array([self.meta["chunks"][c]["n_entries"] for c in needed],
                        dtype=np.int64)
        reps = [d[0] for d in decoded]
        dfs = [d[1] for d in decoded]
        rep_all = np.concatenate(reps) if reps and reps[0] is not None else None
        def_all = np.concatenate(dfs) if dfs and dfs[0] is not None else None
        vals_all = A.concat([d[2] for d in decoded])
        total = int(lens.sum())

        # global row id per entry: per-chunk cumsum over row starts, offset by
        # the repetition index's rows-started-before counter (entries before a
        # chunk's first start continue row rows_before - 1)
        if self.proto.max_rep > 0:
            starts = rep_all == self.proto.max_rep
        else:
            starts = np.ones(total, dtype=bool)
        cs = np.cumsum(starts)
        chunk_off = np.zeros(len(needed) + 1, dtype=np.int64)
        np.cumsum(lens, out=chunk_off[1:])
        cs_pre = np.concatenate([[0], cs])[chunk_off[:-1]]
        row_id = cs - 1 - np.repeat(cs_pre, lens) + np.repeat(rows_before[needed], lens)

        # select the entries of all requested rows in one pass
        pos = np.searchsorted(urows, row_id)
        pos_c = np.minimum(pos, len(urows) - 1)
        sel = urows[pos_c] == row_id
        vmask = (def_all == 0) if def_all is not None else np.ones(total, bool)
        vslot = np.cumsum(vmask) - 1
        rep_sel = rep_all[sel] if rep_all is not None else None
        def_sel = def_all[sel] if def_all is not None else None
        val_sel = vals_all.take(vslot[sel & vmask])
        dec = leaf_slice(self.proto, rep_sel, def_sel, val_sel, len(urows))
        # useful bytes are counted over *unique* rows: duplicates are served
        # from the decoded result, not re-read, so amplification stays >= 1
        io.note_useful(value_bytes(dec.values))
        return reorder_leaf_rows(dec, inv)  # fan out to request order

    # ------------------------------------------------------------------
    def _decode_chunks(self, chunk_ids, raws, tracer=None) -> List[tuple]:
        """Decode chunks ``chunk_ids`` (raw payloads in ``raws``) exactly
        once each.  Under ``decode='device'``, integer chunks (bit-packed or
        FoR byte-packed values; flat, nested or fixed-size-list; any
        rep/def level width) are batch-decoded by one ``miniblock_decode``
        launch; the rest fall back to the numpy path per chunk, each
        fallback counted under its reason (``ops.fallbacks``, and ``tracer``,
        the IO path's, via the batch handle)."""
        if self.decode == "device":
            routed = self._decode_chunks_device(chunk_ids, raws, tracer)
            if routed is not None:
                return routed
        return [self._decode_chunk(c, raw) for c, raw in zip(chunk_ids, raws)]

    # The eligibility rules and fallback slugs keep the JAX package's names
    # (its Pallas kernel's), so the same chunks reach the kernel and the
    # fallback counts read the same on both.

    def _pallas_ineligible_reason(self) -> Optional[str]:
        """Column-level kernel coverage: integer primitives and fixed-size
        lists of integers, with any (column-constant) rep/def level widths;
        per-chunk value codecs are checked in :meth:`_chunk_kernel_params`.
        Returns the fallback reason (None = eligible): ``variable-width-leaf``
        (utf8/binary/list offsets), ``float-values``, ``non-integer-values``,
        ``tile-over-vmem``."""
        lt = self.proto.leaf_type
        if isinstance(lt, T.Primitive):
            vpe = 1
            kind = np.dtype(lt.dtype).kind
        elif isinstance(lt, T.FixedSizeList):
            vpe = lt.size
            kind = np.dtype(lt.child.dtype).kind
        else:
            return "variable-width-leaf"
        if kind == "f":
            return "float-values"
        if kind not in "iu":
            return "non-integer-values"
        if MAX_CHUNK_VALUES * vpe > ops.MAX_TILE_VALUES:
            return "tile-over-vmem"
        return None

    @staticmethod
    def _chunk_kernel_params(bufmeta: Dict) -> Optional[tuple]:
        """Per-chunk value-codec eligibility: ``(bits, ref)`` when the
        kernel's int32 extract covers this chunk, else None.  ``bitpack`` is
        a dense bit stream (ref 0); ``bytepack`` is byte-aligned FoR whose
        reference must keep the int32 arithmetic exact."""
        codec = bufmeta.get("codec")
        if codec == "bitpack":
            return (bufmeta["bits"], 0) if bufmeta["bits"] <= 31 else None
        if codec == "bytepack":
            ref = bufmeta.get("ref")
            if ref is None:  # float payload stored as raw bytes
                return None
            bits = 8 * bufmeta["width"]
            if bits > 31:
                return None
            if ref < -(1 << 31) or ref + (1 << bits) - 1 > (1 << 31) - 1:
                return None
            return (bits, ref)
        return None

    @staticmethod
    def _chunk_fallback_reason(bufmeta: Dict) -> str:
        """Why :meth:`_chunk_kernel_params` rejected this chunk's value
        codec (only called when it did)."""
        codec = bufmeta.get("codec")
        if codec == "bitpack":
            return ">31-bit"
        if codec == "bytepack":
            if bufmeta.get("ref") is None:
                return "float-bytes"
            if 8 * bufmeta["width"] > 31:
                return ">31-bit"
            return "ref-overflow"
        return f"opaque-codec:{codec}"

    def _decode_chunks_device(self, chunk_ids, raws,
                              tracer=None) -> Optional[List[tuple]]:
        col_reason = self._pallas_ineligible_reason()
        if col_reason is not None:
            ops.note_fallback("miniblock", col_reason, tracer,
                              n_chunks=len(chunk_ids))
            return None
        lt = self.proto.leaf_type
        fsl = isinstance(lt, T.FixedSizeList)
        vpe = lt.size if fsl else 1
        dt = np.dtype(lt.child.dtype if fsl else lt.dtype)
        rep_bits = level_bits(self.proto.max_rep)
        def_bits = level_bits(self.proto.max_def)
        vbi = (1 if rep_bits else 0) + (1 if def_bits else 0)
        metas = [self.meta["chunks"][c] for c in chunk_ids]
        # metadata-only eligibility check first: chunks are parsed at most
        # once, and an all-ineligible batch costs no parse work at all
        kp = [self._chunk_kernel_params(cm["bufmeta"][vbi]) for cm in metas]
        reasons: Dict[str, int] = {}
        for cm, p in zip(metas, kp):
            if p is None:
                r = self._chunk_fallback_reason(cm["bufmeta"][vbi])
                reasons[r] = reasons.get(r, 0) + 1
        for r in sorted(reasons):  # one count per reason per batch
            ops.note_fallback("miniblock", r, tracer, n_chunks=reasons[r])
        if not any(p is not None for p in kp):
            return None
        sel = [i for i, p in enumerate(kp) if p is not None]
        parsed = {i: _parse_chunk(raws[i]) for i in sel}
        tile = -(-max(metas[i]["n_entries"] for i in sel) // 128) * 128
        params = np.zeros((len(sel), 3), dtype=np.int32)
        streams = []  # (rep_words, def_words, val_words) ragged rows
        for j, i in enumerate(sel):
            cm, bufs = metas[i], parsed[i]
            rw = ops.pack_words(bufs[0], pad_words=1) if rep_bits else None
            dw = (ops.pack_words(bufs[1 if rep_bits else 0], pad_words=1)
                  if def_bits else None)
            vw = ops.pack_words(bufs[vbi], pad_words=1)
            streams.append((rw, dw, vw))
            params[j] = (cm["n_entries"], kp[i][0], kp[i][1])

        def stack(rows, active):
            if not active:
                return np.zeros((len(rows), 1), dtype=np.uint32)
            width = max(len(r) for r in rows)
            out = np.zeros((len(rows), width), dtype=np.uint32)
            for j, r in enumerate(rows):
                out[j, : len(r)] = r
            return out

        dev = self.device
        rep_np, def_np, vals_np = (ops.to_host(a) for a in ops.miniblock_decode(
            ops.to_device(stack([s[0] for s in streams], rep_bits), dev),
            ops.to_device(stack([s[1] for s in streams], def_bits), dev),
            ops.to_device(stack([s[2] for s in streams], True), dev),
            ops.to_device(params, dev), rep_bits=rep_bits, def_bits=def_bits,
            vpe=vpe, tile_entries=tile, fill=0))

        out: List[tuple] = [None] * len(chunk_ids)
        for j, i in enumerate(sel):
            k = metas[i]["n_entries"]
            rep = rep_np[j, :k].astype(np.uint8) if rep_bits else None
            defs = def_np[j, :k].astype(np.uint8) if def_bits else None
            valid = (defs == 0) if defs is not None else np.ones(k, bool)
            n_valid = int(valid.sum())
            dense = vals_np[j, : k * vpe]
            if fsl:
                vals = A.FixedSizeListArray(
                    lt.with_nullable(False), np.ones(n_valid, bool),
                    dense.reshape(k, vpe)[valid].astype(dt),
                )
            else:
                vals = A.PrimitiveArray(
                    lt.with_nullable(False), np.ones(n_valid, bool),
                    dense[:k][valid].astype(dt),
                )
            out[i] = (rep, defs, vals)
        for i, p in enumerate(kp):
            if p is None:
                out[i] = self._decode_chunk(chunk_ids[i], raws[i])
        return out

    def scan(self, io, io_chunk: int = 8 << 20) -> ShreddedLeaf:
        offs = self.meta["chunk_offsets"]
        total = (offs[-1] + self.meta["chunks"][-1]["words"] * 8) if offs else 0
        raw_parts = []
        for p in range(0, total, io_chunk):
            raw_parts.append(io.read(self.base + p, min(io_chunk, total - p), phase=0))
        raw = np.concatenate(raw_parts) if raw_parts else np.zeros(0, np.uint8)
        n_chunks = len(offs)
        raws = [
            raw[offs[ci]: offs[ci] + self.meta["chunks"][ci]["words"] * 8]
            for ci in range(n_chunks)
        ]
        decoded = self._decode_chunks(np.arange(n_chunks), raws,
                                      tracer=getattr(io, "tracer", None))
        reps = [d[0] for d in decoded]
        dfs = [d[1] for d in decoded]
        vals = [d[2] for d in decoded]
        rep = np.concatenate(reps) if reps and reps[0] is not None else None
        defs = np.concatenate(dfs) if dfs and dfs[0] is not None else None
        if vals:
            values = A.concat(vals)
        else:
            values = empty_values(self.proto.leaf_type)
        return leaf_slice(self.proto, rep, defs, values, self.meta["n_rows"])


# retained as the historical entry points; the implementations are the shared
# helpers in encodings_base
_reorder_rows = reorder_leaf_rows
_empty_values = empty_values
