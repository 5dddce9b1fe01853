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
possible), and a single segment-id permutation back to request order; on the
device route a column without repetition levels decodes just the requested
entries.  The logical IOPS/byte trace is the same on every route.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional, Tuple

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


def _chunk_spans(data: np.ndarray, starts: np.ndarray,
                 n_slots: int) -> Tuple[np.ndarray, np.ndarray]:
    """Where buffers ``0 .. n_slots - 1`` of each chunk lie in ``data``,
    read from every chunk's header at once: the chunks begin at byte
    ``starts`` of ``data``; returns each buffer's byte start in ``data`` and
    its size, both ``(C, n_slots)`` int64.  The rule is
    :func:`_parse_chunk`'s: the first buffer at
    ``(2 + 2 * n_buffers + 7) & ~7`` of its chunk, each next one at the
    previous end rounded up to 8.  A chunk with fewer than ``n_slots``
    buffers raises ``ValueError``."""
    starts = np.asarray(starts, dtype=np.int64)

    def u16(at):
        return data[at].astype(np.int64) | (data[at + 1].astype(np.int64) << 8)

    nb = u16(starts)
    if (nb < n_slots).any():
        raise ValueError(f"mini-block chunk holds fewer than {n_slots} buffers")
    sizes = u16(starts[:, None] + 2 + 2 * np.arange(n_slots))
    padded = (sizes + 7) & ~7
    first = starts + ((2 + 2 * nb + 7) & ~7)
    return first[:, None] + np.cumsum(padded, axis=1) - padded, sizes


def _stack_words(data: np.ndarray, spans: Tuple[np.ndarray, np.ndarray],
                 bi: Optional[int]) -> np.ndarray:
    """Buffer ``bi`` of each chunk (``spans``, from :func:`_chunk_spans`)
    copied from ``data`` into one zero-padded uint32 word row each, with a
    word of padding past the longest (the rows the kernels take: each row
    is ``ops.pack_words(buffer, pad_words=1)`` zero-extended); an absent
    stream (``bi`` None) is a ``(C, 1)`` zero row each."""
    pos, sizes = spans
    if bi is None:
        return np.zeros((len(pos), 1), dtype=np.uint32)
    pos, sizes = pos[:, bi].tolist(), sizes[:, bi]
    out = np.zeros((len(pos), -(-int(sizes.max()) // 4) + 1), dtype=np.uint32)
    rows = out.view(np.uint8)
    for j, (p, n) in enumerate(zip(pos, sizes.tolist())):
        rows[j, :n] = data[p: p + n]
    return out


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
    :func:`~repro_torch.core.encodings_base.reorder_leaf_rows` pass.  Where
    each row is one entry (no repetition levels) and the kernels cover every
    needed chunk, the device route instead decodes only the requested
    entries (the ``miniblock_take`` kernel), so no chunk is decoded whole.

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
        # each stream's place among a chunk's buffers (None: absent): rep,
        # def, the first value buffer
        rep, dfn = leaf_proto.max_rep > 0, leaf_proto.max_def > 0
        self._slots = (0 if rep else None, int(rep) if dfn else None, int(rep) + int(dfn))

    def _decode_chunk(self, ci: int, raw: np.ndarray):
        cm = self.meta["chunks"][ci]
        bufs = _parse_chunk(raw)
        k = cm["n_entries"]
        ri, di, bi = self._slots
        rep = None if ri is None else unpack_levels(bufs[ri], k, self.proto.max_rep)
        defs = None if di is None else unpack_levels(bufs[di], k, self.proto.max_def)
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
        tr = io.tracer
        with tr.step("miniblock.locate"):
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
            offs = np.asarray(self.meta["chunk_offsets"], dtype=np.int64)
            sizes = np.array([self.meta["chunks"][c]["words"] * 8 for c in needed],
                             dtype=np.int64)

            plan = self._take_kernel_params(needed)

        # IO: every needed chunk exactly once, one phase-0 batch dispatch
        data, doffs = io.read_many(self.base + offs[needed], sizes, phase=0)
        if plan is not None:
            return self._take_on_device(needed, data, doffs, plan, c0, rows_before, urows,
                                        inv, io)

        # decode each chunk exactly once (numpy or batched on the device)
        decoded = self._decode_chunks(needed, data, doffs, io)
        with tr.step("miniblock.select"):
            tr.tally("miniblock.rows_on_host", len(urows))
            return self._select(decoded, needed, rows_before, urows, inv, io)

    def _select(self, decoded, needed, rows_before, urows, inv, io) -> ShreddedLeaf:
        """The requested rows' entries out of the decoded chunks, in request
        order (duplicates materialized)."""
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

    def _take_kernel_params(self, needed) -> Optional[List[tuple]]:
        """Each needed chunk's ``(n_entries, bits, ref)`` when a take selects
        its rows on the device, else None.  It does under ``decode='device'``
        for a column without repetition levels (each row is one entry, at
        ``row - rows_before[c0]`` of its chunk) when the kernels cover every
        needed chunk.  Every other take decodes its chunks whole and selects
        on the host, counting its fallbacks there."""
        if (self.decode != "device" or self.proto.max_rep > 0
                or len(needed) > ops.MAX_TAKE_CHUNKS):
            return None
        plan, _ = self._kernel_plan(needed)
        return None if any(p is None for p in plan) else plan

    def _take_on_device(self, needed, data, bounds, plan, c0, rows_before, urows, inv,
                        io) -> ShreddedLeaf:
        """The unique rows ``urows`` selected on the device: one
        ``miniblock_take`` launch decodes each row's entry alone, given as its
        chunk's place among ``needed`` and its place in that chunk; nulls
        are dropped on the host, and the rows fanned out to request order.
        Chunk ``i`` of ``needed`` is ``data[bounds[i]:bounds[i + 1]]``."""
        tr = io.tracer
        tr.tally("miniblock.chunks", len(needed))
        tr.tally("miniblock.chunks_staged", len(needed))
        lt = self.proto.leaf_type
        vpe = lt.size if isinstance(lt, T.FixedSizeList) else 1
        def_bits = level_bits(self.proto.max_def)
        with tr.step("miniblock.parse"):
            spans = _chunk_spans(data, bounds[:-1], self._slots[2] + 1)
        with tr.step("miniblock.pack"):
            params = np.array(plan, dtype=np.int32)
            def_words, val_words = (_stack_words(data, spans, bi) for bi in self._slots[1:])

        with tr.step("miniblock.select"):
            tr.tally("miniblock.rows_on_card", len(urows))
            pairs = (np.searchsorted(needed, c0) * MAX_CHUNK_VALUES
                     + (urows - rows_before[c0])).astype(np.int32)
            (got,) = ops.round_trip(
                "miniblock_take", (def_words, val_words, params, pairs), self.device, tr,
                def_bits=def_bits, vpe=vpe, fill=0)
            defs = got[:, vpe].astype(np.uint8) if def_bits else None
            dec = leaf_slice(self.proto, None, defs, self._kernel_values(got[:, :vpe], defs),
                             len(urows))
            # useful bytes over unique rows, as _select counts them
            io.note_useful(value_bytes(dec.values))
            return reorder_leaf_rows(dec, inv)

    def _kernel_values(self, dense: np.ndarray, defs: Optional[np.ndarray]) -> A.Array:
        """Dense kernel output, ``vpe`` int32 values an entry, as the leaf's
        values array with the null entries (``defs`` nonzero) dropped."""
        lt = self.proto.leaf_type
        fsl = isinstance(lt, T.FixedSizeList)
        if defs is not None:
            dense = dense[defs == 0]
        dense = dense.astype(lt.child.dtype if fsl else lt.dtype)
        ones = np.ones(len(dense), bool)
        return (A.FixedSizeListArray(lt.with_nullable(False), ones, dense) if fsl
                else A.PrimitiveArray(lt.with_nullable(False), ones, dense[:, 0]))

    # ------------------------------------------------------------------
    def _decode_chunks(self, chunk_ids, data, bounds, io) -> List[tuple]:
        """Decode chunks ``chunk_ids`` (chunk ``i`` is
        ``data[bounds[i]:bounds[i + 1]]``) exactly once each.  Under
        ``decode='device'``, integer chunks (bit-packed or FoR byte-packed
        values; flat, nested or fixed-size-list; any rep/def level width) are
        batch-decoded by one ``miniblock_decode`` launch; the rest fall back
        to the numpy path per chunk, each fallback counted under its reason
        (``ops.fallbacks``, and the IO path's tracer).  Under the tracer's
        steps the chunks are counted (``miniblock.chunks``), and so are those
        whose word rows the device route staged (``miniblock.chunks_staged``)."""
        tr = io.tracer
        tr.tally("miniblock.chunks", len(chunk_ids))
        if self.decode == "device":
            routed = self._decode_chunks_device(chunk_ids, data, bounds, io)
            if routed is not None:
                return routed
        with tr.step("miniblock.decode"):
            return [self._decode_chunk(c, data[bounds[i]: bounds[i + 1]])
                    for i, c in enumerate(chunk_ids)]

    # The eligibility rules and fallback slugs keep the JAX package's names
    # (its Pallas kernel's), so the same chunks reach the kernel and the
    # fallback counts read the same on both.

    def _pallas_ineligible_reason(self) -> Optional[str]:
        """Column-level kernel coverage: integer primitives and fixed-size
        lists of integers, with any (column-constant) rep/def level widths;
        per-chunk value codecs are checked in :meth:`_chunk_coverage`.
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
    def _chunk_coverage(bufmeta: Dict) -> tuple:
        """Per-chunk value-codec coverage: ``((bits, ref), None)`` when the
        kernels' int32 extract reads this chunk, else ``(None, reason)``.
        ``bitpack`` is a dense bit stream (ref 0); ``bytepack`` is
        byte-aligned FoR (a float payload stored as raw bytes has no ref)
        whose reference must keep the int32 arithmetic exact."""
        codec = bufmeta.get("codec")
        if codec == "bitpack":
            bits, ref = bufmeta["bits"], 0
        elif codec == "bytepack":
            ref = bufmeta.get("ref")
            if ref is None:
                return None, "float-bytes"
            bits = 8 * bufmeta["width"]
        else:
            return None, f"opaque-codec:{codec}"
        if bits > 31:
            return None, ">31-bit"
        if ref < -(1 << 31) or ref + (1 << bits) - 1 > (1 << 31) - 1:
            return None, "ref-overflow"
        return (bits, ref), None

    def _kernel_plan(self, chunk_ids) -> Tuple[List[Optional[tuple]], Dict[str, int]]:
        """The kernels' coverage of chunks ``chunk_ids``, from metadata
        alone: each chunk's ``(n_entries, bits, ref)`` (None where they
        cannot read it), and each fallback reason with its count of chunks.
        A column out of their reach is every chunk's reason."""
        reason = self._pallas_ineligible_reason()
        if reason is not None:
            return [None] * len(chunk_ids), {reason: len(chunk_ids)}
        plan: List[Optional[tuple]] = []
        reasons: Dict[str, int] = {}
        for c in chunk_ids:
            cm = self.meta["chunks"][c]
            params, reason = self._chunk_coverage(cm["bufmeta"][self._slots[2]])
            plan.append(None if params is None else (cm["n_entries"], *params))
            if reason is not None:
                reasons[reason] = reasons.get(reason, 0) + 1
        return plan, reasons

    def _decode_chunks_device(self, chunk_ids, data, bounds, io) -> Optional[List[tuple]]:
        tr = io.tracer
        with tr.step("miniblock.parse"):
            # metadata-only coverage first: only covered chunks' headers are
            # read, and an all-fallback batch costs no parse work at all
            plan, reasons = self._kernel_plan(chunk_ids)
            for r in sorted(reasons):  # one count per reason per batch
                ops.note_fallback("miniblock", r, tr, n_chunks=reasons[r])
            sel = [i for i, p in enumerate(plan) if p is not None]
            tr.tally("miniblock.chunks_staged", len(sel))
            if not sel:
                return None
            spans = _chunk_spans(data, np.asarray(bounds)[sel], self._slots[2] + 1)

        lt = self.proto.leaf_type
        vpe = lt.size if isinstance(lt, T.FixedSizeList) else 1
        rep_bits = level_bits(self.proto.max_rep)
        def_bits = level_bits(self.proto.max_def)
        with tr.step("miniblock.pack"):
            params = np.array([plan[i] for i in sel], dtype=np.int32)
            tile = -(-int(params[:, 0].max()) // 128) * 128
            host = (*(_stack_words(data, spans, bi) for bi in self._slots), params)
        rep_np, def_np, vals_np = ops.round_trip(
            "miniblock_decode", host, self.device, tr, rep_bits=rep_bits,
            def_bits=def_bits, vpe=vpe, tile_entries=tile, fill=0)

        out: List[tuple] = [None] * len(chunk_ids)
        with tr.step("miniblock.unpack"):
            for j, i in enumerate(sel):
                k = plan[i][0]
                rep = rep_np[j, :k].astype(np.uint8) if rep_bits else None
                defs = def_np[j, :k].astype(np.uint8) if def_bits else None
                vals = self._kernel_values(vals_np[j, : k * vpe].reshape(k, vpe), defs)
                out[i] = (rep, defs, vals)
        if len(sel) < len(plan):
            with tr.step("miniblock.decode"):
                for i, p in enumerate(plan):
                    if p is None:
                        out[i] = self._decode_chunk(chunk_ids[i],
                                                    data[bounds[i]: bounds[i + 1]])
        return out

    def scan(self, io, io_chunk: int = 8 << 20) -> ShreddedLeaf:
        tr = io.tracer
        offs = self.meta["chunk_offsets"]
        total = (offs[-1] + self.meta["chunks"][-1]["words"] * 8) if offs else 0
        raw_parts = []
        for p in range(0, total, io_chunk):
            raw_parts.append(io.read(self.base + p, min(io_chunk, total - p), phase=0))
        with tr.step("miniblock.concat"):
            raw = np.concatenate(raw_parts) if raw_parts else np.zeros(0, np.uint8)
        # the chunks lie back to back: chunk i ends where chunk i + 1 begins
        decoded = self._decode_chunks(np.arange(len(offs)), raw, [*offs, total], io)
        with tr.step("miniblock.concat"):
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

