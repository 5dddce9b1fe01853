"""Plain PyTorch versions of the port's kernels.

They compute the same functions as the CUDA kernels with ordinary tensor
ops, on any device.  The wrappers in :mod:`repro_torch.kernels.ops` run them
for tensors that lie on the CPU; the tests hold them against the JAX
package's oracles, and ``chip_smoke.py`` holds each CUDA kernel against its
plain version on the card.  :func:`miniblock_case` makes the seeded inputs
of those sweeps; :func:`ivf_topk_mismatches` is their comparison rule for
float distances.

uint32 arithmetic is carried in int64 and masked to 32 bits, since torch has
no general unsigned 32-bit arithmetic.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["bitunpack_ref", "miniblock_decode_ref", "miniblock_slice_slots",
           "miniblock_take_ref", "miniblock_take_words_ref", "miniblock_take_case",
           "miniblock_take_cases",
           "fullzip_gather_ref", "ivf_topk_ref", "ivf_topk_mismatches", "ivf_topk_scale",
           "miniblock_case", "miniblock_edge_cases", "bitunpack_cases", "gather_cases",
           "ivf_hazard_cases", "at_offset", "IVF_ID_SENTINEL"]

_U32 = 0xFFFFFFFF

# Padding / exhaustion marker of ivf_topk: never a valid row id (row ids are
# checked to fit in 31 bits), and maximal, so the lowest-id tie-break never
# prefers it over a real candidate.
IVF_ID_SENTINEL = (1 << 31) - 1


def _extract(words: torch.Tensor, bitpos: torch.Tensor, bits,
             mask) -> torch.Tensor:
    """Little-endian ``bits``-wide field at ``bitpos`` of a uint32 word row
    (int64-held).  Word indices clamp to the row, as JAX gathers do."""
    last = words.shape[-1] - 1
    w = torch.clamp(bitpos // 32, max=last)
    sh = bitpos % 32
    w0 = torch.gather(words, -1, w)
    w1 = torch.gather(words, -1, torch.clamp(w + 1, max=last))
    hi = torch.where(sh > 0, (w1 << ((32 - sh) & 31)) & _U32,
                     torch.zeros_like(w1))
    return ((w0 >> sh) | hi) & mask


def _u32(t: torch.Tensor) -> torch.Tensor:
    """uint32 words -> int64 holding the same unsigned values."""
    return t.view(torch.int32).to(torch.int64) & _U32


def _wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 with two's-complement wrap-around."""
    return (((x + (1 << 31)) & _U32) - (1 << 31)).to(torch.int32)


def bitunpack_ref(words: torch.Tensor, n: int, bits: int) -> torch.Tensor:
    """Unpack ``n`` little-endian ``bits``-wide values (1 <= bits <= 32)
    from a uint32 word stream -> ``(n,)`` uint32.  Bit positions wrap at
    2**32 and word indices clamp to the stream, as the reference's uint32
    arithmetic and gathers do."""
    j = torch.arange(n, device=words.device, dtype=torch.int64)
    bitpos = (j * bits) & _U32
    mask = _U32 if bits >= 32 else (1 << bits) - 1
    return _wrap_i32(_extract(_u32(words), bitpos, bits, mask)).view(torch.uint32)


def miniblock_decode_ref(
    rep_words: torch.Tensor,  # (C, RW) uint32 bit-packed rep levels (dummy if absent)
    def_words: torch.Tensor,  # (C, DW) uint32 bit-packed def levels (dummy if absent)
    val_words: torch.Tensor,  # (C, VW) uint32 bit/byte-packed FoR values
    n_entries: torch.Tensor,  # (C,) int32 valid entries per chunk
    vbits: torch.Tensor,  # (C,) int32 value bit width per chunk
    refs: torch.Tensor,  # (C,) int32 frame-of-reference per chunk
    max_entries: int,
    rep_bits: int,
    def_bits: int,
    vpe: int = 1,
    fill: int = 0,
):
    """Decode C mini-block chunks -> ``(rep, defs, vals)`` int32 tiles.

    Per chunk: unpack the rep/def level streams (widths are column
    constants; 0 = stream absent), unpack the sparse packed values (``vpe``
    consecutive values per valid entry) and scatter them densely with
    ``fill`` at nulls.  Entries past a chunk's ``n_entries`` read as 0 /
    ``fill``.
    """
    dev = val_words.device
    C = val_words.shape[0]
    rw, dw, vw = _u32(rep_words), _u32(def_words), _u32(val_words)
    n = n_entries.to(device=dev, dtype=torch.int64).view(C, 1)
    bits = vbits.to(device=dev, dtype=torch.int64).view(C, 1)
    ref = refs.to(device=dev, dtype=torch.int64).view(C, 1)

    j = torch.arange(max_entries, device=dev, dtype=torch.int64).expand(C, -1)
    in_range = j < n
    zeros = torch.zeros((C, max_entries), dtype=torch.int64, device=dev)
    if rep_bits:
        rep = _extract(rw, j * rep_bits, rep_bits, (1 << rep_bits) - 1)
        rep = torch.where(in_range, rep, zeros)
    else:
        rep = zeros
    if def_bits:
        d = _extract(dw, j * def_bits, def_bits, (1 << def_bits) - 1)
        valid = (d == 0) & in_range
        d = torch.where(in_range, d, zeros)
    else:
        valid = in_range
        d = zeros
    vidx = torch.cumsum(valid.to(torch.int64), dim=1) - 1

    k = torch.arange(max_entries * vpe, device=dev, dtype=torch.int64)
    e = (k // vpe).expand(C, -1)
    valid_k = torch.gather(valid, 1, e)
    slot = torch.gather(vidx, 1, e) * vpe + k % vpe
    bitpos = torch.where(valid_k, slot, torch.zeros_like(slot)) * bits
    mask = torch.where(bits >= 32, torch.full_like(bits, _U32),
                       (1 << torch.clamp(bits, max=31)) - 1)
    vals = _extract(vw, bitpos, bits, mask)
    out = torch.where(valid_k, _wrap_i32(_wrap_i32(vals).to(torch.int64) + ref),
                      torch.full_like(vals, fill, dtype=torch.int32))
    return rep.to(torch.int32), d.to(torch.int32), out


def miniblock_slice_slots(def_words: torch.Tensor, n_entries: torch.Tensor, def_bits: int,
                          tile: int, slice_entries: int) -> torch.Tensor:
    """The first value slot of each slice of ``slice_entries`` entries, as
    ``csrc/miniblock_decode.cu`` counts it: the valid entries before the
    slice.  Slices start at multiples of 32 entries, so the prefix is whole
    def words; for power-of-two widths each word's zero fields are counted at
    once (each field's bits folded onto its lowest bit, masked, popcounted),
    other widths field by field.  ``(C, slices)`` int64; a slice with no
    entry below its chunk's ``n_entries`` reads 0 (the kernel needs none)."""
    C = def_words.shape[0]
    dev = def_words.device
    starts = torch.arange(0, tile, slice_entries, device=dev, dtype=torch.int64)
    n = n_entries.to(device=dev, dtype=torch.int64).view(C, 1)
    if not def_bits:
        before = starts.expand(C, -1)
    elif def_bits & (def_bits - 1) == 0:
        words = _u32(def_words)
        idx = torch.clamp(torch.arange(tile * def_bits // 32, device=dev),
                          max=words.shape[1] - 1).expand(C, -1)
        x = torch.gather(words, 1, idx)
        s = 1
        while s < def_bits:
            x = x | (x >> s)
            s *= 2
        x = x & sum(1 << b for b in range(0, 32, def_bits))
        nonzero = sum((x >> b) & 1 for b in range(32))
        zeros = torch.cumsum(32 // def_bits - nonzero, dim=1)
        zeros = torch.cat([torch.zeros((C, 1), dtype=torch.int64, device=dev), zeros], 1)
        before = zeros[:, starts * def_bits // 32]
    else:
        j = torch.arange(tile, device=dev, dtype=torch.int64).expand(C, -1)
        d = _extract(_u32(def_words), j * def_bits, def_bits, (1 << def_bits) - 1)
        zeros = torch.cumsum((d == 0).to(torch.int64), dim=1)
        zeros = torch.cat([torch.zeros((C, 1), dtype=torch.int64, device=dev), zeros], 1)
        before = zeros[:, starts]
    return torch.where(n > starts, before, torch.zeros_like(before))


TAKE_ENTRY_BITS = 12  # a requested entry is (chunk << 12) | entry, entry < 4,096


def miniblock_take_ref(defs: torch.Tensor, vals: torch.Tensor, n_entries: torch.Tensor,
                       pairs: torch.Tensor, def_bits: int, vpe: int = 1,
                       fill: int = 0) -> torch.Tensor:
    """The requested entries of C decoded mini-block chunks -> ``(R, vpe +
    (def_bits > 0))`` int32: each entry's ``vpe`` values and, where
    ``def_bits`` > 0, its definition level in the last column.

    ``defs`` and ``vals`` are :func:`miniblock_decode_ref`'s ``(C, tile)``
    and ``(C, tile * vpe)`` tiles (``fill`` at nulls); ``pairs`` is ``(R,)``
    int32 ``(j << 12) | e``, entry ``e`` of chunk ``j``.  A pair outside its
    chunk (``j`` not in ``[0, C)``, or ``e`` not below ``n_entries[j]``)
    reads ``fill`` everywhere and definition level -1.  This is the index
    that ``csrc/miniblock_take.cu`` consumes, applied to whole decoded
    chunks: the kernel decodes only the requested entries.
    """
    dev = vals.device
    C = vals.shape[0]
    p = pairs.to(device=dev, dtype=torch.int64)
    j, e = p >> TAKE_ENTRY_BITS, p & ((1 << TAKE_ENTRY_BITS) - 1)
    inside = (j >= 0) & (j < C)
    jc = torch.where(inside, j, torch.zeros_like(j))
    if C:
        inside &= e < n_entries.to(device=dev, dtype=torch.int64)[jc]
    ec = torch.where(inside, e, torch.zeros_like(e))
    out = torch.full((len(p), vpe + (1 if def_bits else 0)), fill, dtype=torch.int32,
                     device=dev)
    if C:
        cols = ec.unsqueeze(1) * vpe + torch.arange(vpe, device=dev)
        out[:, :vpe] = torch.where(inside.unsqueeze(1), vals[jc.unsqueeze(1), cols],
                                   out[:, :vpe])
    if def_bits:
        out[:, vpe] = torch.where(inside, defs[jc, ec], -1) if C else -1
    return out


def miniblock_take_words_ref(def_words: torch.Tensor, val_words: torch.Tensor,
                             params: torch.Tensor, pairs: torch.Tensor, def_bits: int,
                             vpe: int = 1, fill: int = 0) -> torch.Tensor:
    """``miniblock_take`` on the inputs the kernel takes, on any device: the
    chunks decoded whole by :func:`miniblock_decode_ref`, then
    :func:`miniblock_take_ref`."""
    C = val_words.shape[0]
    tile = -(-max(1, int(params[:, 0].max()) if C else 1) // 128) * 128
    _, defs, vals = miniblock_decode_ref(
        torch.zeros((C, 1), dtype=torch.uint32, device=val_words.device), def_words,
        val_words, params[:, 0], params[:, 1], params[:, 2], tile, 0, def_bits, vpe, fill)
    return miniblock_take_ref(defs, vals, params[:, 0], pairs, def_bits, vpe, fill)


def fullzip_gather_ref(zipped: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Random-access take on a fixed-stride full-zip buffer:
    ``out[i] = zipped[rows[i]]`` (duplicates allowed)."""
    return zipped[rows.to(torch.int64)]


def ivf_topk_ref(queries: torch.Tensor, cands: torch.Tensor, ids: torch.Tensor,
                 k: int, mask=None):
    """Batched squared-L2 distance + deterministic top-k selection.

    ``queries``: (Q, D) float32; ``cands``: (N, D) float32; ``ids``: (N,)
    int32 candidate row ids; ``mask``: optional (Q, N), nonzero where
    candidate n is eligible for query q.  Distances are
    ``(qq - 2 * q.c) + cc`` in float32 (a float32 matrix product, which
    PyTorch runs without TF32 unless asked to).

    Returns ``(dists, winners)`` of shape (Q, k): ``k`` masked-argmin sweeps,
    each taking the smallest distance and, among equal distances, the lowest
    id, then removing every entry equal to that ``(distance, id)`` pair.  So
    the result is the k smallest *distinct* ``(distance, id)`` pairs in
    lexicographic order, padded with ``(inf, IVF_ID_SENTINEL)`` past the
    eligible count.  A NaN distance of an eligible candidate wins every
    sweep's minimum and equals nothing, so its query's row reads
    ``(nan, IVF_ID_SENTINEL)`` throughout — the reference's behaviour.
    """
    qn, n = queries.shape[0], cands.shape[0]
    dev = queries.device
    out_d = torch.full((qn, k), float("inf"), dtype=torch.float32, device=dev)
    out_i = torch.full((qn, k), IVF_ID_SENTINEL, dtype=torch.int32, device=dev)
    if n == 0 or qn == 0:
        return out_d, out_i
    qq = (queries * queries).sum(1, keepdim=True)                  # (Q, 1)
    cc = (cands * cands).sum(1).unsqueeze(0)                        # (1, N)
    d = qq - 2.0 * (queries @ cands.T) + cc                         # (Q, N)
    sent = torch.tensor(IVF_ID_SENTINEL, dtype=torch.int32, device=dev)
    idrow = ids.to(torch.int32).unsqueeze(0).expand(qn, n)
    if mask is not None:
        eligible = mask != 0
        d = torch.where(eligible, d, torch.tensor(float("inf"), device=dev))
        idrow = torch.where(eligible, idrow, sent)
    inf = torch.tensor(float("inf"), dtype=torch.float32, device=dev)
    for j in range(k):
        m = d.amin(1, keepdim=True)                                 # NaN wins
        tie = torch.where(d == m, idrow, sent)
        wid = tie.amin(1, keepdim=True)
        out_d[:, j] = m[:, 0]
        out_i[:, j] = wid[:, 0]
        sel = (d == m) & (idrow == wid)
        d = torch.where(sel, inf, d)
        idrow = torch.where(sel, sent, idrow)
    return out_d, out_i


def ivf_topk_mismatches(d, w, want_d, want_w, rtol: float = 1e-6, scale=None):
    """Compare an ``ivf_topk`` result ``(d, w)`` with the plain version's
    ``(want_d, want_w)``, all (Q, k) host arrays.

    Distances: NaN and inf at the same places, the rest within
    ``rtol * (|want| + scale)``; ``scale`` (per query, default 0) is the size
    of the terms of ``(qq - 2 q.c) + cc`` where they dwarf the distance.
    Ids: exact, except inside a near-tie group — consecutive plain distances
    within the same tolerance — where the id *sets* must match, since a
    different summation order may order a near tie either way.
    Returns ``(mismatching entries, near-tie groups)``.
    """
    d, want_d = np.asarray(d, np.float64), np.asarray(want_d, np.float64)
    w, want_w = np.asarray(w), np.asarray(want_w)
    sc = np.zeros((d.shape[0], 1)) if scale is None else \
        np.asarray(scale, np.float64).reshape(-1, 1)
    tol = rtol * (np.abs(np.nan_to_num(want_d, posinf=0.0)) + sc)
    with np.errstate(invalid="ignore"):  # inf - inf where both pad
        same = (np.isnan(d) & np.isnan(want_d)) | (d == want_d) | \
            (np.abs(d - want_d) <= tol)
    bad = int((~same).sum())
    groups = 0
    for i in range(d.shape[0]):
        j, k = 0, d.shape[1]
        while j < k:
            e = j + 1
            while e < k and np.isfinite(want_d[i, e]) and \
                    abs(want_d[i, e] - want_d[i, e - 1]) <= tol[i, e]:
                e += 1
            if e - j > 1:
                groups += 1
                if sorted(w[i, j:e].tolist()) != sorted(want_w[i, j:e].tolist()):
                    bad += e - j
            else:
                bad += int(w[i, j] != want_w[i, j])
            j = e
    return bad, groups


def ivf_topk_scale(queries, cands) -> np.ndarray:
    """Per query, ``|q|^2 + max |c|^2``: the size of the terms of
    ``(qq - 2 q.c) + cc``.  Their rounding, which differs by about an ulp
    between summation orders, is an ulp of this, not of the distance — a
    candidate next to its query has a distance far below it."""
    q = np.asarray(queries.cpu() if torch.is_tensor(queries) else queries, np.float64)
    c = np.asarray(cands.cpu() if torch.is_tensor(cands) else cands, np.float64)
    norms = (c * c).sum(1)
    # a NaN row scores NaN whatever the tolerance: size the terms without it
    cc = np.nanmax(norms) if np.isfinite(norms).any() else 0.0
    return (q * q).sum(1) + cc


def miniblock_case(rng: np.random.Generator, rep_bits: int, def_bits: int, vpe: int,
                   n_chunks: int, tile: int = 1024, max_bits: int = 24,
                   ref_range=(-100, 100), *, n_range=None, nulls=None, min_bits: int = 0,
                   extra_words: int = 0):
    """Random ``miniblock_decode`` inputs as numpy arrays: ``(rep_words,
    def_words, val_words, params)``.  Each chunk has 1..``tile`` entries
    (or a count drawn from ``n_range``, both ends included), random levels
    at the given widths (``nulls="none"``: every def level 0; ``"all"``:
    none 0), ``vpe`` values per valid entry at a width of
    ``min_bits``..``max_bits`` bits, and a frame of reference from
    ``ref_range``; rows are ragged and zero-padded, as the reader stacks
    them, with ``extra_words`` more words of padding."""
    from ..core.compression import bitpack  # both import this module
    from .ops import pack_words

    C = n_chunks
    rep_words = np.zeros((C, (tile * rep_bits + 31) // 32 + 1 + extra_words
                          if rep_bits else 1), np.uint32)
    def_words = np.zeros((C, (tile * def_bits + 31) // 32 + 1 + extra_words
                          if def_bits else 1), np.uint32)
    val_words = np.zeros((C, (tile * vpe * max_bits + 31) // 32 + 1 + extra_words), np.uint32)
    params = np.zeros((C, 3), np.int32)
    lo, hi = n_range or (1, tile)
    for c in range(C):
        n = int(rng.integers(lo, hi + 1))
        bits = int(rng.integers(min_bits, max_bits + 1))
        if not def_bits or nulls == "none":
            defs = np.zeros(n, np.uint64)
        else:
            defs = rng.integers(1 if nulls == "all" else 0, 2 ** def_bits, n, dtype=np.uint64)
        if rep_bits:
            w = pack_words(bitpack(rng.integers(0, 2 ** rep_bits, n, dtype=np.uint64), rep_bits))
            rep_words[c, : len(w)] = w
        if def_bits:
            w = pack_words(bitpack(defs, def_bits))
            def_words[c, : len(w)] = w
        vals = rng.integers(0, 2 ** bits, int((defs == 0).sum()) * vpe, dtype=np.uint64)
        w = pack_words(bitpack(vals, bits))
        val_words[c, : len(w)] = w
        params[c] = [n, bits, int(rng.integers(*ref_range))]
    return rep_words, def_words, val_words, params


def miniblock_edge_cases(rng: np.random.Generator):
    """The ``miniblock_decode`` sweep of the shapes its slices, runs and
    slot tables meet, as ``(label, (rep_words, def_words,
    val_words, params), kwargs)``: def widths that straddle words and are
    counted field by field (3, 5, 7) beside power-of-two ones, chunks with
    fewer than 32 entries and counts off any run or slice, all-null and
    null-free chunks, 1, 3, 4, 32 and 80 values per entry (4,096 x 32 is
    ``MAX_TILE_VALUES``; 80 at 31 bits: 2,480 value bits an entry),
    value widths 0 and 31 with a frame of reference that wraps, and word
    rows of every width modulo 4."""
    wrap = (1 << 30, (1 << 31) - 1)
    cases = []
    for db in (1, 2, 3, 5, 7):
        cases.append((f"def_bits={db}", (1, db, 1, 5, 3072), {}))
    for n_range in ((1, 31), (1025, 1027), (2047, 2049)):
        cases.append((f"n in {n_range}", (1, 3, 1, 4, 3072), {"n_range": n_range}))
    for nulls in ("all", "none"):
        for db in (2, 3):
            cases.append((f"nulls={nulls} def_bits={db}", (1, db, 1, 4, 2688),
                          {"nulls": nulls}))
    for vpe, tile in ((3, 1024), (4, 2048), (32, 4096)):
        cases.append((f"vpe={vpe} tile={tile}", (0, 2, vpe, 3, tile), {"max_bits": 31}))
    cases.append(("vpe=80 tile=128, 31-bit values", (0, 2, 80, 3, 128),
                  {"nulls": "none", "n_range": (120, 128), "min_bits": 31, "max_bits": 31}))
    cases.append(("value width 0", (1, 2, 1, 3, 1024), {"max_bits": 0}))
    cases.append(("value width 31, FoR wraps", (1, 2, 1, 3, 1024),
                  {"min_bits": 31, "max_bits": 31, "ref_range": wrap}))
    for extra in (1, 2, 3):
        cases.append((f"rows padded by {extra} words", (1, 5, 1, 3, 1024),
                      {"extra_words": extra}))
    for label, (rb, db, vpe, C, tile), kw in cases:
        case = miniblock_case(rng, rb, db, vpe, C, tile, kw.pop("max_bits", 24),
                              kw.pop("ref_range", (-100, 100)), **kw)
        yield label, case, dict(rep_bits=rb, def_bits=db, vpe=vpe, tile_entries=tile,
                                fill=-9)


def miniblock_take_case(rng: np.random.Generator, def_bits: int, vpe: int, n_chunks: int,
                        n_rows: int, tile: int = 4096, max_bits: int = 24,
                        ref_range=(-100, 100), **kw):
    """Random ``miniblock_take`` inputs as numpy arrays: ``(def_words,
    val_words, params, pairs)``, the chunks of :func:`miniblock_case` (no
    repetition levels; ``kw`` goes to it) and ``n_rows`` requested entries in
    random order: every chunk's first and last entry where there are rows
    enough, the rest uniform over the chunks' entries, one in eight a
    duplicate of an earlier one."""
    _, def_words, val_words, params = miniblock_case(
        rng, 0, def_bits, vpe, n_chunks, tile, max_bits, ref_range, **kw)
    n = params[:, 0].astype(np.int64)
    ends = [(c, e) for c in range(n_chunks) for e in sorted({0, int(n[c]) - 1})]
    ends = ends[: n_rows // 2]
    j = rng.integers(0, n_chunks, n_rows - len(ends))
    e = (rng.random(len(j)) * n[j]).astype(np.int64)
    pairs = np.array([c << TAKE_ENTRY_BITS | x for c, x in ends]
                     + list(j << TAKE_ENTRY_BITS | e), dtype=np.int64)
    dup = rng.random(n_rows) < 0.125
    dup[0] = False
    pairs[dup] = pairs[rng.integers(0, np.maximum(1, np.nonzero(dup)[0]))]
    return def_words, val_words, params, rng.permutation(pairs).astype(np.int32)


def miniblock_take_cases(rng: np.random.Generator):
    """The ``miniblock_take`` sweep, as ``(label, (def_words, val_words,
    params, pairs), kwargs)``: def widths counted word by word (1, 2) and
    field by field (3, 5), with nulls everywhere or nowhere; value widths 1,
    14 and 31 and a frame of reference that wraps; 1, 3, 4 and 32 values an
    entry; one row, rows past their chunk, and the date take's shape (40
    chunks of 4,096 entries at 14 bits, 42 rows)."""
    wrap = (1 << 30, (1 << 31) - 1)
    cases = []
    for db in (0, 1, 2, 3, 5):
        cases.append((f"def_bits={db}", (db, 1, 6, 97), {}))
    for nulls in ("all", "none"):
        cases.append((f"nulls={nulls}", (2, 1, 4, 40), {"nulls": nulls}))
    for bits in (1, 14, 31):
        cases.append((f"value width {bits}", (1, 1, 5, 64),
                      {"min_bits": bits, "max_bits": bits}))
    cases.append(("value width 31, FoR wraps", (2, 1, 4, 64),
                  {"min_bits": 31, "max_bits": 31, "ref_range": wrap}))
    for vpe, db in ((3, 0), (4, 1), (32, 2)):
        cases.append((f"vpe={vpe} def_bits={db}", (db, vpe, 4, 50), {"max_bits": 31}))
    cases.append(("one row", (1, 1, 3, 1), {}))
    cases.append(("date take: 40 x 4,096 at 14 bits, 42 rows", (0, 1, 40, 42),
                  {"n_range": (4096, 4096), "min_bits": 14, "max_bits": 14}))
    for label, (db, vpe, C, R), kw in cases:
        tile = 4096 if vpe * 4096 <= 1 << 17 else 1024
        case = miniblock_take_case(rng, db, vpe, C, R, tile, kw.pop("max_bits", 24),
                                   kw.pop("ref_range", (-100, 100)), **kw)
        yield label, case, dict(def_bits=db, vpe=vpe, fill=-9)
    dw, vw, params, pairs = miniblock_take_case(rng, 1, 2, 3, 20, 512)
    n = int(params[0, 0])
    pairs[:4] = [3 << TAKE_ENTRY_BITS, n, -1, (1 << 31) - 1]  # no chunk 3; entry n; negative
    yield "rows past their chunk", (dw, vw, params, pairs), dict(def_bits=1, vpe=2, fill=-9)


def bitunpack_cases(rng: np.random.Generator):
    """The ``bitunpack`` sweep of its units' edges, as ``(label, values,
    words, bits, offset)`` numpy inputs: every width 1..32 at n = 1, 3, 31,
    33 and 4,097 values (tails off 4 and off a 128-value group), words given
    as exactly the ``ceil(n * bits / 32)`` the values span, and at n = 4,097
    also a ``words`` view 4 bytes past an aligned base."""
    from ..core.compression import bitpack
    from .ops import pack_words

    for bits in range(1, 33):
        for n in (1, 3, 31, 33, 4097):
            v = rng.integers(0, 1 << bits, n, dtype=np.uint64)
            words = pack_words(bitpack(v, bits), pad_words=0)
            assert len(words) == -(-n * bits // 32)
            for offset in ((0, 4) if n == 4097 else (0,)):
                yield f"bits={bits} n={n} +{offset}", v, words, bits, offset


def at_offset(a: np.ndarray, device, offset: int = 0) -> torch.Tensor:
    """``a`` as a contiguous tensor on ``device`` whose data starts ``offset``
    bytes past an allocation's (aligned) base: a sliced view, as a reader
    hands out a window of a larger buffer."""
    a = np.ascontiguousarray(a)
    flat = torch.empty(a.nbytes + offset, dtype=torch.uint8, device=device)
    view = flat[offset:].view(torch.from_numpy(a[:0]).dtype).view(a.shape)
    view.copy_(torch.from_numpy(a))
    return view


def gather_cases(rng: np.random.Generator, n_rows: int = 300):
    """The ``fullzip_gather`` sweep as numpy inputs ``(label, zipped, rows,
    offset)``: strides from 1 byte to rows larger than a 16 KB ring slot (up
    to the paged KV cache's 81,920-byte block rows, five slots each),
    ``n_take`` of 0, 1, a few, and not a multiple of any stage depth, one
    heavily duplicated request, and ``zipped`` views whose base sits
    ``offset`` bytes past an aligned one."""
    for stride in (1, 8, 16, 24, 33, 129, 136, 512, 1536, 16400, 40000, 81920):
        zipped = rng.integers(0, 256, (n_rows, stride), dtype=np.uint8)
        for n_take in (0, 1, 7, 64, 1000, 1001):
            rows = rng.integers(0, n_rows, n_take).astype(np.int32)
            yield f"stride={stride} n_take={n_take}", zipped, rows, 0
    zipped = rng.integers(0, 256, (n_rows, 1536), dtype=np.uint8)
    yield "one row 5,000 times", zipped, np.full(5000, 5, np.int32), 0
    for stride in (129, 1536):
        zipped = rng.integers(0, 256, (n_rows, stride), dtype=np.uint8)
        rows = rng.integers(0, n_rows, 257).astype(np.int32)
        for offset in (1, 4, 8, 16):
            yield f"stride={stride} base+{offset}", zipped, rows, offset


def ivf_hazard_cases(rng: np.random.Generator, n: int = 40_000, dim: int = 64):
    """Inputs that stress ``ivf_topk``'s running threshold and per-block
    lists, as numpy ``(label, queries, cands, ids, k, mask)``: candidates in
    descending distance (each one beats the threshold, so the survivor
    buffer fills on every tile), equal (distance, id) pairs half the matrix
    apart (in different blocks), queries with no or few eligible
    candidates, a NaN row eligible for some queries only, and candidate
    counts below a block and off any tile multiple, at k = 1, 10, 64, 256
    and 1,024."""
    dirs = rng.standard_normal((n, dim))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    radius = 1.0 + np.arange(n, 0, -1) / n
    desc = (dirs * radius[:, None]).astype(np.float32)
    ids = np.arange(n, dtype=np.int32)
    for k in (1, 10, 64, 256, 1024):
        yield (f"descending k={k}", np.zeros((3, dim), np.float32), desc, ids, k,
               None)
    half = rng.standard_normal((n // 2, dim)).astype(np.float32)
    dup = np.concatenate([half, half])
    dup_ids = np.concatenate([ids[: n // 2], ids[: n // 2]])
    q = rng.standard_normal((5, dim)).astype(np.float32)
    for k in (10, 64):
        yield f"duplicates k={k}", q, dup, dup_ids, k, None
    mask = rng.integers(0, 2, (4, n)).astype(np.uint8)
    mask[1] = 0
    mask[2] = 0
    mask[2, rng.choice(n, 5, replace=False)] = 1
    c = rng.standard_normal((n, dim)).astype(np.float32)
    for k in (10, 256):
        yield (f"no / 5 eligible k={k}", rng.standard_normal((4, dim)).astype(np.float32),
               c, rng.permutation(n).astype(np.int32), k, mask)
    c = rng.standard_normal((1900, dim)).astype(np.float32)
    c[5, 0] = np.nan
    nan_mask = np.ones((3, 1900), np.uint8)
    nan_mask[0, 5] = 0
    yield ("NaN row eligible for queries 1 and 2 k=7", rng.standard_normal((3, dim)).astype(np.float32),
           c, np.arange(1900, dtype=np.int32), 7, nan_mask)
    for n_small in (1, 7, 255, 257, 1001):
        q = rng.standard_normal((9, dim)).astype(np.float32)
        cs = rng.standard_normal((n_small, dim)).astype(np.float32)
        for k in (1, 10, 1024):
            yield (f"N={n_small} k={k}", q, cs, rng.permutation(n_small).astype(np.int32),
                   k, None)
