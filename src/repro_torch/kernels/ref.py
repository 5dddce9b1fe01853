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

__all__ = ["bitunpack_ref", "miniblock_decode_ref", "fullzip_gather_ref",
           "ivf_topk_ref", "ivf_topk_mismatches", "ivf_topk_scale", "miniblock_case",
           "IVF_ID_SENTINEL"]

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
    cc = (c * c).sum(1).max() if len(c) else 0.0
    return (q * q).sum(1) + cc


def miniblock_case(rng: np.random.Generator, rep_bits: int, def_bits: int, vpe: int,
                   n_chunks: int, tile: int = 1024, max_bits: int = 24,
                   ref_range=(-100, 100)):
    """Random ``miniblock_decode`` inputs as numpy arrays: ``(rep_words,
    def_words, val_words, params)``.  Each chunk has 1..``tile`` entries,
    random levels at the given widths, ``vpe`` values per valid entry at a
    width of 0..``max_bits`` bits, and a frame of reference from
    ``ref_range``; rows are ragged and zero-padded, as the reader stacks
    them."""
    from ..core.compression import bitpack  # both import this module
    from .ops import pack_words

    C = n_chunks
    rep_words = np.zeros((C, (tile * rep_bits + 31) // 32 + 1 if rep_bits else 1), np.uint32)
    def_words = np.zeros((C, (tile * def_bits + 31) // 32 + 1 if def_bits else 1), np.uint32)
    val_words = np.zeros((C, (tile * vpe * max_bits + 31) // 32 + 1), np.uint32)
    params = np.zeros((C, 3), np.int32)
    for c in range(C):
        n = int(rng.integers(1, tile + 1))
        bits = int(rng.integers(0, max_bits + 1))
        defs = (rng.integers(0, 2 ** def_bits, n, dtype=np.uint64)
                if def_bits else np.zeros(n, np.uint64))
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
