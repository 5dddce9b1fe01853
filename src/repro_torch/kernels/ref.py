"""Plain PyTorch versions of the port's kernels.

They compute the same functions as the CUDA kernels with ordinary tensor
ops, on any device.  The wrappers in :mod:`repro_torch.kernels.ops` run them
for tensors that lie on the CPU; the tests hold them against the JAX
package's oracles, and ``chip_smoke.py`` holds each CUDA kernel against its
plain version on the card.  :func:`miniblock_case` makes the seeded inputs
of those sweeps.

uint32 arithmetic is carried in int64 and masked to 32 bits, since torch has
no general unsigned 32-bit arithmetic.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["miniblock_decode_ref", "fullzip_gather_ref", "miniblock_case"]

_U32 = 0xFFFFFFFF


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
