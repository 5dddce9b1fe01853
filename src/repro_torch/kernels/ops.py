"""Kernel entry points of the port.

Each wrapper takes torch tensors.  For tensors on a CUDA device it checks
them, allocates the outputs and launches its hand-written CUDA kernel
(``csrc/*.cu``, built on first use by :mod:`repro_torch.kernels.build`) on
the current stream; a kernel that cannot be built or launched raises.  For
tensors on the CPU it runs the plain PyTorch version in
:mod:`repro_torch.kernels.ref`.  Nothing falls back from the card to the
CPU.

Counters, read by tests and ``chip_smoke.py``:

* ``launches[name]`` — CUDA launches of each kernel (CPU calls never count);
* ``fallbacks["decode.fallback.<encoding>.<reason>"]`` — decode-route
  fallbacks to the host decoder, under the JAX package's telemetry names.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import numpy as np
import torch

from . import ref

__all__ = [
    "miniblock_decode",
    "fullzip_gather",
    "launch_miniblock_decode",
    "launch_fullzip_gather",
    "pack_words",
    "resolve_device",
    "to_device",
    "to_host",
    "note_fallback",
    "reset_counts",
    "launches",
    "fallbacks",
    "MAX_ENTRIES",
    "MAX_TILE_VALUES",
]

MAX_ENTRIES = 4096  # the format's per-chunk value ceiling (sec 4.2.1)
MAX_TILE_VALUES = 1 << 17  # tile_entries * vpe ceiling the readers keep to

launches: Dict[str, int] = {"miniblock_decode": 0, "fullzip_gather": 0}
fallbacks: Dict[str, int] = {}


def reset_counts() -> None:
    """Zero the launch counts and forget the fallback counts."""
    for k in launches:
        launches[k] = 0
    fallbacks.clear()


def note_fallback(encoding: str, reason: str) -> None:
    """Count one decode-route fallback (``decode="device"`` routed a decode
    to the host), keyed ``decode.fallback.<encoding>.<reason>``."""
    key = f"decode.fallback.{encoding}.{reason}"
    fallbacks[key] = fallbacks.get(key, 0) + 1


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs its decode routes on: CUDA unless the
    caller names the CPU.  Raises when CUDA is asked for (or defaulted to)
    and there is none — nothing drops to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to run the "
                "decode routes on the CPU")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host numpy array -> tensor on ``device`` (no copy on the CPU)."""
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def to_host(t: torch.Tensor) -> np.ndarray:
    """Tensor -> host numpy array (waits for the device)."""
    return t.cpu().numpy()


def pack_words(buf: np.ndarray, pad_words: int = 1) -> np.ndarray:
    """uint8 packed stream -> uint32 little-endian words (host helper)."""
    b = np.asarray(buf, np.uint8)
    pad = (-len(b)) % 4
    b = np.pad(b, (0, pad))
    w = b.view(np.uint32)
    if pad_words:
        w = np.pad(w, (0, pad_words))
    return w


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int,
           device: torch.device) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got shape {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def miniblock_decode(
    rep_words: torch.Tensor,
    def_words: torch.Tensor,
    val_words: torch.Tensor,
    params: torch.Tensor,
    *,
    rep_bits: int,
    def_bits: int,
    vpe: int = 1,
    tile_entries: int = MAX_ENTRIES,
    fill: int = 0,
):
    """Decode C mini-block chunks -> ``(rep, defs, vals)`` int32 tiles.

    ``rep_words``/``def_words``/``val_words`` are ``(C, *)`` uint32 word
    rows (a ``(C, 1)`` dummy where a level stream is absent); ``params`` is
    ``(C, 3)`` int32 ``[n_entries, value bits, FoR reference]``.
    ``rep``/``defs`` are ``(C, tile_entries)``; ``vals`` is the dense
    ``(C, tile_entries * vpe)`` tile (``vpe`` values per valid entry).
    Entries past a chunk's ``n_entries`` and null value slots read as 0 /
    ``fill``.
    """
    dev = val_words.device
    C = val_words.shape[0]
    for t, nm in ((rep_words, "rep_words"), (def_words, "def_words"),
                  (val_words, "val_words")):
        _check(t, nm, torch.uint32, 2, dev)
        if t.shape[0] != C or t.shape[1] < 1:
            raise ValueError(f"{nm} must be ({C}, >=1), got {tuple(t.shape)}")
    _check(params, "params", torch.int32, 2, dev)
    if tuple(params.shape) != (C, 3):
        raise ValueError(f"params must be ({C}, 3), got {tuple(params.shape)}")
    if tile_entries % 128 or not 0 < tile_entries <= MAX_ENTRIES:
        raise ValueError(f"tile_entries must be a multiple of 128 in "
                         f"(0, {MAX_ENTRIES}], got {tile_entries}")
    if vpe < 1 or tile_entries * vpe > MAX_TILE_VALUES:
        raise ValueError(f"tile_entries * vpe must be in [1, {MAX_TILE_VALUES}]")
    if not (0 <= rep_bits <= 31 and 0 <= def_bits <= 31):
        raise ValueError("level widths must be in [0, 31]")
    if dev.type == "cpu":
        return ref.miniblock_decode_ref(
            rep_words, def_words, val_words,
            params[:, 0], params[:, 1], params[:, 2],
            tile_entries, rep_bits, def_bits, vpe, fill)
    rep_words, def_words, val_words, params = (
        t.contiguous() for t in (rep_words, def_words, val_words, params))
    out = (torch.empty((C, tile_entries), dtype=torch.int32, device=dev),
           torch.empty((C, tile_entries), dtype=torch.int32, device=dev),
           torch.empty((C, tile_entries * vpe), dtype=torch.int32, device=dev))
    if C:
        launch_miniblock_decode(rep_words, def_words, val_words, params, *out,
                                rep_bits=rep_bits, def_bits=def_bits, vpe=vpe,
                                fill=fill)
    return out


def launch_miniblock_decode(rep_words, def_words, val_words, params,
                            out_rep, out_def, out_val, *, rep_bits: int,
                            def_bits: int, vpe: int, fill: int) -> None:
    """Launch the ``miniblock_decode`` kernel on tensors the wrapper has
    checked (contiguous, on one CUDA device, at least one chunk)."""
    from .build import load_kernels

    dev = val_words.device
    with torch.cuda.device(dev):
        err = load_kernels().miniblock_decode_launch(
            _ptr(rep_words), _ptr(def_words), _ptr(val_words), _ptr(params),
            _ptr(out_rep), _ptr(out_def), _ptr(out_val),
            val_words.shape[0], rep_words.shape[1], def_words.shape[1],
            val_words.shape[1], rep_bits, def_bits, vpe, out_rep.shape[1],
            int(fill), _stream(dev))
    _raise_on(err, "miniblock_decode")
    launches["miniblock_decode"] += 1


def fullzip_gather(zipped: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Gather zipped fixed-stride rows (the §4.1 take path):
    ``out[i] = zipped[rows[i]]`` for a ``(n_rows, stride)`` uint8 buffer
    and ``(n_take,)`` int32 row ids (duplicates allowed)."""
    dev = zipped.device
    _check(zipped, "zipped", torch.uint8, 2, dev)
    _check(rows, "rows", torch.int32, 1, dev)
    n_rows, stride = zipped.shape
    n_take = rows.shape[0]
    if n_take and (int(rows.min()) < 0 or int(rows.max()) >= n_rows):
        raise IndexError(f"gather rows out of bounds for {n_rows} rows")
    if dev.type == "cpu":
        return ref.fullzip_gather_ref(zipped, rows)
    zipped, rows = zipped.contiguous(), rows.contiguous()
    out = torch.empty((n_take, stride), dtype=torch.uint8, device=dev)
    if n_take and stride:
        launch_fullzip_gather(zipped, rows, out)
    return out


def launch_fullzip_gather(zipped, rows, out) -> None:
    """Launch the ``fullzip_gather`` kernel on tensors the wrapper has
    checked (contiguous, on one CUDA device, row ids in range, non-empty)."""
    from .build import load_kernels

    dev = zipped.device
    with torch.cuda.device(dev):
        err = load_kernels().fullzip_gather_launch(
            _ptr(zipped), _ptr(rows), _ptr(out), rows.shape[0], zipped.shape[1],
            _stream(dev))
    _raise_on(err, "fullzip_gather")
    launches["fullzip_gather"] += 1
