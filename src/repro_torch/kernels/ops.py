"""Kernel entry points of the port.

Each wrapper takes torch tensors.  For tensors on a CUDA device it checks
them, allocates the outputs and launches its hand-written CUDA kernel
(``csrc/*.cu``, built on first use by :mod:`repro_torch.kernels.build`) on
the current stream; a kernel that cannot be built or launched raises.  For
tensors on the CPU it runs the plain PyTorch version in
:mod:`repro_torch.kernels.ref`.  Nothing falls back from the card to the
CPU.

Counters, read by tests and ``chip_smoke.py``:

* ``launches[name]`` — CUDA launches of each kernel (CPU calls never count;
  one ``ivf_topk`` launch is its scoring pass and its merge passes);
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
    "bitunpack",
    "miniblock_decode",
    "fullzip_gather",
    "ivf_topk",
    "ivf_topk_tensors",
    "launch_bitunpack",
    "launch_miniblock_decode",
    "launch_fullzip_gather",
    "launch_ivf_topk",
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
    "IVF_K_MAX",
    "IVF_ID_SENTINEL",
]

MAX_ENTRIES = 4096  # the format's per-chunk value ceiling (sec 4.2.1)
MAX_TILE_VALUES = 1 << 17  # tile_entries * vpe ceiling the readers keep to
# largest k the ivf_topk kernel selects (csrc/ivf_topk.cu: a merge CTA sorts
# at least four k-long lists at once in its 4,096-pair buffer)
IVF_K_MAX = 1024
IVF_ID_SENTINEL = ref.IVF_ID_SENTINEL
# csrc/ivf_topk.cu's kTile (candidates per scoring CTA) and kSort (pairs per
# merge CTA); the launcher sizes the per-tile lists with them and the
# kernel refuses a launch whose values differ from its own
_IVF_TILE, _IVF_SORT = 512, 4096

launches: Dict[str, int] = {"miniblock_decode": 0, "fullzip_gather": 0,
                            "ivf_topk": 0, "bitunpack": 0}
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


def bitunpack(words: torch.Tensor, n: int, bits: int) -> torch.Tensor:
    """Unpack ``n`` little-endian ``bits``-wide values (1 <= bits <= 32) from
    a 1-D uint32 word stream -> ``(n,)`` uint32.  ``words`` must hold the
    ``ceil(n * bits / 32)`` words the values span."""
    dev = words.device
    _check(words, "words", torch.uint32, 1, dev)
    n, bits = int(n), int(bits)
    if not 1 <= bits <= 32:
        raise ValueError(f"bits must be in [1, 32], got {bits}")
    if n < 0:
        raise ValueError(f"n must be >= 0, got {n}")
    if words.shape[0] < -(-n * bits // 32):
        raise ValueError(f"{words.shape[0]} words cannot hold {n} values of "
                         f"{bits} bits")
    if dev.type == "cpu":
        return ref.bitunpack_ref(words, n, bits)
    words = words.contiguous()
    out = torch.empty(n, dtype=torch.uint32, device=dev)
    if n:
        launch_bitunpack(words, out, bits=bits)
    return out


def launch_bitunpack(words, out, *, bits: int) -> None:
    """Launch the ``bitunpack`` kernel on tensors the wrapper has checked
    (contiguous, on one CUDA device, at least one value)."""
    from .build import load_kernels

    dev = words.device
    with torch.cuda.device(dev):
        err = load_kernels().bitunpack_launch(
            _ptr(words), _ptr(out), out.shape[0], words.shape[0], bits,
            _stream(dev))
    _raise_on(err, "bitunpack")
    launches["bitunpack"] += 1


def ivf_topk_tensors(queries: torch.Tensor, cands: torch.Tensor,
                     ids: torch.Tensor, k: int, mask=None):
    """Squared-L2 distance + deterministic top-k on tensors of one device:
    ``(Q, D)`` float32 queries, ``(N, D)`` float32 candidates, ``(N,)``
    int32 ids, optional ``(Q, N)`` uint8 eligibility ``mask`` -> ``(Q, k)``
    float32 distances and int32 ids, as :func:`ref.ivf_topk_ref` defines
    them (1 <= k <= ``IVF_K_MAX``, N >= 1)."""
    dev = queries.device
    _check(queries, "queries", torch.float32, 2, dev)
    _check(cands, "cands", torch.float32, 2, dev)
    _check(ids, "ids", torch.int32, 1, dev)
    (qn, dim), n = queries.shape, cands.shape[0]
    if cands.shape[1] != dim or ids.shape[0] != n:
        raise ValueError(f"cands {tuple(cands.shape)} and ids "
                         f"{tuple(ids.shape)} do not match queries "
                         f"{tuple(queries.shape)}")
    if mask is not None:
        _check(mask, "mask", torch.uint8, 2, dev)
        if tuple(mask.shape) != (qn, n):
            raise ValueError(f"mask must be ({qn}, {n}), got {tuple(mask.shape)}")
    k = int(k)
    if not 1 <= k <= IVF_K_MAX or n < 1:
        raise ValueError(f"the kernel takes 1 <= k <= {IVF_K_MAX} and at "
                         f"least one candidate, got k={k}, N={n}")
    if dev.type == "cpu":
        return ref.ivf_topk_ref(queries, cands, ids, k, mask)
    queries, cands, ids = (t.contiguous() for t in (queries, cands, ids))
    mask = mask.contiguous() if mask is not None else None
    out_d = torch.empty((qn, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((qn, k), dtype=torch.int32, device=dev)
    if qn:
        launch_ivf_topk(queries, cands, ids, mask, out_d, out_i)
    return out_d, out_i


def launch_ivf_topk(queries, cands, ids, mask, out_d, out_i) -> None:
    """Launch the ``ivf_topk`` kernel (a scoring pass, then merge passes
    until one list per query is left) on tensors the wrapper has checked;
    allocates the per-tile lists it merges."""
    from .build import load_kernels

    dev = queries.device
    (qn, dim), n, k = queries.shape, cands.shape[0], out_d.shape[1]
    n_tiles = -(-n // _IVF_TILE)
    fan_in = _IVF_SORT // k
    lists = [torch.empty((qn * n_tiles * k,), dtype=torch.int64, device=dev),
             torch.empty((qn * -(-n_tiles // fan_in) * k,), dtype=torch.int64,
                         device=dev)]
    nan_flags = torch.empty(qn, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = load_kernels().ivf_topk_launch(
            _ptr(queries), _ptr(cands), _ptr(ids),
            ctypes.c_void_p(mask.data_ptr() if mask is not None else 0),
            _ptr(nan_flags), _ptr(lists[0]), _ptr(lists[1]),
            _ptr(out_d), _ptr(out_i), qn, n, dim, k, _IVF_TILE, _IVF_SORT,
            _stream(dev))
    _raise_on(err, "ivf_topk")
    launches["ivf_topk"] += 1


def ivf_topk(queries, cands, ids, k: int, mask=None, *, device=None):
    """Batched squared-L2 distance + deterministic top-k over one shared
    candidate matrix (the IVF search hot loop).

    ``queries``: (Q, D) or (D,); ``cands``: (N, D); ``ids``: (N,) candidate
    row ids; ``mask``: optional (Q, N) per-query eligibility (nonzero =
    candidate in one of this query's probed partitions).  Host arrays in,
    host arrays out: ``(dists, winners)`` of shape (Q, k) — ties break
    toward the lowest row id, entries past a query's eligible count hold
    ``(inf, IVF_ID_SENTINEL)``.

    Eligible inputs (float32 vectors, ids within 31 bits, k <= ``IVF_K_MAX``,
    at least one candidate) run on ``device``: the CUDA kernel there, its
    plain version on the CPU.  Otherwise the plain version runs on the host
    and the reason is counted under ``decode.fallback.ivf.<reason>``
    (``non-float32``, ``no-candidates``, ``>1024-k``, ``>31-bit-ids``), as
    the reference reports its own (whose kernel stops at k = 128).  Wide ids are selected
    over their positions in id order (position tie-break == id tie-break)
    and mapped back.
    """
    k = int(k)
    if k < 1:
        raise ValueError("k must be positive")
    dev = resolve_device(device)
    q2 = np.atleast_2d(np.asarray(queries))
    c2 = np.atleast_2d(np.asarray(cands))
    ids_arr = np.asarray(ids).reshape(-1)
    qn, n = q2.shape[0], c2.shape[0]
    reason = None
    if q2.dtype != np.float32 or c2.dtype != np.float32:
        reason = "non-float32"
    elif n == 0:
        reason = "no-candidates"
    elif k > IVF_K_MAX:
        reason = f">{IVF_K_MAX}-k"
    elif ids_arr.size and int(ids_arr.max()) >= IVF_ID_SENTINEL:
        reason = ">31-bit-ids"
    wide = reason == ">31-bit-ids"
    if wide:
        order = np.argsort(ids_arr, kind="stable")
        c2 = c2[order]
        if mask is not None:
            mask = np.atleast_2d(np.asarray(mask))[:, order]
        ids_sorted, ids_run = ids_arr[order], np.arange(n, dtype=np.int32)
    else:
        ids_run = ids_arr.astype(np.int32)
    if reason is not None:
        note_fallback("ivf", reason)
        dev = torch.device("cpu")  # the plain version, on the host
    # float32 throughout, as the reference computes under JAX's 32-bit types
    args = [to_device(q2.astype(np.float32, copy=False), dev),
            to_device(c2.astype(np.float32, copy=False), dev),
            to_device(ids_run, dev)]
    m = None if mask is None else to_device(
        (np.asarray(mask).reshape(qn, n) != 0).view(np.uint8), dev)
    if reason is None:
        d, w = ivf_topk_tensors(*args, k, m)
    else:
        d, w = ref.ivf_topk_ref(*args, k, m)
    d, w = to_host(d), to_host(w)
    if wide:
        w = np.where(w == IVF_ID_SENTINEL, np.int64(IVF_ID_SENTINEL),
                     ids_sorted[np.minimum(w, n - 1)])
    return d, w
