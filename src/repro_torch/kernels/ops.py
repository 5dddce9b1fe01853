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
import functools
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
    "fullzip_plan",
    "ivf_plan",
    "miniblock_plan",
]

MAX_ENTRIES = 4096  # the format's per-chunk value ceiling (sec 4.2.1)
MAX_TILE_VALUES = 1 << 17  # tile_entries * vpe ceiling the readers keep to
# largest k the ivf_topk kernel selects (csrc/ivf_topk.cu: a merge CTA sorts
# at least four k-long lists at once in its 4,096-pair buffer)
IVF_K_MAX = 1024
IVF_ID_SENTINEL = ref.IVF_ID_SENTINEL
# csrc/ivf_topk.cu's constants, which ivf_plan sizes a launch with (the
# kernel refuses a plan that does not fit them): rows per tile (one per
# thread), floats per stage of the candidate ring (a 256 x 36 padded chunk
# and a 32 x 8 query chunk), ring depths, queries per group, the dynamic
# shared memory a block may take, and the pairs a merge CTA sorts
_IVF_TILE, _IVF_STAGE_FLOATS = 256, 256 * 36 + 32 * 8
_IVF_MIN_STAGES, _IVF_MAX_STAGES, _IVF_QMAX = 2, 4, 8
_IVF_SMEM = 227 * 1024 - 1024
_IVF_SORT = 4096
# csrc/miniblock_decode.cu's constants, which miniblock_plan sizes a launch
# with: entries per thread (two runs of 4) and the alignment of slices
# (whole warps' runs); the values per slice the plan aims at (the fastest of
# 512 to 2,048 entries at vpe = 1 on the card); the most blocks a launch takes
_MB_PER_THREAD, _MB_SLICE_ALIGN = 8, 256
_MB_SLICE_VALUES = 1024
_GRID_MAX = (1 << 31) - 1
# csrc/fullzip_gather.cu's ring: slot bytes, slots per block, rows per unit
# at most, and the persistent blocks per SM of each route
_GATHER_STAGE_BYTES, _GATHER_STAGES, _GATHER_MAX_ROWS = 16384, 4, 32
_GATHER_BLOCKS_PER_SM = {"bulk": 3, "register": 16}
_GATHER_ROUTES = {"bulk": 0, "register": 1}

launches: Dict[str, int] = {"miniblock_decode": 0, "fullzip_gather": 0,
                            "ivf_topk": 0, "bitunpack": 0}
fallbacks: Dict[str, int] = {}


def reset_counts() -> None:
    """Zero the launch counts and forget the fallback counts."""
    for k in launches:
        launches[k] = 0
    fallbacks.clear()


def note_fallback(encoding: str, reason: str, tracer=None, **args) -> None:
    """Count one decode-route fallback (``decode="device"`` routed a decode
    to the host), keyed ``decode.fallback.<encoding>.<reason>``.  The
    process-wide count is kept whether or not a tracer is attached, so no
    host fallback hides the kernel; ``tracer`` (the IO path's, or None)
    gets the same count and a ``pallas_fallback`` event with ``args``."""
    key = f"decode.fallback.{encoding}.{reason}"
    fallbacks[key] = fallbacks.get(key, 0) + 1
    if tracer is not None:
        tracer.fallback(encoding, reason, **args)


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


def _stream(device: torch.device) -> int:
    """The raw handle of ``device``'s current stream (the capture stream
    while a CUDA graph is captured).  ``torch.cuda.current_stream`` builds a
    Stream object on every call, which costs the host more than the launch
    itself; this is the lookup Triton's launcher uses."""
    return torch._C._cuda_getCurrentRawStream(device.index)


_kernels = None
_sms: Dict[int, int] = {}


def _lib():
    """The loaded kernel libraries (built and loaded on the first call)."""
    global _kernels
    if _kernels is None:
        from .build import load_kernels

        _kernels = load_kernels()
    return _kernels


def _sm_count(index: int) -> int:
    if index not in _sms:
        _sms[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return _sms[index]


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


@functools.lru_cache(maxsize=256)
def miniblock_plan(C: int, tile: int, vpe: int) -> Dict[str, int]:
    """How ``csrc/miniblock_decode.cu`` runs ``C`` chunks of ``tile``
    entries with ``vpe`` values each: ``slice`` entries per CTA (the
    largest multiple of 256 with ``slice * vpe`` <= 1,024, at least 256),
    ``slices`` per chunk (the last may reach past the tile), ``blocks`` = C
    x slices CTAs of ``threads``, each thread two runs of 4 entries, and
    ``smem`` bytes of dynamic shared memory: at vpe > 1 a slot table of 4
    bytes an entry of the slice, at vpe = 1 none.  Memoized: every launch
    asks for it, and the readers' shapes repeat."""
    if not (C >= 1 and tile % 128 == 0 and 0 < tile <= MAX_ENTRIES
            and vpe >= 1 and tile * vpe <= MAX_TILE_VALUES):
        raise ValueError(f"no plan for C={C}, tile={tile}, vpe={vpe}")
    s = max(_MB_SLICE_ALIGN, _MB_SLICE_VALUES // vpe // _MB_SLICE_ALIGN * _MB_SLICE_ALIGN)
    slices = -(-tile // s)
    if C * slices > _GRID_MAX:
        raise ValueError(f"{C} chunks need more than {_GRID_MAX} blocks")
    return {"slice": s, "slices": slices, "blocks": C * slices,
            "threads": s // _MB_PER_THREAD, "smem": 4 * s if vpe > 1 else 0}


def launch_miniblock_decode(rep_words, def_words, val_words, params,
                            out_rep, out_def, out_val, *, rep_bits: int,
                            def_bits: int, vpe: int, fill: int) -> None:
    """Launch the ``miniblock_decode`` kernel on tensors the wrapper has
    checked (contiguous, on one CUDA device, at least one chunk, fresh
    outputs), with :func:`miniblock_plan`'s plan."""
    dev = val_words.device
    C, tile = out_rep.shape
    err = _lib().miniblock_decode_launch(
        _ptr(rep_words), _ptr(def_words), _ptr(val_words), _ptr(params),
        _ptr(out_rep), _ptr(out_def), _ptr(out_val),
        C, rep_words.shape[1], def_words.shape[1], val_words.shape[1],
        rep_bits, def_bits, vpe, tile, int(fill), miniblock_plan(C, tile, vpe)["slice"],
        dev.index, _stream(dev))
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
    if n_take:
        lo, hi = torch.stack(torch.aminmax(rows)).tolist()  # one host read
        if lo < 0 or hi >= n_rows:
            raise IndexError(f"gather rows out of bounds for {n_rows} rows")
    if dev.type == "cpu":
        return ref.fullzip_gather_ref(zipped, rows)
    zipped, rows = zipped.contiguous(), rows.contiguous()
    out = torch.empty((n_take, stride), dtype=torch.uint8, device=dev)
    if n_take and stride:
        launch_fullzip_gather(zipped, rows, out)
    return out


def fullzip_plan(n_take: int, stride: int, zipped_ptr: int, out_ptr: int,
                 sms: int) -> Dict[str, int]:
    """How ``csrc/fullzip_gather.cu`` runs a gather: ``route`` "bulk" (bulk
    asynchronous copies through the shared-memory ring) when the stride and
    both base addresses are multiples of 16 bytes, else "register" with the
    widest ``word`` (16, 8, 4, 2 or 1 bytes) dividing all three; ``units``,
    the bulk route's slots of whole rows (or row chunks where a row exceeds
    a slot), or rows on the register route; ``grid``, persistent blocks
    (a few per SM, no more than units)."""
    align = zipped_ptr | out_ptr | stride
    word = 16
    while align % word:
        word //= 2
    if word == 16:
        route = "bulk"
        if stride <= _GATHER_STAGE_BYTES:
            per = min(_GATHER_MAX_ROWS, _GATHER_STAGE_BYTES // stride)
            units = -(-n_take // per)
        else:
            units = n_take * -(-stride // _GATHER_STAGE_BYTES)
    else:
        route, units = "register", n_take
    grid = max(1, min(units, sms * _GATHER_BLOCKS_PER_SM[route]))
    return {"route": route, "word": word, "units": units, "grid": grid}


def launch_fullzip_gather(zipped, rows, out) -> None:
    """Launch the ``fullzip_gather`` kernel on tensors the wrapper has
    checked (contiguous, on one CUDA device, row ids in range, non-empty).

    The bulk route draws work from a counter of its own: 8 bytes taken from
    PyTorch's caching allocator on the launch's stream, which the C launcher
    zeroes on that stream before the kernel.  The allocator is stream
    ordered, so no launch still running holds the same block; under CUDA
    graph capture the block comes from the graph's private pool and the
    memset is captured with the kernel."""
    dev = zipped.device
    n_take, stride = out.shape
    plan = fullzip_plan(n_take, stride, zipped.data_ptr(), out.data_ptr(),
                        _sm_count(dev.index))
    counter = (torch.empty(1, dtype=torch.int64, device=dev)
               if plan["route"] == "bulk" else None)
    err = _lib().fullzip_gather_launch(
        _ptr(zipped), _ptr(rows), _ptr(out), n_take, stride,
        _GATHER_ROUTES[plan["route"]], plan["word"], plan["grid"],
        None if counter is None else _ptr(counter), dev.index, _stream(dev))
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
    (contiguous, on one CUDA device, at least one value, a fresh output)."""
    dev = words.device
    err = _lib().bitunpack_launch(
        _ptr(words), _ptr(out), out.shape[0], words.shape[0], bits, dev.index,
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


def ivf_plan(Q: int, N: int, k: int, sms: int) -> Dict[str, int]:
    """How ``csrc/ivf_topk.cu`` runs a ``(Q, N)`` top-k: ``qg`` queries per
    group (a power of two up to 8) in ``groups`` groups; ``blocks`` score
    blocks per group, about one per SM in all, of ``tiles_per_block``
    256-row tiles each (every block gets at least one); survivor buffers of
    ``buf`` pairs per query (a power of two >= k + 256: k kept pairs and one
    tile's survivors); the ring ``stages`` that fit beside them (2..4);
    ``smem``, the dynamic shared memory of a score block; and the merge
    passes that reduce ``blocks`` lists per query to one, ``fan_in`` lists
    at a time, with the pairs of the two list buffers they ping-pong
    between (``list_a_pairs``, ``list_b_pairs``; none with one block, which
    writes the final rows itself)."""
    if not (Q >= 1 and N >= 1 and 1 <= k <= IVF_K_MAX and sms >= 1):
        raise ValueError(f"no plan for Q={Q}, N={N}, k={k}, sms={sms}")
    qg = 1
    while qg < min(Q, _IVF_QMAX):
        qg *= 2
    groups = -(-Q // qg)
    tiles = -(-N // _IVF_TILE)
    per_block = -(-tiles // min(tiles, max(1, sms // groups)))
    blocks = -(-tiles // per_block)
    buf = 1
    while buf < k + _IVF_TILE:
        buf *= 2
    stages = min(_IVF_MAX_STAGES,
                 (_IVF_SMEM - 8 * qg * buf) // (4 * _IVF_STAGE_FLOATS))
    if stages < _IVF_MIN_STAGES:
        raise ValueError(f"k={k} leaves no room for the candidate ring")
    fan_in = _IVF_SORT // k
    passes, lists = 0, blocks
    while lists > 1:
        lists = -(-lists // fan_in)
        passes += 1
    return {"qg": qg, "groups": groups, "blocks": blocks,
            "tiles_per_block": per_block, "buf": buf, "stages": stages,
            "smem": 4 * stages * _IVF_STAGE_FLOATS + 8 * qg * buf,
            "fan_in": fan_in, "merge_passes": passes,
            "list_a_pairs": Q * blocks * k if blocks > 1 else 0,
            "list_b_pairs": Q * -(-blocks // fan_in) * k if passes > 1 else 0}


def launch_ivf_topk(queries, cands, ids, mask, out_d, out_i) -> None:
    """Launch the ``ivf_topk`` kernel (a scoring pass, then merge passes
    until one list per query is left) on tensors the wrapper has checked;
    allocates the per-block lists it merges."""
    dev = queries.device
    (qn, dim), n, k = queries.shape, cands.shape[0], out_d.shape[1]
    plan = ivf_plan(qn, n, k, _sm_count(dev.index))
    lists = [torch.empty((max(1, plan[f"list_{x}_pairs"]),), dtype=torch.int64,
                         device=dev) for x in "ab"]
    nan_flags = torch.empty(qn, dtype=torch.int32, device=dev)
    err = _lib().ivf_topk_launch(
        _ptr(queries), _ptr(cands), _ptr(ids),
        ctypes.c_void_p(mask.data_ptr() if mask is not None else 0),
        _ptr(nan_flags), _ptr(lists[0]), _ptr(lists[1]),
        _ptr(out_d), _ptr(out_i), qn, n, dim, k, plan["qg"], plan["blocks"],
        plan["tiles_per_block"], plan["buf"], plan["stages"], dev.index,
        _stream(dev))
    _raise_on(err, "ivf_topk")
    launches["ivf_topk"] += 1


def ivf_topk(queries, cands, ids, k: int, mask=None, *, device=None,
             tracer=None):
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
    (``non-float32``, ``no-candidates``, ``>1024-k``, ``>31-bit-ids``) in
    ``fallbacks`` and in ``tracer``'s registry, as the reference reports its
    own (whose kernel stops at k = 128).  Wide ids are selected
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
        note_fallback("ivf", reason, tracer, n_queries=qn, n_candidates=n,
                      k=k)
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
