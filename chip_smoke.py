#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0]

Phases, one JSON object per line on stdout:

1. the card (``nvidia-smi`` name and power limit, also printed as it gives them);
2. the build of every CUDA kernel from ``src/repro_torch/kernels/csrc`` for
   ``sm_90a`` (seconds, ptxas lines);
3. the kernel sweep: each CUDA kernel against its plain PyTorch version on
   the card, over the shape sweeps of the tests, the edge cases of the
   mini-block decode's slices and of the unpack's runs included
   (``ref.miniblock_edge_cases``, ``ref.bitunpack_cases``; tolerance 0, except
   ``ivf_topk``: distances within 1e-6 of ``|d| + |q|^2 + max |c|^2``, the
   size of the terms the expanded form rounds at, and ids exact outside near
   ties, whose count it prints);
4. the take path: a dataset of 1,048,576 rows in 4 Lance files made from
   ``--seed`` (``id`` int64, ``score`` nullable int32, ``tags``
   List<int32> with nulls at both levels, ``emb`` FixedSizeList<float32>[384]),
   read through ``DatasetReader(decode="device")``: takes of 1,024 / 16,384 /
   65,536 random rows with duplicates on every column, and scans of ``id``
   and ``tags``.  Every result must equal the numpy route's and the source
   table's, with identical logical IO and modelled time; both kernels must
   have launched and no eligible column may fall back to the host;
5. the search path over the same four files: ``DatasetWriter(store="flat",
   flush=None)`` ingests them, ``IvfIndex.build`` trains 256 partitions on
   ``emb`` and stores the index as 2 fragments, and ``Retriever.search``
   answers batches of 1 and 8 queries at k = 10, nprobe = 32 and one
   exhaustive batch of 4 at nprobe = 256, on the device route and the numpy
   route.  Results must agree (the rule above), IO accounting must be
   identical, ``ivf_topk`` must launch on both steps of every search with no
   ``decode.fallback.ivf.*``, and the exhaustive batch must reach recall@10
   = 1.0 against a float64 brute force;
6. the tiered path over the same four files (``tiered``): the reference's
   deployment shape, an NVMe block cache (64 MB, 16,384 blocks of 4 KiB,
   clock, always-admit) over S3.  ``DatasetReader(store="tiered")`` takes
   1,024 and 16,384 random rows on every column cold (after
   ``drop_caches``) and warm, and scans ``id`` cold in 64 KiB windows with
   readahead;
   ``store="hot"`` (RAM over NVMe over S3) takes 1,024 rows cold and warm;
   ``store="tiered-auto"`` scans, then takes, and prints its admission
   flips; ``Retriever(store="tiered")`` fetches 1,024 ids cold and warm;
   ``DatasetWriter`` at the reference's defaults (tiered, write-back)
   ingests the files, takes the committed rows, then crashes with an
   uncommitted append in flight.  Each step runs on the device route and on
   a numpy-route twin in lockstep: results equal the source, and the twins'
   ``tier_stats()``, ``io_stats()``, ``write_stats()`` and
   ``modelled_time()`` are identical after every step; logical IO and the
   write trace equal the flat store's.  Each line gives both routes' wall
   ms, the kernels' and copies' ms, ``store_ms`` (host time in the store's
   batch-close accounting: coalescing, per-block classification,
   readahead, flush policy) and the modelled IO ms;
7. the ``bitunpack`` path: 2**20 values at 11 bits (the JAX package's
   ``kernel_bench`` size), unpacked on the card and checked against the
   packed values;
8. each kernel at the largest input each path gave it (``take``, ``search``
   and ``bitunpack``; ``ivf_topk`` per search step: the centroid ``probe``
   and the ``candidates`` of each batch size), one ``kernels`` entry each:
   ``ms``, the mean of 20 back-to-back launches by CUDA events, host launch
   path included; ``graph_ms``, the same 20 launches captured in one CUDA
   graph, one replay over 20 (the kernel's own device time, L2-warm);
   ``cold_ms``, launches timed alone after a 128 MB write flushed the 50 MB
   L2; ``launch_us``, host wall time per call of 1,000 launches at the
   kernel's smallest sweep input; its plain version's ``plain_ms``; the
   PyTorch call that computes the same function, where one does
   (``library_ms``, ``library_graph_ms``); and the least time the card
   could take (bytes over 3.35 TB/s or operations over 67 T/s, whichever
   is larger); and one more ``bitunpack`` row at 2**24 values of 11 bits
   (``"step": "2**24"``, no launches on any path: it shows whether the
   kernel reaches the bandwidth regime);
9. the ``kernels`` line, then ``{"ok": true, "device": {...}}`` last.

Between the sweep and the dataset, ``gather_streams`` holds the gather's
per-launch work counter to its contract: the take shape's gather (16,429
rows of 1,536 bytes) launched on 65 CUDA streams at once, three rounds, and
a CUDA graph captured on one stream and replayed on another while a direct
launch runs on the capture stream, 20 times.  Every output starts filled
with a sentinel and must equal the plain version at tolerance 0.

Any failure raises, so the script exits non-zero and prints no result line.
Without a CUDA device it exits 2 at once; without the repository's ``src``
beside it, the import fails.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.core import arrays as A  # noqa: E402
from repro_torch.core import types as T  # noqa: E402
from repro_torch.core.file import WriteOptions  # noqa: E402
from repro_torch.core.compression import bitpack  # noqa: E402
from repro_torch.dataset import (DatasetReader, DatasetWriter, IvfIndex,  # noqa: E402
                                 write_fragments)
from repro_torch.dataset import ivf as ivf_module  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.serve import Retriever  # noqa: E402
from repro_torch.store import IOScheduler  # noqa: E402

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA data sheet)
INT_OPS_PER_S = 67e12  # H100 SXM non-tensor 32-bit rate (NVIDIA data sheet)
FP32_FLOPS_PER_S = 67e12  # H100 SXM fp32 outside the tensor cores (data sheet)
ROWS = 1 << 20  # the main path's dataset: ~1.6 GB in FRAGMENTS files
FRAGMENTS = 4
TAKE_SIZES = (1024, 16384, 65536)
COLUMNS = ("id", "score", "tags", "emb")
SCAN_COLUMNS = ("id", "tags")
# the search path: 256 partitions of ~4,096 rows; nprobe = 1/8 of them, the
# repo's search-bench ratio; one exhaustive batch
PARTITIONS, INDEX_FRAGMENTS, K = 256, 2, 10
SEARCHES = ((1, 32), (8, 32), (4, PARTITIONS))  # (queries, nprobe)
BITUNPACK_N, BITUNPACK_BITS = 1 << 20, 11  # the JAX package's kernel_bench size
# one more bitunpack row, off every path: whether the kernel reaches the
# bandwidth regime, since 2**20 values are near the floor of one launch
BITUNPACK_BIG_N = 1 << 24
# gather_streams: the take path's gather shape, on more streams than the
# bulk route had work counters before they became per launch (64)
GATHER_ROWS, GATHER_STRIDE = 16429, 1536
GATHER_STREAMS, GATHER_ROUNDS, GRAPH_REPLAYS = 65, 3, 20
# the tiered path: take sizes, and the size of the uncommitted append that
# the writer's crash tears
TIERED_TAKES = (1024, 16384)
CRASH_ROWS = 4096
# the tiered scans read in windows of this size, so that readahead sees a
# sequential stream inside each fragment (the default window, 8 MB, reads a
# fragment's id column at once)
TIERED_SCAN_CHUNK = 64 << 10
RTOL = 1e-6
KERNEL_REPLACES = {
    "miniblock_decode": "src/repro/kernels/miniblock_decode.py:107",
    "fullzip_gather": "src/repro/kernels/fullzip_gather.py:35",
    "ivf_topk": "src/repro/kernels/ivf_topk.py:70",
    "bitunpack": "src/repro/kernels/bitunpack.py:46",
}
# the wrapper each kernel is timed through, and the size of its input that
# picks the largest call of a path
WRAPPERS = {"miniblock_decode": "miniblock_decode", "fullzip_gather": "fullzip_gather",
            "ivf_topk": "ivf_topk_tensors", "bitunpack": "bitunpack"}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


class Failure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise Failure(msg)


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean time of ``fn`` over ``reps`` back-to-back calls, by CUDA events
    (inputs stay L2-warm between calls).  Each call pays its host launch
    path too, so at small sizes this measures the host."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int = 20, replays: int = 5) -> float:
    """Device time of one call of ``fn``: ``reps`` calls captured in one
    CUDA graph, each replay timed by CUDA events and divided by ``reps``;
    the median of ``replays`` replays.  The host launch path is paid once,
    at capture, so this is the kernels' own time (L2-warm)."""
    fn()  # first launch outside the capture: build, load, set attributes
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(replays):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        g.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    del g
    return float(np.median(times))


def cold_ms(fn, reps: int = 20, flush_bytes: int = 128 << 20) -> float:
    """Mean time of ``fn`` with the 50 MB L2 flushed before each call: a
    128 MB scratch buffer is written, then the call alone is timed by its
    own CUDA events."""
    scratch = torch.empty(flush_bytes, dtype=torch.uint8, device="cuda")
    fn()
    pairs = []
    for i in range(reps):
        scratch.fill_(i & 0xFF)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in pairs) / reps


def launch_us(fn, calls: int = 1000) -> float:
    """Host wall clock per call of ``calls`` back-to-back calls, synchronised
    once at the end: the host launch path at an input too small for the
    kernel to matter."""
    fn()
    torch.cuda.synchronize()
    s = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - s) / calls * 1e6


def ivf_step(queries, cands) -> str:
    """Which step of a search an ``ivf_topk`` call is: the centroid probe
    scores the index's PARTITIONS centroids, the candidate step the rows of
    the probed partitions (one entry per batch size)."""
    if cands.shape[0] == PARTITIONS:
        return "probe"
    return f"candidates q={queries.shape[0]}"


class Probe:
    """Wraps the port's kernel wrappers and host<->device copies with CUDA
    events.  For each kernel, path (``self.path``, set by ``main``) and
    search step it keeps the largest input a launching call had and the
    launches those calls made (read off the wrapper's own count).  The
    wrappers' counts are untouched."""

    def __init__(self):
        self.events = {}
        self.largest = {}  # (kernel, path, step) -> (size, args, kw)
        self.launched = {}  # (kernel, path, step) -> launches
        self.path = None
        self.real = {n: getattr(ops, n) for n in
                     (*WRAPPERS.values(), "to_device", "to_host")}
        for name, fn in self.real.items():
            setattr(ops, name, self._timed(name, fn))

    def _timed(self, name, fn):
        kernel = {w: k for k, w in WRAPPERS.items()}.get(name)

        def timed(*args, **kw):
            n0 = ops.launches[kernel] if kernel else 0
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            out = fn(*args, **kw)
            e.record()
            self.events.setdefault(name, []).append((s, e))
            launched = ops.launches[kernel] - n0 if kernel else 0
            if launched:
                step = ivf_step(*args[:2]) if kernel == "ivf_topk" else None
                key = (kernel, self.path, step)
                self.launched[key] = self.launched.get(key, 0) + launched
                # ivf_topk by its candidate matrix, then queries x k; the
                # others by their output
                size = (args[1].numel(), args[0].shape[0] * args[3]) \
                    if kernel == "ivf_topk" else \
                    (sum(o.numel() for o in (out if isinstance(out, tuple) else (out,))),)
                if size > self.largest.get(key, ((0,),))[0]:
                    self.largest[key] = (size, args, kw)
            return out

        return timed

    def kernel_ms(self, times):
        return {k: times.get(w, 0.0) for k, w in WRAPPERS.items()}

    def collect(self):
        """Milliseconds per wrapped function since the last collect."""
        torch.cuda.synchronize()
        out = {n: sum(s.elapsed_time(e) for s, e in p) for n, p in self.events.items()}
        self.events = {}
        return out

    def restore(self):
        for name, fn in self.real.items():
            setattr(ops, name, fn)


class StoreClock:
    """Host time in the store's batch-close accounting: the scheduler's
    read and write batch closes (coalescing, per-block classification
    against the cache tiers, readahead, the flush policy's ticks) and its
    commit barrier, read off by :meth:`take` (ms since the last take)."""

    NAMES = ("_finish", "_finish_write", "flush_barrier")

    def __init__(self):
        self.seconds = 0.0
        self.real = {n: getattr(IOScheduler, n) for n in self.NAMES}
        for name, fn in self.real.items():
            setattr(IOScheduler, name, self._timed(fn))

    def _timed(self, fn):
        def timed(*args, **kw):
            s = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                self.seconds += time.perf_counter() - s
        return timed

    def take(self) -> float:
        ms, self.seconds = self.seconds * 1e3, 0.0
        return ms

    def restore(self):
        for name, fn in self.real.items():
            setattr(IOScheduler, name, fn)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def device_phase():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    line = smi.splitlines()[0]
    print(line, flush=True)
    emit({"phase": "device", "nvidia_smi": line, "torch": torch.__version__,
          "cuda": torch.version.cuda, "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count()})
    return line


def build_phase():
    info = build.build_kernels()
    build.load_kernels()
    emit({"phase": "build", "seconds": info["seconds"], "built": info["built"],
          "library_dir": str(build.BUILD_DIR.relative_to(ROOT)), "ptxas": info["ptxas"]})


def _compare(got, want):
    """(mismatching elements, max |difference|) of two tensor tuples."""
    mism, err = 0, 0
    for g, w in zip(got, want):
        check(g.shape == w.shape and g.dtype == w.dtype,
              f"shape/dtype {tuple(g.shape)} {g.dtype} vs {tuple(w.shape)} {w.dtype}")
        d = (g.to(torch.int64) - w.to(torch.int64)).abs()
        mism += int((d != 0).sum())
        err = max(err, int(d.max()) if d.numel() else 0)
    return mism, err


def sweep_phase():
    """Each kernel against its plain version over its sweep.  Returns the
    per-kernel tallies and, per kernel, its smallest launching input (where
    ``launch_us`` is taken)."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    res = {name: [0, 0, 0] for name in WRAPPERS}
    smallest = {}

    def tally(name, mism, err, size, args, kw=None):
        r = res[name]
        r[0] += 1
        r[1] += mism
        r[2] = max(r[2], err)
        if size and size < smallest.get(name, (np.inf,))[0]:
            smallest[name] = (size, args, kw or {})

    for rep_bits, def_bits in [(0, 0), (0, 1), (0, 2), (1, 2), (2, 3)]:
        for vpe in (1, 4):
            for C in (1, 4, 33):
                for tile, max_bits, refs in ((1024, 24, (-100, 100)),
                                             (512, 31, (1 << 30, (1 << 31) - 1))):
                    case = ref.miniblock_case(rng, rep_bits, def_bits, vpe, C,
                                              tile, max_bits, refs)
                    t = [torch.from_numpy(a).to(dev) for a in case]
                    kw = dict(rep_bits=rep_bits, def_bits=def_bits, vpe=vpe,
                              tile_entries=tile, fill=-5)
                    got = ops.miniblock_decode(*t, **kw)
                    want = ref.miniblock_decode_ref(t[0], t[1], t[2], t[3][:, 0], t[3][:, 1],
                                                    t[3][:, 2], tile, rep_bits, def_bits, vpe, -5)
                    tally("miniblock_decode", *_compare(got, want),
                          sum(g.numel() for g in got), t, kw)
    for _, case, kw in ref.miniblock_edge_cases(rng):
        t = [torch.from_numpy(a).to(dev) for a in case]
        got = ops.miniblock_decode(*t, **kw)
        want = ref.miniblock_decode_ref(t[0], t[1], t[2], t[3][:, 0], t[3][:, 1], t[3][:, 2],
                                        kw["tile_entries"], kw["rep_bits"], kw["def_bits"],
                                        kw["vpe"], kw["fill"])
        tally("miniblock_decode", *_compare(got, want), sum(g.numel() for g in got), t, kw)
    for _, zipped, rows, offset in ref.gather_cases(rng):
        zipped = ref.at_offset(zipped, dev, offset)
        rows = torch.from_numpy(rows).to(dev)
        got = ops.fullzip_gather(zipped, rows)
        tally("fullzip_gather", *_compare((got,), (ref.fullzip_gather_ref(zipped, rows),)),
              got.numel(), (zipped, rows))
    for bits in (1, 3, 5, 8, 11, 16, 21, 32):
        for n in (1, 100, 8192, 20000):
            v = rng.integers(0, 2 ** min(bits, 62), n, dtype=np.uint64)
            words = torch.from_numpy(ops.pack_words(bitpack(v, bits))).to(dev)
            got = ops.bitunpack(words, n, bits)
            m, e = _compare((got,), (ref.bitunpack_ref(words, n, bits),))
            tally("bitunpack", m + int((got.cpu().numpy() != v).sum()), e, n,
                  (words, n, bits))
    for _, v, words, bits, offset in ref.bitunpack_cases(rng):
        words = ref.at_offset(words, dev, offset)
        got = ops.bitunpack(words, len(v), bits)
        m, e = _compare((got,), (ref.bitunpack_ref(words, len(v), bits),))
        tally("bitunpack", m + int((got.cpu().numpy() != v).sum()), e, len(v),
              (words, len(v), bits))
    res["ivf_topk"][2] = 0.0
    ties = 0
    for q, c, ids, k, mask in ivf_cases(rng, dev):
        got = ops.ivf_topk_tensors(q, c, ids, k, mask)
        want = ref.ivf_topk_ref(q, c, ids, k, mask)
        m, e, g = compare_topk(got, want, ref.ivf_topk_scale(q, c))
        tally("ivf_topk", m, e, c.numel(), (q, c, ids, k, mask))
        ties += g
    torch.cuda.synchronize()
    out = {k: {"cases": v[0], "mismatches": v[1], "max_abs_err": v[2]} for k, v in res.items()}
    out["ivf_topk"]["near_tie_groups"] = ties
    emit({"phase": "kernels", "tolerance": 0, "ivf_topk_rtol": RTOL, **out})
    for k, v in out.items():
        check(v["mismatches"] == 0, f"{k}: {v['mismatches']} mismatches against its plain version")
    return out, smallest


def gather_streams_phase(rng):
    """The gather's bulk route draws work from a counter that must belong to
    its launch alone.  Launch it at the take shape on GATHER_STREAMS streams
    at once (GATHER_ROUNDS rounds, fresh row ids each), then replay a CUDA
    graph captured on stream A on stream B while a direct launch runs on A
    (GRAPH_REPLAYS times).  Outputs start filled with a sentinel, so a unit
    of rows that no block gathered shows; every output must equal the plain
    version exactly.  Emits the rows that differ, then fails on any."""
    dev = torch.device("cuda")
    zipped = torch.from_numpy(
        rng.integers(0, 256, (GATHER_ROWS, GATHER_STRIDE), dtype=np.uint8)).to(dev)
    plan = ops.fullzip_plan(GATHER_ROWS, GATHER_STRIDE, zipped.data_ptr(), 0,
                            torch.cuda.get_device_properties(dev).multi_processor_count)
    check(plan["route"] == "bulk", f"gather_streams: the take shape took the {plan['route']} "
          "route, which has no work counter")

    def rows_of():
        return torch.from_numpy(
            rng.integers(0, GATHER_ROWS, GATHER_ROWS).astype(np.int32)).to(dev)

    def sentinel():
        return torch.full((GATHER_ROWS, GATHER_STRIDE), 0xA5, dtype=torch.uint8, device=dev)

    def wrong_rows(out, rows):
        return int((out != ref.fullzip_gather_ref(zipped, rows)).any(dim=1).sum())

    wrong = {"streams": 0, "graph": 0, "direct": 0}
    main = torch.cuda.current_stream()
    streams = [torch.cuda.Stream() for _ in range(GATHER_STREAMS)]
    for _ in range(GATHER_ROUNDS):
        rows = [rows_of() for _ in streams]
        outs = [sentinel() for _ in streams]
        for st in streams:
            st.wait_stream(main)
        for st, r, o in zip(streams, rows, outs):
            with torch.cuda.stream(st):
                ops.launch_fullzip_gather(zipped, r, o)
        for st in streams:
            main.wait_stream(st)
        torch.cuda.synchronize()
        wrong["streams"] += sum(wrong_rows(o, r) for r, o in zip(rows, outs))
    del outs

    a, b = torch.cuda.Stream(), torch.cuda.Stream()
    rows_g, rows_d = rows_of(), rows_of()
    out_g, out_d = sentinel(), sentinel()
    for st in (a, b):
        st.wait_stream(main)
    with torch.cuda.stream(a):  # a first launch outside the capture
        ops.launch_fullzip_gather(zipped, rows_g, out_g)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=a):
        out_g.fill_(0xA5)
        ops.launch_fullzip_gather(zipped, rows_g, out_g)
    torch.cuda.synchronize()
    for _ in range(GRAPH_REPLAYS):
        with torch.cuda.stream(b):
            graph.replay()
        with torch.cuda.stream(a):
            out_d.fill_(0xA5)
            ops.launch_fullzip_gather(zipped, rows_d, out_d)
        torch.cuda.synchronize()
        wrong["graph"] += wrong_rows(out_g, rows_g)
        wrong["direct"] += wrong_rows(out_d, rows_d)
    del graph
    emit({"phase": "gather_streams", "rows": GATHER_ROWS, "row_bytes": GATHER_STRIDE,
          "route": plan["route"], "streams": GATHER_STREAMS, "rounds": GATHER_ROUNDS,
          "graph_replays": GRAPH_REPLAYS, "tolerance": 0, "rows_wrong": wrong})
    for k, v in wrong.items():
        check(v == 0, f"gather_streams: {v} rows wrong ({k})")


def ivf_cases(rng, dev):
    """The ivf_topk sweep: the grid of the JAX package's parity test, with
    and without a mask, a tie across tiles, an exhaustion case, then the
    hazards of the threshold filter (``ref.ivf_hazard_cases``)."""
    for dim in (3, 64, 128, 200):
        for nq, nc, k in ((1, 7, 3), (5, 300, 10), (9, 129, 1)):
            q = torch.from_numpy(rng.standard_normal((nq, dim)).astype(np.float32)).to(dev)
            c = torch.from_numpy(rng.standard_normal((nc, dim)).astype(np.float32)).to(dev)
            ids = torch.from_numpy(rng.permutation(nc).astype(np.int32)).to(dev)
            mask = torch.from_numpy(rng.integers(0, 2, (nq, nc)).astype(np.uint8)).to(dev)
            yield q, c, ids, k, None
            yield q, c, ids, k, mask
    ids = torch.from_numpy(rng.permutation(3000).astype(np.int32)).to(dev)
    yield torch.zeros((3, 16), device=dev), torch.zeros((3000, 16), device=dev), ids, 12, None
    q = torch.from_numpy(rng.standard_normal((4, 32)).astype(np.float32)).to(dev)
    c = torch.from_numpy(rng.standard_normal((5, 32)).astype(np.float32)).to(dev)
    mask = torch.tensor([[1, 1, 1, 1, 1], [0, 1, 0, 1, 0], [0] * 5, [1, 0, 0, 0, 0]],
                        dtype=torch.uint8, device=dev)
    yield q, c, torch.arange(5, dtype=torch.int32, device=dev) * 11, 8, mask
    for _, *case in ref.ivf_hazard_cases(rng):
        q, c, ids, k, mask = case
        yield (torch.from_numpy(q).to(dev), torch.from_numpy(c).to(dev),
               torch.from_numpy(ids).to(dev), k,
               None if mask is None else torch.from_numpy(mask).to(dev))


def compare_topk(got, want, scale):
    """(mismatches, max |distance difference| over finite entries, near-tie
    groups) of two ``(dists, ids)`` results, by ``ref.ivf_topk_mismatches``:
    distances within RTOL of ``|d| + scale``, where ``scale`` is per query
    ``|q|^2 + max |c|^2`` (``ref.ivf_topk_scale``), since the expanded form
    ``(qq - 2 q.c) + cc`` rounds at the size of its terms."""
    d, w = (np.asarray(t.cpu()) if torch.is_tensor(t) else np.asarray(t) for t in got)
    wd, ww = (np.asarray(t.cpu()) if torch.is_tensor(t) else np.asarray(t) for t in want)
    mism, groups = ref.ivf_topk_mismatches(d, w, wd, ww, RTOL, scale)
    fin = np.isfinite(d) & np.isfinite(wd)
    err = float(np.abs(d[fin].astype(np.float64) - wd[fin]).max()) if fin.any() else 0.0
    return mism, err, groups


def make_table(n: int, rng):
    """The main path's table, from the seed: 1536-byte embeddings dominate."""
    score_valid = rng.random(n) >= 0.03
    lens = rng.integers(0, 8, n)
    list_valid = rng.random(n) >= 0.02
    lens[~list_valid] = 0
    offsets = np.zeros(n + 1, np.int64)
    np.cumsum(lens, out=offsets[1:])
    m = int(offsets[-1])
    child = A.PrimitiveArray(T.Primitive("int32", True), rng.random(m) >= 0.05,
                             rng.integers(0, 1 << 16, m).astype(np.int32))
    return {
        "id": A.PrimitiveArray.build(np.arange(n, dtype=np.int64), nullable=False),
        "score": A.PrimitiveArray.build(rng.integers(0, 1 << 20, n).astype(np.int32),
                                        validity=score_valid),
        "tags": A.ListArray(T.List(child.type, True), list_valid, offsets, child),
        "emb": A.FixedSizeListArray.build(
            rng.standard_normal((n, 384), dtype=np.float32), nullable=False),
    }


def same_buffers(a, b) -> bool:
    """Identical arrays, buffer by buffer (values at nulls included)."""
    if type(a) is not type(b) or not np.array_equal(a.validity, b.validity):
        return False
    if hasattr(a, "child"):
        return np.array_equal(a.offsets, b.offsets) and same_buffers(a.child, b.child)
    return a.values.dtype == b.values.dtype and np.array_equal(a.values, b.values)


def same_values(src, got) -> bool:
    """``got`` holds ``src``'s valid values (the source keeps arbitrary
    bytes under its nulls, decoded arrays do not)."""
    if not np.array_equal(src.validity, got.validity):
        return False
    v = src.validity
    if hasattr(src, "child"):
        return np.array_equal(src.offsets, got.offsets) and same_values(src.child, got.child)
    return np.array_equal(src.values[v], got.values[v])


def io_of(reader):
    return dataclasses.astuple(reader.io_stats()), reader.modelled_time()


def dataset_phase(rng):
    t0 = time.perf_counter()
    table = make_table(ROWS, rng)
    t1 = time.perf_counter()
    files = write_fragments(table, FRAGMENTS, WriteOptions("lance", decode="device"))
    t2 = time.perf_counter()
    emit({"phase": "dataset", "rows": ROWS, "fragments": FRAGMENTS,
          "bytes": sum(len(f) for f in files), "gen_s": t1 - t0,
          "write_s": t2 - t1})
    return table, files


def take_path_phase(table, files, rng, probe):
    dev = DatasetReader(files)  # decode route from the footer: "device", on CUDA
    host = DatasetReader(files, decode="numpy")
    check(dev.fragments[0].decode == "device", "footer did not select the device route")
    check(dev.fragments[0].device.type == "cuda", "device route is not on CUDA")

    takes = [(k, rng.integers(0, ROWS, k)) for k in TAKE_SIZES]
    for _, rows in takes:  # duplicates, in and out of order
        rows[: len(rows) // 4] = rows[len(rows) // 2: len(rows) // 2 + len(rows) // 4][::-1]
    ops.reset_counts()  # the take path starts here
    for col in COLUMNS:  # warm-up: first launches, allocator, caches
        dev.take(col, takes[0][1][:64])
    probe.collect()
    for k, rows in takes:
        rec = {"phase": "take", "rows": k, "device_wall_ms": {}, "numpy_wall_ms": {},
               "modelled_io_ms": {}}
        n0 = dict(ops.launches)
        for col in COLUMNS:
            dev.reset_io()
            host.reset_io()
            s = time.perf_counter()
            got = dev.take(col, rows)
            torch.cuda.synchronize()
            rec["device_wall_ms"][col] = (time.perf_counter() - s) * 1e3
            s = time.perf_counter()
            want = host.take(col, rows)
            rec["numpy_wall_ms"][col] = (time.perf_counter() - s) * 1e3
            check(same_buffers(want, got), f"take {k} {col}: device != numpy route")
            check(same_values(table[col].take(rows), got), f"take {k} {col}: != source")
            check(io_of(dev) == io_of(host), f"take {k} {col}: IO accounting differs")
            rec["modelled_io_ms"][col] = dev.modelled_time() * 1e3
        times = probe.collect()
        rec["kernel_ms"] = probe.kernel_ms(times)
        rec["copy_ms"] = times.get("to_device", 0.0) + times.get("to_host", 0.0)
        rec["launches"] = {n: ops.launches[n] - n0[n] for n in ops.launches}
        emit(rec)
    for col in SCAN_COLUMNS:
        dev.reset_io()
        host.reset_io()
        n0 = dict(ops.launches)
        s = time.perf_counter()
        got = dev.scan(col)
        torch.cuda.synchronize()
        dwall = (time.perf_counter() - s) * 1e3
        s = time.perf_counter()
        want = host.scan(col)
        hwall = (time.perf_counter() - s) * 1e3
        check(same_buffers(want, got), f"scan {col}: device != numpy route")
        check(same_values(table[col], got), f"scan {col}: != source")
        check(io_of(dev) == io_of(host), f"scan {col}: IO accounting differs")
        times = probe.collect()
        emit({"phase": "scan", "column": col, "device_wall_ms": dwall, "numpy_wall_ms": hwall,
              "kernel_ms": probe.kernel_ms(times),
              "copy_ms": times.get("to_device", 0.0) + times.get("to_host", 0.0),
              "launches": {n: ops.launches[n] - n0[n] for n in ops.launches},
              "modelled_io_ms": dev.modelled_time() * 1e3})
    launches = dict(ops.launches)  # the take path ends here
    fallbacks = dict(ops.fallbacks)
    emit({"phase": "take_path", "checked": "exact vs decode=numpy and the source table; "
          "identical io_stats and modelled_time", "launches": launches,
          "fallbacks": fallbacks})
    for name in ("miniblock_decode", "fullzip_gather"):
        check(launches[name] > 0, f"{name} never launched on the take path")
    check(not fallbacks, f"eligible columns fell back to the host: {fallbacks}")
    return launches


def writer_io(w):
    return (dataclasses.astuple(w.io_stats()), dataclasses.astuple(w.write_stats()),
            [dataclasses.astuple(t) for t in w.tier_stats()], w.modelled_time())


def timed_build(writer):
    """``IvfIndex.build`` with its scan and k-means timed from outside."""
    spans = {}

    def timing(name, fn):
        def run(*a, **kw):
            s = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            spans[name] = spans.get(name, 0.0) + time.perf_counter() - s
            return out
        return run

    real_kmeans = ivf_module.kmeans
    ivf_module.kmeans = timing("kmeans_s", real_kmeans)
    writer.scan = timing("scan_s", writer.scan)
    try:
        s = time.perf_counter()
        index = IvfIndex.build(writer, "emb", n_partitions=PARTITIONS,
                               n_fragments=INDEX_FRAGMENTS, seed=0)
        total = time.perf_counter() - s
    finally:
        ivf_module.kmeans = real_kmeans
        del writer.scan
    spans["write_s"] = total - spans["scan_s"] - spans["kmeans_s"]
    spans["total_s"] = total
    return index, spans


def emb_take_timer(reader):
    """Times each take of the retriever's data reader (candidates, then
    winners)."""
    log = []
    real = reader.take

    def take(name, rows):
        s = time.perf_counter()
        out = real(name, rows)
        torch.cuda.synchronize()
        log.append((time.perf_counter() - s) * 1e3)
        return out

    reader.take = take
    return log


def recall_at_k(vecs64, q, ids, k):
    """recall@k of ``ids`` against a float64 brute force over every row, a
    row tied with the k-th within float32 noise counting as a hit (the rule
    of the JAX package's search property test)."""
    hits = 0
    for i in range(len(q)):
        d = ((vecs64 - torch.from_numpy(q[i].astype(np.float64)).to(vecs64.device)) ** 2).sum(1)
        top = torch.topk(d, k, largest=False)
        kth = float(top.values[-1])
        best = set(top.indices.cpu().tolist())
        dd = d[torch.from_numpy(ids[i]).to(vecs64.device)].cpu().numpy()
        hits += sum(int(r) in best or dd[j] <= kth * (1 + 1e-5) + 1e-7
                    for j, r in enumerate(ids[i]))
    return hits / (len(q) * k)


def search_path_phase(table, files, rng, probe):
    """DatasetWriter -> IvfIndex.build -> Retriever.search, on the device
    route and the numpy route, over the take path's four files."""
    vecs = table["emb"].values
    ops.reset_counts()  # the search path starts here
    s = time.perf_counter()
    w_dev = DatasetWriter(files, store="flat", flush=None, decode="device")
    ingest_s = time.perf_counter() - s
    w_np = DatasetWriter(files, store="flat", flush=None, decode="numpy")
    check(writer_io(w_dev) == writer_io(w_np), "ingest: IO accounting differs")
    ivf_dev, build_dev = timed_build(w_dev)
    ivf_np, build_np = timed_build(w_np)
    cent = ivf_dev.centroids()
    check(np.array_equal(cent, ivf_np.centroids()), "index: centroids differ between routes")
    parts = np.arange(PARTITIONS)
    posts = ivf_dev.postings(parts)
    check(all(np.array_equal(a, b) for a, b in zip(posts, ivf_np.postings(parts))),
          "index: posting lists differ between routes")
    check(writer_io(w_dev) == writer_io(w_np), "build: IO accounting differs")
    sizes = [len(p) for p in posts]
    emit({"phase": "index", "ingest_s": ingest_s, "build_device": build_dev,
          "build_numpy": build_np, "partitions": PARTITIONS,
          "posting_rows": {"min": min(sizes), "mean": float(np.mean(sizes)),
                           "max": max(sizes)},
          "write_stats": dataclasses.asdict(w_dev.write_stats())})
    r_dev = Retriever(w_dev.reader(), "emb", index=ivf_dev, decode="device")
    r_np = Retriever(w_np.reader(), "emb", index=ivf_np, decode="numpy")
    takes = emb_take_timer(r_dev.reader)
    r_dev.search(vecs[:1], k=K, nprobe=4)  # warm-up
    r_np.search(vecs[:1], k=K, nprobe=4)
    vecs64 = torch.from_numpy(vecs).to("cuda", torch.float64)
    cc_max = float((vecs.astype(np.float64) ** 2).sum(1).max())
    cent_max = float((cent.astype(np.float64) ** 2).sum(1).max())
    cent_plain = torch.from_numpy(cent)
    probe.collect()
    for nq, nprobe in SEARCHES:
        q = vecs[rng.integers(0, ROWS, nq)] + \
            0.05 * rng.standard_normal((nq, vecs.shape[1])).astype(np.float32)
        qq = (q.astype(np.float64) ** 2).sum(1)
        scale = qq + cc_max  # ref.ivf_topk_scale over the whole column
        w_dev.reset_io()
        w_np.reset_io()
        del takes[:]
        n0, f0 = dict(ops.launches), dict(ops.fallbacks)
        probe.collect()  # drop the numpy route's host-side events
        s = time.perf_counter()
        got = r_dev.search(q, k=K, nprobe=nprobe)
        torch.cuda.synchronize()
        dev_ms = (time.perf_counter() - s) * 1e3
        times = probe.collect()
        launched = {n: ops.launches[n] - n0[n] for n in ops.launches}
        s = time.perf_counter()
        want = r_np.search(q, k=K, nprobe=nprobe)
        np_ms = (time.perf_counter() - s) * 1e3
        tag = f"search nq={nq} nprobe={nprobe}"
        # probes: the plain version's centroid distances order both routes
        pd, pw = ref.ivf_topk_ref(torch.from_numpy(q), cent_plain,
                                  torch.arange(PARTITIONS, dtype=torch.int32), nprobe)
        mp, _, gp = compare_topk((pd, got.probes), (pd, want.probes), qq + cent_max)
        check(np.array_equal(want.probes, pw.numpy()), f"{tag}: numpy route probes")
        mi, err, gi = compare_topk((got.distances, got.ids), (want.distances, want.ids), scale)
        check(mp == 0, f"{tag}: probes differ from the numpy route")
        check(mi == 0, f"{tag}: ids/distances differ from the numpy route")
        if np.array_equal(got.ids, want.ids):
            check(np.array_equal(got.winner_rows, want.winner_rows), f"{tag}: winner rows")
            check(same_buffers(want.values, got.values), f"{tag}: winner values differ")
        check(same_values(table["emb"].take(got.winner_rows), got.values),
              f"{tag}: winner values != source")
        check(got.n_candidates == want.n_candidates, f"{tag}: candidate counts differ")
        check(writer_io(w_dev) == writer_io(w_np), f"{tag}: IO accounting differs")
        check(launched["ivf_topk"] == 2, f"{tag}: ivf_topk launched {launched['ivf_topk']} "
              "times, not on both steps")
        ivf_fb = {k: v - f0.get(k, 0) for k, v in ops.fallbacks.items()
                  if k.startswith("decode.fallback.ivf.") and v != f0.get(k, 0)}
        check(not ivf_fb, f"{tag}: ivf_topk fell back: {ivf_fb}")
        rec = {"phase": "search", "queries": nq, "nprobe": nprobe, "k": K,
               "candidates": got.n_candidates, "device_wall_ms": dev_ms,
               "numpy_wall_ms": np_ms,
               "candidate_take_ms": takes[0], "winner_take_ms": takes[1],
               "winner_rows": int(got.winner_rows.size),
               "kernel_ms": probe.kernel_ms(times),
               "copy_ms": times.get("to_device", 0.0) + times.get("to_host", 0.0),
               "modelled_io_ms": w_dev.modelled_time() * 1e3, "launches": launched,
               "near_tie_groups": {"probes": gp, "ids": gi},
               "ids_identical": bool(np.array_equal(got.ids, want.ids)),
               "max_abs_distance_diff": err}
        if nprobe == PARTITIONS:
            rec["recall_at_k"] = recall_at_k(vecs64, q, got.ids, K)
            check(rec["recall_at_k"] == 1.0, f"{tag}: recall@{K} {rec['recall_at_k']} < 1")
        emit(rec)
    launches = dict(ops.launches)  # the search path ends here
    fallbacks = dict(ops.fallbacks)
    emit({"phase": "search_path", "checked": "ids/probes vs decode=numpy (near-tie rule), "
          "winner rows and values, identical io/write/tier stats and modelled_time, "
          "recall@10 = 1.0 at nprobe = 256", "launches": launches, "fallbacks": fallbacks})
    for name in ("miniblock_decode", "fullzip_gather", "ivf_topk"):
        check(launches[name] > 0, f"{name} never launched on the search path")
    return launches


def twin_state(r):
    """What the device route and its numpy twin must agree on after every
    step: every tier's counters, the logical read (and write) trace and the
    modelled IO time."""
    state = ([dataclasses.astuple(t) for t in r.tier_stats()],
             dataclasses.astuple(r.io_stats()), r.modelled_time())
    if hasattr(r, "write_stats"):
        state += (dataclasses.astuple(r.write_stats()),)
    return state


def tiers_of(r):
    return [{"tier": t.name, "hits": t.hits, "misses": t.misses, "hit_rate": t.hit_rate,
             "evictions": t.evictions, "n_iops": t.n_iops, "bytes_read": t.bytes_read,
             "prefetch_iops": t.prefetch_iops, "write_iops": t.write_iops,
             "flush_iops": t.flush_iops, "dirty_bytes": t.dirty_bytes,
             "lost_bytes": t.lost_bytes} for t in r.tier_stats()]


class Twins:
    """Runs each step on the device route, then on its numpy-route twin,
    and checks after each that their state is identical.  Sums each
    route's wall ms, the kernels' and copies' ms (device route) and the
    store's batch-close ms (both routes) into the open record."""

    def __init__(self, probe, clock):
        self.probe, self.clock = probe, clock
        self.rec = None

    def open(self, **fields):
        self.rec = {"phase": "tiered", **fields, "device_wall_ms": 0.0, "numpy_wall_ms": 0.0,
                    "kernel_ms": 0.0, "copy_ms": 0.0,
                    "store_ms": {"device": 0.0, "numpy": 0.0}}
        return self.rec

    def call(self, tag, dev, host, fn, state=twin_state):
        rec = self.rec
        self.probe.collect()
        self.clock.take()
        s = time.perf_counter()
        got = fn(dev)
        torch.cuda.synchronize()
        rec["device_wall_ms"] += (time.perf_counter() - s) * 1e3
        rec["store_ms"]["device"] += self.clock.take()
        times = self.probe.collect()
        rec["kernel_ms"] += sum(self.probe.kernel_ms(times).values())
        rec["copy_ms"] += times.get("to_device", 0.0) + times.get("to_host", 0.0)
        s = time.perf_counter()
        want = fn(host)
        rec["numpy_wall_ms"] += (time.perf_counter() - s) * 1e3
        rec["store_ms"]["numpy"] += self.clock.take()
        self.probe.collect()
        check(state(dev) == state(host),
              f"{tag}: tier stats, IO or modelled time differ between the routes")
        return got, want

    def close(self, dev):
        rec, self.rec = self.rec, None
        rec["modelled_io_ms"] = dev.modelled_time() * 1e3
        rec["tiers"] = tiers_of(dev)
        emit(rec)
        return rec


def take_all(tw, tag, dev, host, rows, table, flat=None):
    """Take ``rows`` of every column on both twins: equal to each other and
    to the source; with ``flat``, the logical IO equals the flat store's."""
    for col in COLUMNS:
        got, want = tw.call(f"{tag} {col}", dev, host, lambda r: r.take(col, rows))
        check(same_buffers(want, got), f"{tag} {col}: device != numpy route")
        check(same_values(table[col].take(rows), got), f"{tag} {col}: != source")
        if flat is not None:
            flat.take(col, rows)
            check(dataclasses.astuple(flat.io_stats()) == dataclasses.astuple(dev.io_stats()),
                  f"{tag} {col}: logical IO differs from the flat store's")


def cold_warm(tw, store, dev, host, rows, table, flat=None):
    """A cold pass (caches dropped) and a warm repeat of the same takes."""
    out = {}
    for r in (dev, host):
        r.drop_caches()
    for step in ("cold", "warm"):
        for r in (dev, host, flat):
            if r is not None:
                r.reset_io()
        tw.open(store=store, step=f"take {step}", rows=len(rows))
        take_all(tw, f"{store} take {len(rows)} {step}", dev, host, rows, table, flat)
        out[step] = tw.close(dev)
    return out


def tiered_path_phase(table, files, rng, probe):
    """The main path over the tiered store, device route against a numpy
    twin in lockstep (see the module docstring, item 6)."""
    clock = StoreClock()
    tw = Twins(probe, clock)
    ops.reset_counts()  # the tiered path starts here
    try:
        tiered_runs(tw, table, files, rng)
    finally:
        clock.restore()
    launches = dict(ops.launches)  # the tiered path ends here
    fallbacks = dict(ops.fallbacks)
    emit({"phase": "tiered_path", "checked": "exact vs decode=numpy and the source; "
          "identical tier_stats, io_stats, write_stats and modelled_time between the "
          "routes after every step; logical IO and write trace equal the flat store's",
          "launches": launches, "fallbacks": fallbacks})
    for name in ("miniblock_decode", "fullzip_gather"):
        check(launches[name] > 0, f"{name} never launched on the tiered path")
    check(not fallbacks, f"eligible columns fell back to the host: {fallbacks}")
    return launches


def tiered_runs(tw, table, files, rng):
    flat = DatasetReader(files, decode="numpy")
    dev, host = (DatasetReader(files, store="tiered", decode=d) for d in (None, "numpy"))
    cache = dev.store.levels[0].cache
    check((len(dev.store.levels), cache.capacity_blocks, cache.policy, cache.admission)
          == (1, 16384, "clock", "always"), "store='tiered' is not the reference's NVMe cache")
    for k in TIERED_TAKES:
        rows = rng.integers(0, ROWS, k)
        res = cold_warm(tw, "tiered", dev, host, rows, table, flat)
        if k == TIERED_TAKES[0]:
            check(res["warm"]["modelled_io_ms"] < res["cold"]["modelled_io_ms"],
                  f"tiered take {k}: warm is not cheaper than cold")
            check(res["warm"]["tiers"][-1]["n_iops"] == 0, f"tiered take {k}: S3 served a warm take")
    for r in (dev, host):
        r.drop_caches()
        r.reset_io()
    tw.open(store="tiered", step="scan id, cold")
    got, want = tw.call("tiered scan id", dev, host, lambda r: r.scan("id", io_chunk=TIERED_SCAN_CHUNK))
    check(same_buffers(want, got) and same_values(table["id"], got), "tiered scan id")
    check(dev.tier_stats()[-1].prefetch_iops > 0, "tiered scan id: readahead filled nothing")
    tw.close(dev)
    del dev, host, flat

    dev, host = (DatasetReader(files, store="hot", decode=d) for d in (None, "numpy"))
    res = cold_warm(tw, "hot", dev, host, rng.integers(0, ROWS, TIERED_TAKES[0]), table)
    check(res["warm"]["modelled_io_ms"] < res["cold"]["modelled_io_ms"] and
          res["warm"]["tiers"][-1]["n_iops"] == 0, "hot: warm take not served by the caches")
    del dev, host

    dev, host = (DatasetReader(files, store="tiered-auto", decode=d) for d in (None, "numpy"))
    cache = dev.store.levels[0].cache
    tw.open(store="tiered-auto", step="scan id, then takes")
    flips = []
    got, _ = tw.call("tiered-auto scan id", dev, host, lambda r: r.scan("id", io_chunk=TIERED_SCAN_CHUNK))
    check(same_values(table["id"], got), "tiered-auto scan id != source")
    flips.append(("scan id", cache.active_admission, cache.admission_flips))
    rows = rng.integers(0, ROWS, TIERED_TAKES[0])
    for _ in range(2):
        take_all(tw, "tiered-auto take", dev, host, rows, table)
        flips.append(("take", cache.active_admission, cache.admission_flips))
    tw.rec["admission"] = flips
    tw.close(dev)
    del dev, host

    dev, host = (Retriever(files, "emb", store="tiered", decode=d) for d in (None, "numpy"))
    ids = rng.integers(0, ROWS, TIERED_TAKES[0])
    cold = None
    for step in ("cold", "warm"):
        tw.open(store="tiered", step=f"Retriever.fetch {step}", rows=len(ids))
        got, want = tw.call(f"fetch {step}", dev, host, lambda r: r.fetch(ids)[0],
                            state=lambda r: twin_state(r.reader))
        check(same_buffers(want, got) and same_values(table["emb"].take(ids), got),
              f"fetch {step}: values")
        rec = tw.close(dev.reader)
        if step == "warm":
            check(rec["modelled_io_ms"] < cold and rec["tiers"][-1]["n_iops"] == 0,
                  "fetch warm: not served by the NVMe cache")
        cold = rec["modelled_io_ms"]
    del dev, host
    tiered_writer(tw, table, files, rng)


def tiered_writer(tw, table, files, rng):
    """DatasetWriter at the reference's defaults (tiered, write-back): ingest
    and commit, takes of the committed version, then a crash with an
    uncommitted append in flight."""
    rec = tw.open(store="tiered", step="DatasetWriter(files) ingest, write-back")
    twins = []
    for decode, key in ((None, "device"), ("numpy", "numpy")):
        tw.clock.take()
        s = time.perf_counter()
        twins.append(DatasetWriter(files, decode=decode))
        rec[f"{key}_wall_ms"] += (time.perf_counter() - s) * 1e3
        rec["store_ms"][key] += tw.clock.take()
    dev, host = twins
    check(dev.flush_policy.mode == "write-back" and len(dev.store.levels) == 1,
          "DatasetWriter() is not at the reference's defaults")
    check(twin_state(dev) == twin_state(host), "writer ingest: the routes' state differs")
    check(dev.dirty_bytes == host.dirty_bytes == 0, "writer ingest: dirty bytes after the commit")
    flat = DatasetWriter(files, store="flat", flush=None, decode="numpy")
    check(dataclasses.astuple(flat.write_stats()) == dataclasses.astuple(dev.write_stats()),
          "writer ingest: write trace differs from the flat store's")
    rec["write_stats"] = dataclasses.asdict(dev.write_stats())
    rec["flush_events"] = dev.flush_policy.n_flush_events
    del flat
    tw.close(dev)

    for w in (dev, host):
        w.reset_io()
    tw.open(store="tiered", step="DatasetWriter take", rows=TIERED_TAKES[0])
    take_all(tw, "writer take", dev, host, rng.integers(0, ROWS, TIERED_TAKES[0]), table)
    tw.close(dev)

    rec = tw.open(store="tiered", step="append uncommitted, simulate_crash, scan")
    extra = make_table(CRASH_ROWS, rng)
    _, _ = tw.call("writer append", dev, host, lambda w: w.append(extra, commit=False))
    torn, torn_np = tw.call("writer crash", dev, host, lambda w: w.simulate_crash())
    check(torn == torn_np and torn > 0, f"writer crash: torn {torn} / {torn_np} bytes")
    check(dev.tier_stats()[0].lost_bytes > 0, "writer crash: the NVMe tier lost nothing")
    check(dev.version == 1 and dev.n_rows == ROWS, "writer crash: not back at version 1")
    rec["torn_bytes"] = torn
    for col in COLUMNS:
        got, want = tw.call(f"writer scan {col}", dev, host, lambda w: w.scan(col))
        check(same_buffers(want, got) and same_values(table[col], got),
              f"writer scan {col} after the crash: != source")
    tw.close(dev)


def bitunpack_path_phase(rng):
    """The bitunpack kernel's own path: no reader calls it; the JAX package
    drives it at 2**20 values of 11 bits (kernel_bench)."""
    v = rng.integers(0, 1 << BITUNPACK_BITS, BITUNPACK_N, dtype=np.uint64)
    words = torch.from_numpy(ops.pack_words(bitpack(v, BITUNPACK_BITS))).cuda()
    ops.reset_counts()  # the bitunpack path starts here
    got = ops.bitunpack(words, BITUNPACK_N, BITUNPACK_BITS)
    launches = dict(ops.launches)  # and ends here
    check(np.array_equal(got.cpu().numpy(), v), "bitunpack: values differ from the packed ones")
    check(launches["bitunpack"] > 0, "bitunpack never launched on its path")
    emit({"phase": "bitunpack_path", "values": BITUNPACK_N, "bits": BITUNPACK_BITS,
          "launches": launches})
    return launches


def kernel_case(name, a, kw):
    """One kernel input as the measurement needs it: the kernel's launcher
    on preallocated outputs (``ops.launch_*``, past the wrapper's checks),
    its plain version, the one PyTorch call that computes the same function
    (or None), a check against the plain version -> (mismatches, max |err|,
    extra fields), its shape, and the bytes and operations of its bound."""
    if name == "miniblock_decode":
        rw, dw, vw, p = a
        C, tile, vpe = vw.shape[0], kw["tile_entries"], kw.get("vpe", 1)
        rb, db, fill = kw["rep_bits"], kw["def_bits"], kw.get("fill", 0)
        got = ops.miniblock_decode(*a, **kw)
        plain = lambda: ref.miniblock_decode_ref(rw, dw, vw, p[:, 0], p[:, 1], p[:, 2],  # noqa: E731
                                                 tile, rb, db, vpe, fill)
        bufs = [torch.empty_like(g) for g in got]
        return {
            "launch": lambda: ops.launch_miniblock_decode(
                rw, dw, vw, p, *bufs, rep_bits=rb, def_bits=db, vpe=vpe, fill=fill),
            "plain": plain, "library": None,
            "check": lambda: (*_compare(got, plain()), {}),
            "shape": {"chunks": C, "rep_words": rw.shape[1], "def_words": dw.shape[1],
                      "val_words": vw.shape[1], "rep_bits": rb, "def_bits": db, "vpe": vpe,
                      "tile_entries": tile, "fill": fill},
            "bytes": (4 * ((rw.numel() if rb else 0) + (dw.numel() if db else 0) + vw.numel()
                           + p.numel()) + sum(4 * g.numel() for g in got)),
            "operations": sum(g.numel() for g in got), "ops_per_s": INT_OPS_PER_S}
    if name == "fullzip_gather":
        zipped, rows = a
        got = ops.fullzip_gather(zipped, rows)
        buf = torch.empty_like(got)
        n_take, stride = got.shape
        n_unique = int(torch.unique(rows).numel())
        return {
            "launch": lambda: ops.launch_fullzip_gather(zipped, rows, buf),
            "plain": lambda: ref.fullzip_gather_ref(zipped, rows),
            "library": lambda: torch.index_select(zipped, 0, rows),
            "check": lambda: (*_compare((got,), (ref.fullzip_gather_ref(zipped, rows),)), {}),
            "shape": {"n_rows": zipped.shape[0], "row_bytes": stride, "n_take": n_take,
                      "unique_rows": n_unique},
            "bytes": n_unique * stride + 4 * n_take + n_take * stride,
            "operations": n_take * stride, "ops_per_s": INT_OPS_PER_S}
    if name == "ivf_topk":
        q, c, ids, k = a[:4]
        mask = a[4] if len(a) > 4 else kw.get("mask")
        (qn, dim), n = q.shape, c.shape[0]
        got = ops.ivf_topk_tensors(q, c, ids, k, mask)
        bufs = [torch.empty_like(g) for g in got]

        def check_topk():
            mism, err, ties = compare_topk(got, ref.ivf_topk_ref(q, c, ids, k, mask),
                                           ref.ivf_topk_scale(q, c))
            return mism, err, {"near_tie_groups": ties}

        return {
            "launch": lambda: ops.launch_ivf_topk(q, c, ids, mask, *bufs),
            "plain": lambda: ref.ivf_topk_ref(q, c, ids, k, mask), "library": None,
            "check": check_topk,
            "shape": {"queries": qn, "candidates": n, "dim": dim, "k": k,
                      "mask": mask is not None},
            "bytes": 4 * n * dim + (qn * n if mask is not None else 0) + 4 * n
            + 4 * qn * dim + 8 * qn * k,
            "operations": 2 * qn * n * dim, "ops_per_s": FP32_FLOPS_PER_S}
    words, n_vals, bits = a
    got = ops.bitunpack(words, n_vals, bits)
    buf = torch.empty_like(got)
    return {
        "launch": lambda: ops.launch_bitunpack(words, buf, bits=bits),
        "plain": lambda: ref.bitunpack_ref(words, n_vals, bits), "library": None,
        "check": lambda: (*_compare((got,), (ref.bitunpack_ref(words, n_vals, bits),)), {}),
        "shape": {"values": n_vals, "bits": bits, "words": words.shape[0]},
        "bytes": -(-n_vals * bits // 8) + 4 * n_vals,
        "operations": n_vals, "ops_per_s": INT_OPS_PER_S}


PATH_ORDER = {"take": 0, "search": 1, "tiered": 2, "bitunpack": 3}


def measure_phase(probe, smallest, launches, sweep, rng):
    """Each kernel at the largest input each path (and search step) gave it:
    back-to-back ``ms``, device-only ``graph_ms``, L2-cold ``cold_ms``, the
    host ``launch_us`` at its smallest sweep input, its plain version's and
    the PyTorch call's times, and its bound.  Then one ``bitunpack`` row at
    BITUNPACK_BIG_N values of words drawn from ``rng`` (step "2**24"), which
    no path launches: its count is the probe's, 0."""
    out = []
    names = list(WRAPPERS)
    keys = sorted(probe.largest, key=lambda k: (names.index(k[0]), PATH_ORDER[k[1]],
                                                k[2] or ""))
    small = {name: kernel_case(name, *smallest[name][1:])["launch"] for name in names}

    def measure(name, path, step, a, kw, launched):
        case = kernel_case(name, a, kw)
        mism, err, extra = case["check"]()
        lib = case["library"]
        bytes_ms = case["bytes"] / HBM_BYTES_PER_S * 1e3
        ops_ms = case["operations"] / case["ops_per_s"] * 1e3
        rec = {
            "name": name, "path": path, "step": step, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": KERNEL_REPLACES[name],
            "launches": launched,
            "launches_by_path": {p: n[name] for p, n in launches.items()},
            "max_abs_err": err,
            "ms": time_ms(case["launch"]),
            "graph_ms": graph_ms(case["launch"]),
            "cold_ms": cold_ms(case["launch"]),
            "launch_us": launch_us(small[name]),
            "plain_ms": time_ms(case["plain"]),
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": time_ms(lib) if lib else None,
            "library_graph_ms": graph_ms(lib) if lib else None,
            "shape": case["shape"], "bytes": case["bytes"],
            "operations": case["operations"],
            "cases": sweep[name]["cases"] + 1,
            "mismatches": mism + sweep[name]["mismatches"], **extra}
        del case
        check(mism == 0, f"{name} ({path}{' ' + step if step else ''}): disagrees with its "
              "plain version at the measured shape")
        out.append(rec)

    for key in keys:
        _, a, kw = probe.largest[key]
        measure(*key, a, kw, probe.launched[key])
    for name in names:
        check(any(r["name"] == name for r in out), f"{name}: no main-path input to measure")
    n, key = BITUNPACK_BIG_N, ("bitunpack", "bitunpack", "2**24")
    w = rng.integers(0, 1 << 32, -(-n * BITUNPACK_BITS // 32), dtype=np.uint64)
    words = ops.to_device(w.astype(np.uint32), ops.resolve_device())
    measure(*key, (words, n, BITUNPACK_BITS), {}, probe.launched.get(key, 0))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need one", file=sys.stderr)
        return 2
    check(not torch.backends.cuda.matmul.allow_tf32,
          "TF32 matmuls are on: the plain ivf_topk would round differently")
    t0 = time.perf_counter()
    device_phase()
    build_phase()
    sweep, smallest = sweep_phase()
    rng = np.random.default_rng(args.seed)
    phase_s = {}

    def timed(name, fn, *a):
        s = time.perf_counter()
        out = fn(*a)
        phase_s[name] = time.perf_counter() - s
        return out

    timed("gather_streams", gather_streams_phase, np.random.default_rng(args.seed + 1))
    table, files = dataset_phase(rng)
    probe = Probe()
    probe.path = "take"
    launches = {"take": timed("take", take_path_phase, table, files, rng, probe)}
    probe.path = "search"
    launches["search"] = timed("search", search_path_phase, table, files, rng, probe)
    probe.path = "tiered"
    launches["tiered"] = timed("tiered", tiered_path_phase, table, files, rng, probe)
    del files
    probe.path = "bitunpack"
    launches["bitunpack"] = bitunpack_path_phase(rng)
    probe.restore()
    for path, counts in launches.items():
        for name, n in counts.items():
            seen = sum(v for (k, p, _), v in probe.launched.items() if (k, p) == (name, path))
            check(seen == n, f"{name} on the {path} path: the probe saw {seen} of {n} launches")
    kernels = timed("measure", measure_phase, probe, smallest, launches, sweep, rng)
    emit({"phase": "done", "seconds": time.perf_counter() - t0, "phase_seconds": phase_s})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
