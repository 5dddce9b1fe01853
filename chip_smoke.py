#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0]

Phases, one JSON object per line on stdout:

1. the card (``nvidia-smi`` name and power limit, also printed as it gives them);
2. the build of every CUDA kernel from ``src/repro_torch/kernels/csrc`` for
   ``sm_90a`` (seconds, ptxas lines);
3. the kernel sweep: each CUDA kernel against its plain PyTorch version on
   the card, over the shape sweeps of the tests (tolerance 0, except
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
6. the ``bitunpack`` path: 2**20 values at 11 bits (the JAX package's
   ``kernel_bench`` size), unpacked on the card and checked against the
   packed values;
7. each kernel at the largest input its path gave it: its time, its plain
   version's, a PyTorch library call's where one computes the same
   function, and the least time the card could take (bytes over 3.35 TB/s
   or operations over 67 T/s, whichever is larger);
8. the ``kernels`` line, then ``{"ok": true, "device": {...}}`` last.

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
    """Mean device time of ``fn`` over ``reps`` back-to-back calls, by CUDA
    events (inputs stay L2-warm between calls)."""
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


class Probe:
    """Wraps the port's kernel wrappers and host<->device copies with CUDA
    events, and keeps the largest input the main path gave each kernel.
    The wrappers' own launch counts are untouched."""

    def __init__(self):
        self.events = {}
        self.largest = {}
        self.real = {n: getattr(ops, n) for n in
                     (*WRAPPERS.values(), "to_device", "to_host")}
        for name, fn in self.real.items():
            setattr(ops, name, self._timed(name, fn))

    def _timed(self, name, fn):
        kernel = {w: k for k, w in WRAPPERS.items()}.get(name)

        def timed(*args, **kw):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            out = fn(*args, **kw)
            e.record()
            self.events.setdefault(name, []).append((s, e))
            if kernel is not None:
                # ivf_topk by its candidate matrix, the others by their output
                size = args[1].numel() if kernel == "ivf_topk" else \
                    sum(o.numel() for o in (out if isinstance(out, tuple) else (out,)))
                if size > self.largest.get(kernel, (0,))[0]:
                    self.largest[kernel] = (size, args, kw)
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
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    res = {"miniblock_decode": [0, 0, 0], "fullzip_gather": [0, 0, 0]}
    for rep_bits, def_bits in [(0, 0), (0, 1), (0, 2), (1, 2), (2, 3)]:
        for vpe in (1, 4):
            for C in (1, 4, 33):
                for tile, max_bits, refs in ((1024, 24, (-100, 100)),
                                             (512, 31, (1 << 30, (1 << 31) - 1))):
                    case = ref.miniblock_case(rng, rep_bits, def_bits, vpe, C,
                                              tile, max_bits, refs)
                    t = [torch.from_numpy(a).to(dev) for a in case]
                    got = ops.miniblock_decode(*t, rep_bits=rep_bits, def_bits=def_bits,
                                               vpe=vpe, tile_entries=tile, fill=-5)
                    want = ref.miniblock_decode_ref(t[0], t[1], t[2], t[3][:, 0], t[3][:, 1],
                                                    t[3][:, 2], tile, rep_bits, def_bits, vpe, -5)
                    m, e = _compare(got, want)
                    r = res["miniblock_decode"]
                    r[0] += 1
                    r[1] += m
                    r[2] = max(r[2], e)
    for stride in (1, 8, 24, 33, 129, 136, 512, 1536):
        for n_take in (0, 1, 7, 64, 1000):
            zipped = torch.from_numpy(rng.integers(0, 256, (300, stride), dtype=np.uint8)).to(dev)
            rows = torch.from_numpy(rng.integers(0, 300, n_take).astype(np.int32)).to(dev)
            m, e = _compare((ops.fullzip_gather(zipped, rows),),
                            (ref.fullzip_gather_ref(zipped, rows),))
            r = res["fullzip_gather"]
            r[0] += 1
            r[1] += m
            r[2] = max(r[2], e)
    res["bitunpack"] = [0, 0, 0]
    for bits in (1, 3, 5, 8, 11, 16, 21, 32):
        for n in (1, 100, 8192, 20000):
            v = rng.integers(0, 2 ** min(bits, 62), n, dtype=np.uint64)
            words = torch.from_numpy(ops.pack_words(bitpack(v, bits))).to(dev)
            got = ops.bitunpack(words, n, bits)
            m, e = _compare((got,), (ref.bitunpack_ref(words, n, bits),))
            m += int((got.cpu().numpy() != v).sum())
            r = res["bitunpack"]
            r[0] += 1
            r[1] += m
            r[2] = max(r[2], e)
    res["ivf_topk"] = [0, 0, 0.0]
    ties = 0
    for q, c, ids, k, mask in ivf_cases(rng, dev):
        got = ops.ivf_topk_tensors(q, c, ids, k, mask)
        want = ref.ivf_topk_ref(q, c, ids, k, mask)
        m, e, g = compare_topk(got, want, ref.ivf_topk_scale(q, c))
        r = res["ivf_topk"]
        r[0] += 1
        r[1] += m
        r[2] = max(r[2], e)
        ties += g
    torch.cuda.synchronize()
    out = {k: {"cases": v[0], "mismatches": v[1], "max_abs_err": v[2]} for k, v in res.items()}
    out["ivf_topk"]["near_tie_groups"] = ties
    emit({"phase": "kernels", "tolerance": 0, "ivf_topk_rtol": RTOL, **out})
    for k, v in out.items():
        check(v["mismatches"] == 0, f"{k}: {v['mismatches']} mismatches against its plain version")
    return out


def ivf_cases(rng, dev):
    """The ivf_topk sweep: the grid of the JAX package's parity test, with
    and without a mask, then a tie across tiles and an exhaustion case."""
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


def measure_phase(largest, launches, sweep):
    """Each kernel at the largest input its path gave it."""
    out = []
    size, a, kw = largest["miniblock_decode"]
    rw, dw, vw, p = a
    C, tile, vpe = vw.shape[0], kw["tile_entries"], kw.get("vpe", 1)
    rb, db, fill = kw["rep_bits"], kw["def_bits"], kw.get("fill", 0)
    got = ops.miniblock_decode(*a, **kw)
    plain = lambda: ref.miniblock_decode_ref(rw, dw, vw, p[:, 0], p[:, 1], p[:, 2],  # noqa: E731
                                             tile, rb, db, vpe, fill)
    mism, err = _compare(got, plain())
    bufs = [torch.empty_like(g) for g in got]
    nbytes = (4 * ((rw.numel() if rb else 0) + (dw.numel() if db else 0) + vw.numel()
                   + p.numel()) + sum(4 * g.numel() for g in got))
    n_ops = sum(g.numel() for g in got)
    out.append({
        "name": "miniblock_decode",
        "shape": {"chunks": C, "rep_words": rw.shape[1], "def_words": dw.shape[1],
                  "val_words": vw.shape[1], "rep_bits": rb, "def_bits": db, "vpe": vpe,
                  "tile_entries": tile, "fill": fill},
        "ms": time_ms(lambda: ops.launch_miniblock_decode(
            rw, dw, vw, p, *bufs, rep_bits=rb, def_bits=db, vpe=vpe, fill=fill)),
        "plain_ms": time_ms(plain),
        "library_ms": None,
        "bytes": nbytes, "operations": n_ops, "ops_per_s": INT_OPS_PER_S,
        "max_abs_err": err, "mismatches": mism})
    size, a, kw = largest["fullzip_gather"]
    zipped, rows = a
    got = ops.fullzip_gather(zipped, rows)
    mism, err = _compare((got,), (ref.fullzip_gather_ref(zipped, rows),))
    buf = torch.empty_like(got)
    n_take, stride = got.shape
    n_unique = int(torch.unique(rows).numel())
    out.append({
        "name": "fullzip_gather",
        "shape": {"n_rows": zipped.shape[0], "row_bytes": stride, "n_take": n_take,
                  "unique_rows": n_unique},
        "ms": time_ms(lambda: ops.launch_fullzip_gather(zipped, rows, buf)),
        "plain_ms": time_ms(lambda: ref.fullzip_gather_ref(zipped, rows)),
        "library_ms": time_ms(lambda: torch.index_select(zipped, 0, rows)),
        "bytes": n_unique * stride + 4 * n_take + n_take * stride,
        "operations": n_take * stride, "ops_per_s": INT_OPS_PER_S,
        "max_abs_err": err, "mismatches": mism})
    size, a, kw = largest["ivf_topk"]
    q, c, ids, k = a[:4]
    mask = a[4] if len(a) > 4 else kw.get("mask")
    (qn, dim), n = q.shape, c.shape[0]
    got = ops.ivf_topk_tensors(q, c, ids, k, mask)
    mism, err, ties = compare_topk(got, ref.ivf_topk_ref(q, c, ids, k, mask),
                                   ref.ivf_topk_scale(q, c))
    bufs = [torch.empty_like(g) for g in got]
    out.append({
        "name": "ivf_topk",
        "shape": {"queries": qn, "candidates": n, "dim": dim, "k": k,
                  "mask": mask is not None},
        "ms": time_ms(lambda: ops.launch_ivf_topk(q, c, ids, mask, *bufs)),
        "plain_ms": time_ms(lambda: ref.ivf_topk_ref(q, c, ids, k, mask)),
        "library_ms": None,
        "bytes": 4 * n * dim + (qn * n if mask is not None else 0) + 4 * n
        + 4 * qn * dim + 8 * qn * k,
        "operations": 2 * qn * n * dim, "ops_per_s": FP32_FLOPS_PER_S,
        "max_abs_err": err, "mismatches": mism, "near_tie_groups": ties})
    size, a, kw = largest["bitunpack"]
    words, n_vals, bits = a
    got = ops.bitunpack(words, n_vals, bits)
    mism, err = _compare((got,), (ref.bitunpack_ref(words, n_vals, bits),))
    buf = torch.empty_like(got)
    out.append({
        "name": "bitunpack",
        "shape": {"values": n_vals, "bits": bits, "words": words.shape[0]},
        "ms": time_ms(lambda: ops.launch_bitunpack(words, buf, bits=bits)),
        "plain_ms": time_ms(lambda: ref.bitunpack_ref(words, n_vals, bits)),
        "library_ms": None,
        "bytes": -(-n_vals * bits // 8) + 4 * n_vals,
        "operations": n_vals, "ops_per_s": INT_OPS_PER_S,
        "max_abs_err": err, "mismatches": mism})
    for k in out:
        bytes_ms = k["bytes"] / HBM_BYTES_PER_S * 1e3
        ops_ms = k["operations"] / k["ops_per_s"] * 1e3
        k.update({"route": "cuda",
                  "source": f"src/repro_torch/kernels/csrc/{k['name']}.cu",
                  "replaces": KERNEL_REPLACES[k["name"]],
                  "launches": sum(p[k["name"]] for p in launches.values()),
                  "launches_by_path": {path: p[k["name"]] for path, p in launches.items()},
                  "bound_ms": max(bytes_ms, ops_ms),
                  "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                  "cases": sweep[k["name"]]["cases"] + 1,
                  "mismatches": k["mismatches"] + sweep[k["name"]]["mismatches"]})
        check(k["mismatches"] == 0, f"{k['name']}: disagrees with its plain version "
              f"at the largest path shape")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms", "launches_by_path", "shape",
            "bytes", "operations", "cases", "mismatches")
    return [{key: k[key] for key in keys} for k in out]


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
    sweep = sweep_phase()
    rng = np.random.default_rng(args.seed)
    table, files = dataset_phase(rng)
    probe = Probe()
    launches = {"take": take_path_phase(table, files, rng, probe)}
    launches["search"] = search_path_phase(table, files, rng, probe)
    del files
    launches["bitunpack"] = bitunpack_path_phase(rng)
    probe.restore()
    kernels = measure_phase(probe.largest, launches, sweep)
    emit({"phase": "done", "seconds": time.perf_counter() - t0})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
