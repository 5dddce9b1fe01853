#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0]

Phases, one JSON object per line on stdout:

1. the card (``nvidia-smi`` name and power limit, also printed as it gives them);
2. the build of every CUDA kernel from ``src/repro_torch/kernels/csrc`` for
   ``sm_90a`` (seconds, ptxas lines);
3. the kernel sweep: each CUDA kernel against its plain PyTorch version on
   the card, over the shape sweeps of the tests (tolerance 0);
4. the main path: a dataset of 1,048,576 rows in 4 Lance files made from
   ``--seed`` (``id`` int64, ``score`` nullable int32, ``tags``
   List<int32> with nulls at both levels, ``emb`` FixedSizeList<float32>[384]),
   read through ``DatasetReader(decode="device")``: takes of 1,024 / 16,384 /
   65,536 random rows with duplicates on every column, and scans of ``id``
   and ``tags``.  Every result must equal the numpy route's and the source
   table's, with identical logical IO and modelled time; both kernels must
   have launched and no eligible column may fall back to the host;
5. each kernel at the largest input the main path gave it: its time, its
   plain version's, a PyTorch library call's where one computes the same
   function, and the least time the card could take (bytes over 3.35 TB/s);
6. the ``kernels`` line, then ``{"ok": true, "device": {...}}`` last.

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
from repro_torch.dataset import DatasetReader, write_fragments  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA data sheet)
INT_OPS_PER_S = 67e12  # H100 SXM non-tensor 32-bit rate (NVIDIA data sheet)
ROWS = 1 << 20  # the main path's dataset: ~1.6 GB in FRAGMENTS files
FRAGMENTS = 4
TAKE_SIZES = (1024, 16384, 65536)
COLUMNS = ("id", "score", "tags", "emb")
SCAN_COLUMNS = ("id", "tags")
KERNEL_REPLACES = {
    "miniblock_decode": "src/repro/kernels/miniblock_decode.py:107",
    "fullzip_gather": "src/repro/kernels/fullzip_gather.py:35",
}


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
                     ("miniblock_decode", "fullzip_gather", "to_device", "to_host")}
        for name, fn in self.real.items():
            setattr(ops, name, self._timed(name, fn))

    def _timed(self, name, fn):
        def timed(*args, **kw):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            out = fn(*args, **kw)
            e.record()
            self.events.setdefault(name, []).append((s, e))
            if name in KERNEL_REPLACES:
                size = sum(o.numel() for o in (out if isinstance(out, tuple) else (out,)))
                if size > self.largest.get(name, (0,))[0]:
                    self.largest[name] = (size, args, kw)
            return out

        return timed

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
    torch.cuda.synchronize()
    out = {k: {"cases": v[0], "mismatches": v[1], "max_abs_err": v[2]} for k, v in res.items()}
    emit({"phase": "kernels", "tolerance": 0, **out})
    for k, v in out.items():
        check(v["mismatches"] == 0, f"{k}: {v['mismatches']} mismatches against its plain version")
    return out


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


def main_path_phase(args):
    rng = np.random.default_rng(args.seed)
    t0 = time.perf_counter()
    table = make_table(ROWS, rng)
    t1 = time.perf_counter()
    files = write_fragments(table, FRAGMENTS, WriteOptions("lance", decode="device"))
    t2 = time.perf_counter()
    emit({"phase": "dataset", "rows": ROWS, "fragments": FRAGMENTS,
          "bytes": sum(len(f) for f in files), "gen_s": t1 - t0,
          "write_s": t2 - t1})

    dev = DatasetReader(files)  # decode route from the footer: "device", on CUDA
    host = DatasetReader(files, decode="numpy")
    del files
    check(dev.fragments[0].decode == "device", "footer did not select the device route")
    check(dev.fragments[0].device.type == "cuda", "device route is not on CUDA")

    probe = Probe()
    takes = [(k, rng.integers(0, ROWS, k)) for k in TAKE_SIZES]
    for _, rows in takes:  # duplicates, in and out of order
        rows[: len(rows) // 4] = rows[len(rows) // 2: len(rows) // 2 + len(rows) // 4][::-1]
    ops.reset_counts()  # the main path starts here
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
        rec["kernel_ms"] = {n: times.get(n, 0.0) for n in KERNEL_REPLACES}
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
              "kernel_ms": {n: times.get(n, 0.0) for n in KERNEL_REPLACES},
              "copy_ms": times.get("to_device", 0.0) + times.get("to_host", 0.0),
              "launches": {n: ops.launches[n] - n0[n] for n in ops.launches},
              "modelled_io_ms": dev.modelled_time() * 1e3})
    launches = dict(ops.launches)  # the main path ends here
    fallbacks = dict(ops.fallbacks)
    probe.restore()
    emit({"phase": "main_path", "checked": "exact vs decode=numpy and the source table; "
          "identical io_stats and modelled_time", "launches": launches,
          "fallbacks": fallbacks})
    for name, n in launches.items():
        check(n > 0, f"{name} never launched on the main path")
    check(not fallbacks, f"eligible columns fell back to the host: {fallbacks}")
    return launches, probe.largest


def measure_phase(largest, launches, sweep):
    """Each kernel at the largest input the main path gave it."""
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
        "bytes": nbytes, "operations": n_ops,
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
        "operations": n_take * stride,
        "max_abs_err": err, "mismatches": mism})
    for k in out:
        bytes_ms = k["bytes"] / HBM_BYTES_PER_S * 1e3
        ops_ms = k["operations"] / INT_OPS_PER_S * 1e3
        k.update({"route": "cuda",
                  "source": f"src/repro_torch/kernels/csrc/{k['name']}.cu",
                  "replaces": KERNEL_REPLACES[k["name"]],
                  "launches": launches[k["name"]],
                  "bound_ms": max(bytes_ms, ops_ms),
                  "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                  "cases": sweep[k["name"]]["cases"] + 1,
                  "mismatches": k["mismatches"] + sweep[k["name"]]["mismatches"]})
        check(k["mismatches"] == 0, f"{k['name']}: disagrees with its plain version "
              f"at the main-path shape")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms", "shape", "bytes",
            "cases", "mismatches")
    return [{key: k[key] for key in keys} for k in out]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need one", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    device_phase()
    build_phase()
    sweep = sweep_phase()
    launches, largest = main_path_phase(args)
    kernels = measure_phase(largest, launches, sweep)
    emit({"phase": "done", "seconds": time.perf_counter() - t0})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
