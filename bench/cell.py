"""One run of one cell: set-up, the measured window, the comparison.

Set-up makes the configuration's column from the seed (``datagen``), writes
it with the port's own writer (``write_fragments`` with
``WriteOptions("lance", decode="device")``), opens a ``DatasetReader`` over
the files with the mix's reader settings (the reader's defaults: the flat
NVMe store, its queue depth, the decode route from the footers, which is the
device route on CUDA), and makes the mix's warm-up requests.  The window then
drives ``DatasetReader.take`` or ``.scan`` in a closed loop until
``seconds`` have passed and the request in flight has returned; each
request is timed from the call until its answer is on the host.  A seeded
sample of the window's answers is compared with the reference once the
window has closed, the peak device memory read and the reader freed.

A run that the card does not run ends before its window with
:class:`NoDeviceRoute`: a warm-up request whose decode fell back to the host
(the port has no device route for the cell's column), or a traced window on
the card in which the device was never busy.  No result is made for it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib
import json
import sys
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from . import devtrace, peaks, reference
from .manifest import Cell
from .reference import Column
from .spans import Spans
from .traffic import Requests

COLUMN = "c"


class NoDeviceRoute(RuntimeError):
    """The card runs none of the cell's reads: raised before any result."""


def seed_streams(seed: int) -> list:
    """The run's independent streams from ``--seed``: data, traffic,
    warm-up, sample."""
    return np.random.SeedSequence(seed % (1 << 64)).spawn(4)


def require_device_time(trace: Optional[devtrace.DeviceTrace]) -> None:
    """Raise :class:`NoDeviceRoute` unless the traced window on the card
    had the device busy for some time."""
    if trace is None or not trace.busy_s > 0:
        raise NoDeviceRoute("the traced window saw no device time")


@dataclasses.dataclass
class Record:
    """What a metric's reader reads: one run's window."""

    mix: str  # the traffic kind: "take" or "scan"
    setup_s: float
    window_s: float  # from the window's start to the end of its last request
    latencies_s: List[float]  # every request of the window
    rows: int  # rows returned in the window
    result_bytes: int  # bytes the window's answers hold (peaks.result_bytes)
    layer_s: Optional[Dict[str, float]] = None  # host self time by layer (traced)
    device: Optional[devtrace.DeviceTrace] = None  # (traced, on a card)
    iops: Optional[int] = None  # the store's logical IOs in the window (traced)

    @property
    def requests(self) -> int:
        return len(self.latencies_s)


class Sample:
    """A seeded reservoir sample of the window's answers, kept for the
    comparison.  Kept answers are copied into slots allocated and touched in
    set-up (:meth:`prepare`), so keeping them neither allocates in the
    window nor holds the port's own buffers alive (which would change how
    its allocations behave).  An answer that does not fit its slot's shape
    is held as it came."""

    def __init__(self, size: int, rng: np.random.Generator):
        self.size, self.rng, self.seen = int(size), rng, 0
        self.odd: Dict[int, tuple] = {}

    def prepare(self, rows, answer) -> None:
        """Allocate the slots in the shapes of a warm-up request and answer."""
        k, n = self.size, len(answer.validity)
        self.rows = None if rows is None else _touched((k, len(rows)), np.int64)
        self.validity = _touched((k, n), bool)
        self.values = _touched((k,) + answer.values.shape, answer.values.dtype)

    def offer(self, rows, answer) -> None:
        slot = self.seen if self.seen < self.size else int(self.rng.integers(0, self.seen + 1))
        self.seen += 1
        if slot >= self.size:
            return
        self.odd.pop(slot, None)
        fits = (answer.validity.shape == self.validity.shape[1:]
                and answer.values.shape == self.values.shape[1:]
                and answer.values.dtype == self.values.dtype
                and (rows is None) == (self.rows is None)
                and (rows is None or rows.shape == self.rows.shape[1:]))
        if not fits:
            self.odd[slot] = (None if rows is None else np.array(rows),
                              answer.validity, answer.values)
            return
        if rows is not None:
            self.rows[slot] = rows
        self.validity[slot] = answer.validity
        self.values[slot] = answer.values

    @property
    def kept(self) -> List[tuple]:
        """(rows or None for a scan, validity, values) of each kept answer."""
        out = []
        for slot in range(min(self.seen, self.size)):
            if slot in self.odd:
                out.append(self.odd[slot])
            else:
                out.append((None if self.rows is None else self.rows[slot],
                            self.validity[slot], self.values[slot]))
        return out


def _touched(shape, dtype) -> np.ndarray:
    a = np.empty(shape, dtype)
    a.fill(0)
    return a


def info(**fields) -> None:
    """An earlier line of the run's output (never the result line)."""
    print(json.dumps({"info": fields}), flush=True)


def make_column(config: dict, rng: np.random.Generator) -> Column:
    data = config["data"]
    gen = importlib.import_module(f"bench.datagen.{data['kind']}")
    return gen.make(data, int(config["rows"]), rng)


def program_array(col: Column, typ: dict):
    """The source column as the port's array type (``config["type"]``)."""
    from repro_torch.core import arrays as A
    from repro_torch.core import types as T

    child = T.Primitive(typ["dtype"], nullable=False)
    if typ["kind"] == "primitive":
        return A.PrimitiveArray(child.with_nullable(bool(typ["nullable"])),
                                col.validity, col.values)
    if typ["kind"] == "fixed_size_list":
        t = T.FixedSizeList(child, int(typ["size"]), nullable=bool(typ["nullable"]))
        return A.FixedSizeListArray(t, col.validity, col.values)
    raise ValueError(f"unknown column type {typ['kind']!r}")


def open_reader(cell: Cell, col: Column, device: str, phases: Dict[str, float]):
    """Write the column with the port's writer and open a reader on it."""
    from repro_torch.core.file import WriteOptions
    from repro_torch.dataset.manifest import write_fragments
    from repro_torch.dataset.reader import DatasetReader

    s = time.perf_counter()
    files = write_fragments({COLUMN: program_array(col, cell.config["type"])},
                            int(cell.config["fragments"]),
                            WriteOptions("lance", decode="device"))
    phases["write_s"] = time.perf_counter() - s
    phases["file_bytes"] = sum(len(f) for f in files)
    s = time.perf_counter()
    reader = DatasetReader(files, device=device, **cell.traffic.get("reader", {}))
    phases["open_s"] = time.perf_counter() - s
    routes = {fr.decode for fr in reader.fragments}
    if routes != {"device"}:
        raise RuntimeError(f"the files' decode route is {routes}, not the device route")
    return reader


def issue(reader, rows):
    return reader.scan(COLUMN) if rows is None else reader.take(COLUMN, rows)


def warm_up(reader, mix: dict, n_rows: int, rng, sync: Callable, sample: Sample) -> None:
    """The mix's warm-up requests, from their own stream; the sample's slots
    take the shapes of the last."""
    warm = Requests(mix, n_rows, rng)
    for _ in range(int(mix["warmup_requests"])):
        rows = warm.next()
        out = issue(reader, rows)
    sync()
    sample.prepare(rows, out)


def drive(reader, requests: Requests, seconds: float, sync: Callable, sample: Sample,
          fallbacks: Callable[[], int], annotate: bool = False):
    """The closed loop of the window.  Returns (record fields, failed): a
    request during which the decode route fell back to the host is failed."""
    from torch.profiler import record_function

    span = record_function if annotate else (lambda name: contextlib.nullcontext())
    lat, rows, nbytes, failed = [], 0, 0, 0
    with span(devtrace.WINDOW):
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            req = requests.next()
            f0 = fallbacks()
            s = time.perf_counter()
            with span(devtrace.REQUEST):
                out = issue(reader, req)
                sync()
            lat.append(time.perf_counter() - s)
            failed += fallbacks() != f0
            rows += len(out.validity)
            nbytes += peaks.result_bytes(out.validity, out.values)
            sample.offer(req, out)
        window_s = time.perf_counter() - t0
    return dict(window_s=window_s, latencies_s=lat, rows=rows, result_bytes=nbytes), failed


def judge(col: Column, sample: Sample) -> Dict[str, int]:
    """The reference's verdict on every kept answer: summed counts."""
    counts = dict.fromkeys(reference.LIMITS, 0)
    for rows, validity, values in sample.kept:
        want = reference.scan(col) if rows is None else reference.take(col, rows)
        for k, v in reference.compare(want, validity, values).items():
            counts[k] += v
    return counts


def verdict(counts: Dict[str, int], checked: int) -> tuple:
    compared = {k: {"value": counts[k], "limit": reference.LIMITS[k]} for k in reference.LIMITS}
    correct = checked > 0 and all(c["value"] <= c["limit"] for c in compared.values())
    return correct, compared


def quantiles_ms(lat: List[float]) -> dict:
    if not lat:
        return {}
    a = np.sort(np.asarray(lat)) * 1e3
    return {"n": len(a), "p50": float(a[len(a) // 2]), "p95": float(nearest_rank(a, 0.95)),
            "p99": float(nearest_rank(a, 0.99)), "max": float(a[-1])}


def per_second(lat: List[float]) -> List[int]:
    """Requests completed in each second of the window (its time line)."""
    ends = np.cumsum(lat)
    return np.bincount(ends.astype(np.int64)).tolist() if len(lat) else []


def nearest_rank(sorted_values, q: float):
    """The smallest value with at least a share ``q`` of values at or below it."""
    n = len(sorted_values)
    return sorted_values[max(int(np.ceil(q * n)), 1) - 1]


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device: str = "cuda",
             t_start: Optional[float] = None) -> dict:
    """One run; returns the result line's object (``correct``, ``attempted``,
    ``failed``, ``metrics``, ``device``, [``breakdown``], ``compared``)."""
    import torch
    from repro_torch.kernels import ops

    t_start = time.perf_counter() if t_start is None else t_start
    cuda = device == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    data_ss, traffic_ss, warm_ss, sample_ss = seed_streams(seed)
    phases = {"start_to_setup_s": time.perf_counter() - t_start}

    s = time.perf_counter()
    col = make_column(cell.config, np.random.default_rng(data_ss))
    phases["generate_s"] = time.perf_counter() - s
    reader = open_reader(cell, col, device, phases)
    s = time.perf_counter()
    sample = Sample(cell.traffic["check_requests"], np.random.default_rng(sample_ss))
    fell0 = dict(ops.fallbacks)
    warm_up(reader, cell.traffic, len(col), np.random.default_rng(warm_ss), sync, sample)
    phases["warmup_s"] = time.perf_counter() - s
    fell = {k: n - fell0.get(k, 0) for k, n in sorted(ops.fallbacks.items())
            if n > fell0.get(k, 0)}
    if fell:
        del reader
        gc.collect()
        raise NoDeviceRoute(", ".join(f"{k} x{n}" for k, n in fell.items())
                            + " in warm-up, before the window")

    requests = Requests(cell.traffic, len(col), np.random.default_rng(traffic_ss))
    fallbacks = lambda: sum(ops.fallbacks.values())  # noqa: E731
    launches0 = dict(ops.launches)
    spans = prof = None
    iops0 = 0
    if trace:
        iops0 = reader.io_stats().n_iops
        spans = Spans().install()
        prof = devtrace.profiler(cuda)
        prof.__enter__()
    setup_s = time.perf_counter() - t_start
    fields, failed = drive(reader, requests, seconds, sync, sample, fallbacks, annotate=trace)
    record = Record(mix=cell.traffic["kind"], setup_s=setup_s, **fields)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    launched = {k: v - launches0.get(k, 0) for k, v in ops.launches.items()}
    fell = dict(ops.fallbacks)
    if trace:
        prof.__exit__(None, None, None)
        spans.remove()
        record.layer_s = dict(spans.self_s)
        record.iops = reader.io_stats().n_iops - iops0
        record.device = devtrace.reduce(prof) if cuda else None
    info(setup=phases, setup_s=setup_s, seed=seed, trace=int(trace))
    info(window_s=record.window_s, requests=record.requests, rows=record.rows,
         latency_ms=quantiles_ms(record.latencies_s), per_second=per_second(record.latencies_s), launches=launched, fallbacks=fell,
         failed=failed, calls=dict(spans.calls) if spans else None)

    del reader, requests
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    if trace and cuda:
        require_device_time(record.device)
    counts = judge(col, sample)
    correct, compared = verdict(counts, len(sample.kept))
    info(checked_requests=len(sample.kept),
         checked_rows=int(sum(len(v) for _, v, _ in sample.kept)))

    group = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for m in group:
        v = cell.readers[m["name"]](record)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name() if cuda else "cpu",
           "count": cell.chips if cuda else 0, "memory_peak_bytes": int(peak)}
    out = {"correct": bool(correct), "attempted": record.requests, "failed": int(failed),
           "metrics": metrics, "device": dev}
    if trace and record.device is not None:
        dev["busy_s"] = record.device.busy_s
        dev["window_s"] = record.device.window_s
        out["breakdown"] = {"device_ops": record.device.device_ops,
                            "idle_gaps": record.device.idle_gaps}
    out["compared"] = compared
    return out


def forbidden_modules(modules=None) -> List[str]:
    """Top-level names of JAX and the JAX package among ``modules`` (the
    loaded modules by default), compared whole."""
    banned = {"jax", "jaxlib", "flax", "repro"}
    return sorted({m.split(".", 1)[0] for m in (sys.modules if modules is None else modules)}
                  & banned)
