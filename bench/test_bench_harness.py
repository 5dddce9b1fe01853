"""The harness's parts on the CPU: the frozen generators, the traffic
generator, the reference's comparison, the sample, the spans, the device
trace's reduction and the metric arithmetic."""

import time

import numpy as np
import pytest

from bench import cell, controls, devtrace, manifest, peaks, reference, traffic
from bench.datagen import paper_vector, tpch_shipdate
from bench.reference import Column
from bench.spans import Spans


# -- the frozen generators ---------------------------------------------------

def test_shipdate_follows_dbgen_rules():
    col = tpch_shipdate.make({}, 100_000, np.random.default_rng(5))
    assert col.values.dtype == np.int32 and col.validity.all() and len(col) == 100_000
    lo = tpch_shipdate.START_DATE + 1
    hi = tpch_shipdate.LAST_ORDER_DATE + tpch_shipdate.SHIP_DELAY_DAYS[1]
    assert col.values.min() >= lo and col.values.max() <= hi
    # unsorted, spread over the whole range, and fixed by the seed
    assert (np.diff(col.values) < 0).mean() > 0.3
    again = tpch_shipdate.make({}, 100_000, np.random.default_rng(5))
    assert np.array_equal(col.values, again.values)


def test_vector_follows_the_papers_type():
    col = paper_vector.make({"size": 768}, 4096, np.random.default_rng(1))
    assert col.values.shape == (4096, 768) and col.values.dtype == np.float32
    assert 0.08 < 1 - col.validity.mean() < 0.12  # 10% nulls
    assert abs(float(col.values.mean())) < 0.01 and 0.98 < float(col.values.std()) < 1.02


def test_vector_null_rule_matches_the_ports_synth():
    synth = pytest.importorskip("repro_torch.data.synth")
    ours = paper_vector.make({"size": 768}, 1000, np.random.default_rng(3))
    theirs = synth.paper_type("vector", 1000, seed=3)
    assert np.array_equal(ours.validity, theirs.validity)


@pytest.mark.parametrize("name", [c["name"] for c in manifest.load()["configs"]])
def test_config_column_matches_its_type(name):
    doc = manifest.load()
    cfg = next(c for c in doc["configs"] if c["name"] == name)
    c = manifest.cell(next(w["name"] for w in doc["workloads"] if w["config"] == name), doc)
    config = dict(c.config, rows=256)
    col = cell.make_column(config, np.random.default_rng(0))
    typ = config["type"]
    assert col.values.dtype == np.dtype(typ["dtype"]) and len(col) == 256
    assert (typ["kind"] == "fixed_size_list") == (col.values.ndim == 2)
    assert typ["nullable"] or col.validity.all()
    assert cfg["file"].endswith(f"{name}.json")


# -- traffic ------------------------------------------------------------------

def test_uniform_distinct_takes():
    mix = {"kind": "take", "loop": "closed", "rows_per_request": 256,
           "warmup_requests": 1, "check_requests": 1}
    r = traffic.Requests(mix, 10_000, np.random.default_rng(1))
    takes = [r.next() for _ in range(200)]
    assert all(len(np.unique(t)) == 256 for t in takes)
    allrows = np.concatenate(takes)
    assert allrows.min() >= 0 and allrows.max() < 10_000
    assert abs(allrows.mean() - 5000) < 200  # uniform
    assert not all((np.diff(t) > 0).all() for t in takes)  # random order


def test_scan_requests_and_bad_mixes():
    mix = {"kind": "scan", "loop": "closed", "warmup_requests": 1, "check_requests": 1}
    assert traffic.Requests(mix, 10, np.random.default_rng(0)).next() is None
    for bad in ({**mix, "kind": "write"}, {**mix, "loop": "open"}, {**mix, "warmup_requests": 0},
                {**mix, "kind": "take", "rows_per_request": 0}):
        with pytest.raises(ValueError):
            traffic.check(bad)


def test_shipped_mixes_are_valid():
    for p in (manifest.BENCH / "traffic").glob("*.json"):
        traffic.check(manifest.load(p))


# -- the comparison ------------------------------------------------------------

def test_compare_counts_each_breach():
    want = Column(np.array([True, False, True]), np.arange(6, dtype=np.float32).reshape(3, 2))
    assert reference.compare(want, want.validity, want.values) == dict.fromkeys(reference.LIMITS, 0)
    vals = want.values.copy()
    vals[1] = 99  # a null row's slot is not compared
    assert reference.compare(want, want.validity, vals)["wrong_values"] == 0
    vals[2, 1] = np.nextafter(vals[2, 1], 100)  # the last bit counts
    assert reference.compare(want, want.validity, vals)["wrong_values"] == 1
    assert reference.compare(want, [True, True, True], want.values)["wrong_validity"] == 1
    assert reference.compare(want, want.validity[:1], want.values[:1])["missing_rows"] == 2
    assert reference.compare(want, want.validity, want.values.astype(np.float64))["wrong_values"] == 2


def test_bfloat16_control_rounds_to_nearest_even():
    x = np.array([1.0, 1.0 + 2 ** -8, 1.0 + 3 * 2 ** -9, -2.5], dtype=np.float32)
    got = controls.lower_precision(x)
    assert got.dtype == np.float32
    assert got[0] == 1.0 and got[1] == 1.0 and got[2] == 1.0 + 2 ** -7 and got[3] == -2.5
    assert np.array_equal(controls.lower_precision(np.array([70000], np.int32)),
                          np.array([70000], np.int32).astype(np.int16).astype(np.int32))


# -- the sample ----------------------------------------------------------------

def answer(rows):
    return Column(np.ones(len(rows), bool), np.asarray(rows, np.int32) * 2)


def test_sample_keeps_all_when_few_and_a_seeded_subset_when_many():
    s = cell.Sample(8, np.random.default_rng(0))
    s.prepare(np.arange(4), answer(np.arange(4)))
    for i in range(5):
        s.offer(np.arange(4) + i, answer(np.arange(4) + i))
    assert [int(r[0]) for r, _, _ in s.kept] == [0, 1, 2, 3, 4]
    picks = []
    for seed in (0, 0, 1):
        s = cell.Sample(8, np.random.default_rng(seed))
        s.prepare(np.arange(4), answer(np.arange(4)))
        for i in range(1000):
            s.offer(np.arange(4) + i, answer(np.arange(4) + i))
        picks.append(sorted(int(r[0]) for r, _, _ in s.kept))
        assert all(np.array_equal(v, (r * 2).astype(np.int32)) for r, _, v in s.kept)
    assert picks[0] == picks[1] != picks[2] and len(picks[0]) == 8


def test_sample_copies_answers_and_keeps_odd_shapes():
    s = cell.Sample(2, np.random.default_rng(0))
    s.prepare(np.arange(4), answer(np.arange(4)))
    a = answer(np.arange(4))
    s.offer(np.arange(4), a)
    a.values[:] = -1  # the caller reuses its buffer: the kept copy stands
    s.offer(np.arange(4), answer(np.arange(2)))
    (r0, _, v0), (r1, val1, v1) = s.kept
    assert list(v0) == [0, 2, 4, 6] and len(val1) == 2


# -- spans and the device trace ---------------------------------------------------

def test_spans_give_self_time_by_layer(monkeypatch):
    from repro_torch.dataset import reader
    from repro_torch.kernels import ops

    def take(self, name, rows):
        time.sleep(0.02)
        ops.to_host(None)
        return None

    monkeypatch.setattr(reader.DatasetReader, "take", take)
    monkeypatch.setattr(ops, "to_host", lambda t: time.sleep(0.05))
    spans = Spans(annotate=False).install()
    try:
        reader.DatasetReader.take(None, "c", [1])
    finally:
        spans.remove()
    assert reader.DatasetReader.take is take and not hasattr(ops.to_host, "__wrapped__")
    # the take's own 20 ms, less the 50 ms spent in the wrapped copy
    assert spans.self_s["ops"] >= 0.05 and 0.02 <= spans.self_s["dataset"] < spans.self_s["ops"]
    assert spans.calls == {"dataset.take": 1, "ops.to_host": 1}


def ev(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def test_device_trace_reduction():
    events = [ev(devtrace.WINDOW, "user_annotation", 100, 1000),
              ev("dataset.take", "user_annotation", 100, 600),
              ev("ops.to_host", "user_annotation", 500, 100),
              ev("k1", "kernel", 50, 100),  # starts before the window: clipped
              ev("k1", "kernel", 520, 40),
              ev("Memcpy DtoH", "gpu_memcpy", 550, 30),  # overlaps k1
              ev("k2", "kernel", 1500, 10),  # after the window: dropped
              ev("cpu op", "cpu_op", 100, 900)]
    t = devtrace.reduce_events(events)
    assert t.window_s == pytest.approx(1000e-6)
    assert t.busy_s == pytest.approx((50 + 60) * 1e-6)
    assert t.kernel_s == pytest.approx(90e-6) and t.copy_s == pytest.approx(30e-6)
    assert t.device_ops[0] == ["k1", pytest.approx(90e-6)]
    gaps = dict(t.idle_gaps)
    assert gaps["dataset.take"] == pytest.approx((350 + 100) * 1e-6)  # 150..500, 600..700
    assert gaps["ops.to_host"] == pytest.approx(40e-6)  # 500..520, 580..600
    assert gaps["bench.window"] == pytest.approx(400e-6)  # 700..1100, after the take
    assert devtrace.reduce_events([ev("k", "kernel", 0, 1)]) is None


def test_device_trace_from_a_cpu_profile():
    import torch
    from torch.profiler import record_function

    with devtrace.profiler(cuda=False) as prof:
        with record_function(devtrace.WINDOW):
            with record_function("dataset.take"):
                torch.ones(8).sum()
    t = devtrace.reduce(prof)
    assert t is not None and t.window_s > 0 and t.busy_s == 0 and t.kernel_s == 0
    assert t.idle_gaps and t.idle_gaps[0][0] in (devtrace.WINDOW, "dataset.take")


# -- metric arithmetic -----------------------------------------------------------

def record(mix, lat, rows, window_s=2.0, **kw):
    return cell.Record(mix=mix, setup_s=3.0, window_s=window_s, latencies_s=lat,
                       rows=rows, result_bytes=kw.pop("result_bytes", 0), **kw)


def reader(name):
    return manifest.load_reader(name)


def test_take_p95_is_over_every_take():
    lat = [i / 1000 for i in range(1, 101)]  # 1..100 ms
    assert reader("take_p95_ms")(record("take", lat, 25600)) == pytest.approx(95.0)
    assert reader("take_p95_ms")(record("take", lat[:10], 2560)) == pytest.approx(10.0)
    assert reader("take_p95_ms")(record("scan", lat, 10)) is None
    assert reader("take_rows_per_s")(record("take", lat, 25600, window_s=2.0)) == 12800
    assert reader("setup_s")(record("take", lat, 1)) == 3.0


def test_scan_rate_is_over_the_whole_window_including_the_last_scan():
    class SlowScans:
        def scan(self, column):
            time.sleep(0.3)
            return Column(np.ones(1000, bool), np.zeros(1000, np.int32))

    mix = {"kind": "scan", "loop": "closed", "warmup_requests": 1, "check_requests": 1}
    req = traffic.Requests(mix, 1000, np.random.default_rng(0))
    s = cell.Sample(1, np.random.default_rng(0))
    s.prepare(None, SlowScans().scan("c"))
    fields, failed = cell.drive(SlowScans(), req, 0.5, lambda: None, s, lambda: 0)
    assert len(fields["latencies_s"]) == 2 and fields["rows"] == 2000 and failed == 0
    assert fields["window_s"] >= 0.6  # the scan in flight at 0.5 s finished
    rate = reader("scan_rows_per_s")(record("scan", fields["latencies_s"], 2000,
                                            window_s=fields["window_s"]))
    assert rate == pytest.approx(2000 / fields["window_s"])


def test_layer_and_device_readers():
    dev = devtrace.DeviceTrace(window_s=2.0, busy_s=0.5, kernel_s=0.001, copy_s=0.004,
                               device_ops=[], idle_gaps=[])
    r = record("take", [0.01] * 4, 1024, layer_s={"dataset": 0.004, "file": 0.02, "store": 0.008,
                                                   "ops": 0.012}, device=dev, iops=512,
               result_bytes=3_350_000)
    assert reader("reader_self_ms.take")(r) == pytest.approx(1.0)
    assert reader("file_self_ms.scan")(r) == pytest.approx(5.0)
    assert reader("store_ms.take")(r) == pytest.approx(2.0)
    assert reader("ops_host_ms.take")(r) == pytest.approx(3.0)
    assert reader("copy_ms.take")(r) == pytest.approx(1.0)
    assert reader("iops_per_row.take")(r) == pytest.approx(0.5)
    assert reader("idle_share.take")(r) == pytest.approx(75.0)
    # 3.35 MB written and read at 3.35 TB/s is 2 us, over 1 ms of kernels
    assert reader("device_roofline.take")(r) == pytest.approx(0.2)
    assert peaks.memory_bound_s(3_350_000) == pytest.approx(2e-6)
    untraced = record("take", [0.01], 256)
    for name in ("reader_self_ms.take", "copy_ms.take", "iops_per_row.take",
                 "device_roofline.take", "idle_share.take"):
        assert reader(name)(untraced) is None


def test_result_bytes_counts_values_and_validity_bits():
    assert peaks.result_bytes(np.ones(9, bool), np.zeros((9, 4), np.float32)) == 9 * 16 + 2
