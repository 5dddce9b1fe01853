"""The tracer's steps (``Tracer(steps=True)``): off by default and then
absent from the event stream, named where the read path does its work,
counted, timed by self time, seen by ``torch.profiler``, and never changing
an answer; without a tracer of steps, recorded by ``PROFILER_STEPS`` while
a profiler records, one recording at a time."""

import time

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile

from repro_torch.core import arrays as A
from repro_torch.core import types as T
from repro_torch.core.file import WriteOptions
from repro_torch.dataset.manifest import write_fragments
from repro_torch.dataset.reader import DatasetReader
from repro_torch.kernels import ops
from repro_torch.obs import NULL_SPAN, NULL_TRACER, PROFILER_STEPS, Tracer

N_ROWS, N_FRAGMENTS, N_VECTORS = 300_000, 3, 1500

# the date column is flat: a take's rows are selected on the device
TAKE_STEPS = {"dataset.locate", "dataset.assemble", "miniblock.locate", "miniblock.parse",
              "miniblock.pack", "miniblock.select", "store.gather",
              "device.h2d", "device.miniblock_take", "device.d2h"}
SCAN_STEPS = {"dataset.assemble", "file.assemble", "miniblock.concat", "miniblock.parse", "miniblock.pack",
              "miniblock.unpack", "store.read", "device.h2d", "device.miniblock_decode",
              "device.d2h"}
VECTOR_STEPS = {"dataset.locate", "dataset.assemble", "fullzip.locate", "fullzip.decode",
                "store.gather", "device.h2d", "device.fullzip_gather", "device.d2h"}


@pytest.fixture(scope="module")
def date_files():
    rng = np.random.default_rng(25)
    col = A.PrimitiveArray(T.Primitive("int32", nullable=False), np.ones(N_ROWS, bool),
                           rng.integers(8000, 10600, N_ROWS).astype(np.int32))
    return write_fragments({"c": col}, N_FRAGMENTS, WriteOptions("lance", decode="device"))


@pytest.fixture(scope="module")
def vector_files():
    rng = np.random.default_rng(26)
    t = T.FixedSizeList(T.Primitive("float32", nullable=False), 256, nullable=True)
    col = A.FixedSizeListArray(t, rng.random(N_VECTORS) > 0.1,
                               rng.standard_normal((N_VECTORS, 256)).astype(np.float32))
    return write_fragments({"c": col}, 2, WriteOptions("lance", decode="device"))


def rows_of(n, k=40, seed=3):
    return np.random.default_rng(seed).choice(n, k, replace=False)


def needed_chunks(reader, rows) -> int:
    """Chunks a take must decode, from each fragment's footer: the chunk of
    the repetition index in which each row starts (flat rows never span)."""
    total = 0
    for f, start in enumerate(reader.manifest.row_starts):
        meta = reader.fragments[f].columns["c"]["leaves"][0]["meta"]
        local = rows[(rows >= start) & (rows < start + meta["n_rows"])] - start
        rows_before = np.array([r[0] for r in meta["rep_index"]])
        total += len(np.unique(np.searchsorted(rows_before, local, side="right") - 1))
    return total


def test_steps_are_off_by_default():
    for tr in (NULL_TRACER, Tracer(), Tracer(enabled=False, steps=True)):
        assert tr.step("miniblock.pack", bytes=1) is NULL_SPAN
        assert tr.usage("dataset") is NULL_SPAN
        tr.tally("miniblock.chunks", 5)
        assert tr.step_totals() == {} and tr.metrics.counter_values() == {}
    assert Tracer(steps=True).steps and not Tracer().steps and not NULL_TRACER.steps


def shape(events):
    return [(e["name"], e.get("cat"), e["ph"], e["tid"],
             {k: v for k, v in e.get("args", {}).items() if k != "sys_us"})
            for e in events]


@pytest.mark.parametrize("mix", ["take", "scan"])
def test_steps_add_only_step_events(date_files, mix):
    """The default tracer's events are the steps tracer's events less its
    ``step`` events (and the ``sys_us`` arg of the dataset span)."""
    runs = []
    for tr in (Tracer(), Tracer(steps=True)):
        r = DatasetReader(date_files, device="cpu", tracer=tr)
        r.take("c", rows_of(N_ROWS)) if mix == "take" else r.scan("c")
        runs.append(tr.events)
    plain, stepped = runs
    assert not any(e.get("cat") == "step" for e in plain)
    assert shape(plain) == shape([e for e in stepped if e.get("cat") != "step"])
    assert any(e.get("cat") == "step" for e in stepped)


def test_take_records_each_step_and_counts_chunks(date_files):
    tr = Tracer(steps=True)
    r = DatasetReader(date_files, device="cpu", tracer=tr)
    rows = rows_of(N_ROWS)
    r.take("c", rows)
    totals = tr.step_totals()
    assert set(totals) == TAKE_STEPS
    frags = len(np.unique(np.searchsorted(r.manifest.row_starts, rows, side="right")))
    for name in TAKE_STEPS - {"dataset.locate", "dataset.assemble"}:
        assert totals[name][0] == frags, name  # one call a fragment
    counts = tr.metrics.counter_values()
    chunks = needed_chunks(r, rows)
    assert 0 < chunks < sum(len(f.columns["c"]["leaves"][0]["meta"]["rep_index"])
                            for f in r.fragments)
    assert counts["miniblock.chunks"] == chunks
    assert counts["miniblock.chunks_staged"] == chunks  # every chunk staged in bulk
    assert counts["miniblock.rows_on_card"] == len(np.unique(rows))
    # each chunk is one span of the store's gather, counted under its route
    gathered = {k: v for k, v in counts.items() if k.startswith("store.gather_spans.")}
    assert set(gathered) <= {"store.gather_spans.strided", "store.gather_spans.sliced"}
    assert sum(gathered.values()) == chunks
    assert set(counts) - set(gathered) == {"miniblock.chunks", "miniblock.chunks_staged",
                                           "miniblock.rows_on_card", "dataset.sys_us"}
    span = next(e for e in tr.events if e["name"] == "dataset.take:c")
    assert span["args"]["sys_us"] == counts["dataset.sys_us"] >= 0
    steps = [e for e in tr.events if e.get("cat") == "step"]
    assert {e["name"] for e in steps} == TAKE_STEPS
    h2d = [e for e in steps if e["name"] == "device.h2d"]
    assert all(e["args"]["bytes"] > 0 for e in h2d)


def test_step_self_times_fit_in_the_take(date_files):
    tr = Tracer(steps=True)
    r = DatasetReader(date_files, device="cpu", tracer=tr)
    r.take("c", rows_of(N_ROWS, k=256))
    totals = tr.step_totals()
    span_s = next(e for e in tr.events if e["name"] == "dataset.take:c")["dur"] * 1e-6
    inside = sum(t[2] for n, t in totals.items() if n != "dataset.locate")
    assert 0 < inside <= span_s
    for calls, total, own in totals.values():
        assert calls >= 1 and 0 <= own <= total


def test_self_time_leaves_out_nested_steps_and_spans():
    tr = Tracer(steps=True)
    with tr.step("outer.a"):
        time.sleep(0.02)
        with tr.span("inner-span"):
            time.sleep(0.03)
        with tr.step("inner.b"):
            time.sleep(0.01)
    (calls, total, own), (b_calls, b_total, b_own) = (tr.step_totals()[k]
                                                      for k in ("outer.a", "inner.b"))
    assert calls == b_calls == 1 and b_own == pytest.approx(b_total)
    assert total >= 0.06 and 0.02 <= own < total - 0.035
    tr.reset()
    assert tr.step_totals() == {} and tr.events == []


def test_answers_are_identical_with_steps_on_and_off(date_files, vector_files):
    for files, n in ((date_files, N_ROWS), (vector_files, N_VECTORS)):
        rows = np.concatenate([rows_of(n, k=200, seed=9), rows_of(n, k=20, seed=9)])
        plain = DatasetReader(files, device="cpu")
        stepped = DatasetReader(files, device="cpu", tracer=Tracer(steps=True))
        for a, b in ((plain.take("c", rows), stepped.take("c", rows)),
                     (plain.scan("c"), stepped.scan("c"))):
            assert np.array_equal(a.validity, b.validity)
            assert np.array_equal(a.values, b.values)


def test_vector_take_records_its_steps(vector_files):
    tr = Tracer(steps=True)
    r = DatasetReader(vector_files, device="cpu", tracer=tr)
    r.take("c", rows_of(N_VECTORS, k=64))
    assert set(tr.step_totals()) == VECTOR_STEPS
    assert "miniblock.chunks" not in tr.metrics.counter_values()


@pytest.mark.parametrize("mix,kernel,ins,outs", [
    ("date take", "miniblock_take", 4, 1),
    ("date scan", "miniblock_decode", 4, 3),
    ("vector take", "fullzip_gather", 2, 1)])
def test_wrappers_in_ops_see_every_round_trip(date_files, vector_files, monkeypatch,
                                              mix, kernel, ins, outs):
    """The copies and the launch of a fragment's round trip are found in
    ``ops`` at call time: wrapped there by module attribute, as the
    benchmark's spans wrap them, they see each array that crosses, and each
    ``device.h2d`` / ``device.d2h`` step's bytes are the summed bytes of the
    arrays that crossed in it."""
    trips, pending = [], []  # per launch: (bytes of each array in, of each out)

    def wrapped(name, real):
        def call(*args, **kw):
            got = real(*args, **kw)
            if name == "to_device":
                pending.append(args[0].nbytes)
            elif name == "to_host":
                trips[-1][1].append(got.nbytes)
            else:
                trips.append((pending[:], []))
                pending.clear()
            return got
        return call

    for name in ("to_device", "to_host", kernel):
        monkeypatch.setattr(ops, name, wrapped(name, getattr(ops, name)))
    files, n = (vector_files, N_VECTORS) if mix == "vector take" else (date_files, N_ROWS)
    tr = Tracer(steps=True)
    r = DatasetReader(files, device="cpu", tracer=tr)
    if mix == "date scan":
        r.scan("c")
        frags = N_FRAGMENTS
    else:
        rows = rows_of(n)
        r.take("c", rows)
        frags = len(np.unique(np.searchsorted(r.manifest.row_starts, rows, side="right")))
    assert frags > 1 and not pending
    assert [(len(i), len(o)) for i, o in trips] == [(ins, outs)] * frags
    steps = [e for e in tr.events if e.get("cat") == "step"]
    for way, side in (("device.h2d", 0), ("device.d2h", 1)):
        assert [e["args"]["bytes"] for e in steps if e["name"] == way] == \
            [sum(t[side]) for t in trips], way


def test_copies_count_nothing_on_the_cpu(date_files):
    before = dict(ops.copies)
    DatasetReader(date_files, device="cpu").take("c", rows_of(N_ROWS))
    assert ops.copies == before
    assert set(ops.copies) == {"h2d", "d2h", "h2d_bytes", "d2h_bytes"}


@pytest.mark.parametrize("mix", ["take", "scan"])
def test_every_step_is_a_profiler_range(date_files, mix):
    tr = Tracer(steps=True)
    r = DatasetReader(date_files, device="cpu", tracer=tr)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        r.take("c", rows_of(N_ROWS)) if mix == "take" else r.scan("c")
    ranges = {e.key for e in prof.key_averages()}
    want = TAKE_STEPS if mix == "take" else SCAN_STEPS
    assert set(tr.step_totals()) == want
    assert want <= ranges
    # the spans are ranges too, under the same names
    assert {e["name"] for e in tr.events if e["ph"] == "X"} <= ranges


def test_without_steps_a_profiled_take_goes_to_the_recorder(date_files):
    r = DatasetReader(date_files, device="cpu")
    rows = rows_of(N_ROWS)
    r.take("c", rows)
    before = PROFILER_STEPS.step_totals()
    r.take("c", rows)
    assert PROFILER_STEPS.step_totals() == before  # no profiler, no record
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        r.take("c", rows)
    totals = PROFILER_STEPS.step_totals()
    assert set(totals) == TAKE_STEPS
    frags = len(np.unique(np.searchsorted(r.manifest.row_starts, rows, side="right")))
    for name in TAKE_STEPS - {"dataset.locate", "dataset.assemble"}:
        assert totals[name][0] == frags, name
    counts = PROFILER_STEPS.metrics.counter_values()
    assert counts["miniblock.chunks"] == counts["miniblock.chunks_staged"] == needed_chunks(r, rows)
    # no copy on the CPU; each chunk one span of the store's gather
    gathered = {k: v for k, v in counts.items() if k.startswith("store.gather_spans.")}
    assert sum(gathered.values()) == counts["miniblock.chunks"]
    assert set(counts) - set(gathered) == {"miniblock.chunks", "miniblock.chunks_staged",
                                           "miniblock.rows_on_card", "dataset.sys_us"}
    assert TAKE_STEPS <= {e.key for e in prof.key_averages()}
    assert r.tracer is NULL_TRACER and NULL_TRACER.events == []
    assert PROFILER_STEPS.events == []
    # the next recording starts afresh
    r.take("c", rows)
    with profile(activities=[ProfilerActivity.CPU]):
        r.scan("c")
    assert set(PROFILER_STEPS.step_totals()) == SCAN_STEPS
    assert PROFILER_STEPS.step_totals()["miniblock.parse"][0] == N_FRAGMENTS


def test_a_profiler_leaves_a_tracer_without_steps_as_it_was(date_files):
    runs = []
    for profiled in (False, True):
        tr = Tracer()
        r = DatasetReader(date_files, device="cpu", tracer=tr)
        if profiled:
            with profile(activities=[ProfilerActivity.CPU]):
                r.take("c", rows_of(N_ROWS))
        else:
            r.take("c", rows_of(N_ROWS))
        runs.append(shape(tr.events))
        assert tr.step_totals() == {} and tr.metrics.counter_values() == {}
    assert runs[0] == runs[1]
