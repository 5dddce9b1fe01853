"""The port's own steps in a traced run: the device trace names its idle
gaps by them, and the readers of ``bench/program_steps.py`` do their
arithmetic on the port's step recorder."""

import sys

import numpy as np
import pytest

from bench import cell, devtrace, manifest, program_steps

STEP_READERS = ("row_select_ms.take", "word_pack_ms.take", "word_pack_ms.scan",
                "unshred_ms.scan", "chunks_per_request.take", "copies_per_request.take",
                "copies_per_request.scan", "sys_ms.take", "sys_ms.scan")


def reader(name):
    return manifest.load_reader(name)


def record(lat, layer_s=None):
    return cell.Record(mix="take", setup_s=3.0, window_s=2.0, latencies_s=lat, rows=256,
                       result_bytes=0, layer_s=layer_s)


def small_reader():
    c = manifest.cell("shipdate.take256")
    c.config = dict(c.config, rows=60_000, fragments=3)
    col = cell.make_column(c.config, np.random.default_rng(7))
    return cell.open_reader(c, col, "cpu", {}), len(col)


def test_program_steps_name_the_idle_gaps():
    """A take by a reader opened as the harness opens it (no tracer), under
    the harness's profiler: the gaps of the device trace are named by what
    the program was doing, and the recorder holds the take's steps."""
    from torch.profiler import record_function

    reader_, n = small_reader()
    rows = np.random.default_rng(8).choice(n, 256, replace=False)
    reader_.take(cell.COLUMN, rows)  # a step outside any recording
    with devtrace.profiler(cuda=False) as prof:
        with record_function(devtrace.WINDOW):
            reader_.take(cell.COLUMN, rows)
    t = devtrace.reduce(prof)
    names = [n for n, _ in t.idle_gaps]
    assert any(n.startswith("miniblock.") for n in names), names
    assert any(n.startswith("device.") for n in names), names
    r = record([0.01], layer_s={"file": 0.001})
    totals = program_steps.recorder(r).step_totals()
    assert totals["miniblock.select"][0] == totals["dataset.locate"][0] * 3 == 3
    assert reader("chunks_per_request.take")(r) > 0
    assert reader("copies_per_request.take")(r) == 0  # nothing crosses on the CPU


class Recorder:
    def __init__(self, totals, counters):
        self.totals, self.counters = totals, counters
        self.metrics = self

    def step_totals(self):
        return dict(self.totals)

    def counter_values(self):
        return dict(self.counters)


def test_program_step_and_counter_readers(monkeypatch):
    steps = {"miniblock.pack": (8, 0.040, 0.030), "miniblock.select": (8, 0.020, 0.018),
             "miniblock.unpack": (8, 0.012, 0.010), "fullzip.decode": (1, 0.004, 0.002),
             "file.assemble": (8, 0.01, 0.008), "store.gather": (8, 0.5, 0.5),
             "device.d2h": (24, 0.3, 0.3), "dataset.locate": (4, 0.01, 0.01)}
    counters = {"miniblock.chunks": 940, "dataset.sys_us": 10_000, "ops.copies": 28}
    traced = record([0.01] * 4, layer_s={"file": 0.1})
    rec = Recorder(steps, counters)
    monkeypatch.setattr(program_steps, "recorder", lambda r: rec if r.layer_s else None)
    # self times a request, over 4 requests: 18 ms of selection, 30 + 10 of
    # packing and unpacking, 8 of unshred
    assert reader("row_select_ms.take")(traced) == pytest.approx(4.5)
    assert reader("word_pack_ms.take")(traced) == pytest.approx(10.0)
    assert reader("unshred_ms.scan")(traced) == pytest.approx(2.0)
    assert reader("chunks_per_request.take")(traced) == pytest.approx(235.0)
    assert reader("copies_per_request.scan")(traced) == pytest.approx(7.0)
    assert reader("sys_ms.take")(traced) == pytest.approx(2.5)
    # a traced run that took no such step or count reads 0
    rec.totals, rec.counters = {"store.gather": (1, 1.0, 1.0)}, {}
    for name in STEP_READERS:
        assert reader(name)(traced) == 0
    # untraced: nothing to read
    for name in STEP_READERS:
        assert reader(name)(record([0.01])) is None


def test_recorder_is_none_untraced_empty_or_on_an_older_port(monkeypatch):
    traced = record([0.01], layer_s={"file": 0.1})
    assert program_steps.recorder(traced) is not None
    assert program_steps.recorder(record([0.01])) is None
    assert program_steps.recorder(record([], layer_s={})) is None
    # a port without the recorder: its module has no such name
    monkeypatch.setitem(sys.modules, "repro_torch.obs.trace", object())
    assert program_steps.recorder(traced) is None
    for name in STEP_READERS:
        assert reader(name)(traced) is None
