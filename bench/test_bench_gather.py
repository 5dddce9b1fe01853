"""The take's gather routes: ``gather_indexed_share.take`` reads the port's
three span counters, and a traced take of either take cell gathers no span
through a per-byte index."""

import pytest

from bench import cell, manifest, program_steps
from bench.test_bench_runs import run


def reader():
    return manifest.load_reader("gather_indexed_share.take")


class Recorder:
    def __init__(self, counters):
        self.counters = counters
        self.metrics = self

    def counter_values(self):
        return dict(self.counters)


def record(layer_s=None):
    return cell.Record(mix="take", setup_s=3.0, window_s=2.0, latencies_s=[0.01], rows=256,
                       result_bytes=0, layer_s=layer_s)


@pytest.mark.parametrize("counters,share", [
    ({"store.gather_spans.strided": 1024}, 0.0),
    ({"store.gather_spans.sliced": 300, "store.gather_spans.indexed": 100}, 25.0),
    ({"store.gather_spans.indexed": 7, "miniblock.chunks": 9}, 100.0),
    ({"store.gather_spans.strided": 0, "miniblock.chunks": 9}, None),  # nothing gathered
    ({}, None),  # a port without the counters
])
def test_gather_indexed_share_reads_the_three_routes(monkeypatch, counters, share):
    monkeypatch.setattr(program_steps, "recorder",
                        lambda r: Recorder(counters) if r.layer_s else None)
    assert reader()(record(layer_s={"store": 0.1})) == share
    assert reader()(record()) is None  # untraced


@pytest.mark.parametrize("workload", ["shipdate.take256", "vector256k.take256"])
def test_traced_takes_gather_no_span_through_an_index(workload):
    out = run(workload, trace=True)
    assert out["correct"]
    assert out["metrics"]["gather_indexed_share.take"]["value"] == 0.0
