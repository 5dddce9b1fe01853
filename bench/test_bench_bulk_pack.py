"""The date take's word rows staged in bulk: ``bulk_pack_share.take`` reads
the port's ``miniblock.chunks_staged`` over ``miniblock.chunks``."""

import pytest

from bench import cell, manifest, program_steps
from bench.test_bench_runs import run


def reader():
    return manifest.load_reader("bulk_pack_share.take")


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
    ({"miniblock.chunks_staged": 940, "miniblock.chunks": 940}, 100.0),
    ({"miniblock.chunks_staged": 30, "miniblock.chunks": 40}, 75.0),
    ({"miniblock.chunks_staged": 0, "miniblock.chunks": 9}, 0.0),  # every chunk a fallback
    ({"miniblock.chunks": 9}, None),  # a port without the bulk stager
    ({"miniblock.chunks_staged": 0}, None),
    ({}, None),  # a cell that reads no mini-block column
])
def test_bulk_pack_share_reads_both_counters(monkeypatch, counters, share):
    monkeypatch.setattr(program_steps, "recorder",
                        lambda r: Recorder(counters) if r.layer_s else None)
    assert reader()(record(layer_s={"file": 0.1})) == share
    assert reader()(record()) is None  # untraced


def test_traced_date_take_stages_every_chunk_in_bulk():
    out = run("shipdate.take256", trace=True)
    assert out["correct"]
    assert out["metrics"]["bulk_pack_share.take"]["value"] == 100.0
    assert "bulk_pack_share.take" not in run("vector256k.take256", trace=True)["metrics"]
