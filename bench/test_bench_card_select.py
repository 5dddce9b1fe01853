"""The date take's rows selected on the device: ``card_select_share.take``
reads the port's two selection counters, and an answer altered where the
``miniblock_take`` kernel produces it reads as not correct."""

import pytest

from bench import cell, manifest, program_steps
from bench.test_bench_runs import run


def reader():
    return manifest.load_reader("card_select_share.take")


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
    ({"miniblock.rows_on_card": 1024}, 100.0),
    ({"miniblock.rows_on_card": 768, "miniblock.rows_on_host": 256}, 75.0),
    ({"miniblock.rows_on_host": 512, "miniblock.chunks": 9}, 0.0),
    ({"miniblock.chunks": 9}, None),  # a port that counts neither
    ({}, None),  # a cell that reads no mini-block column
])
def test_card_select_share_reads_both_counters(monkeypatch, counters, share):
    monkeypatch.setattr(program_steps, "recorder",
                        lambda r: Recorder(counters) if r.layer_s else None)
    assert reader()(record(layer_s={"file": 0.1})) == share
    assert reader()(record()) is None  # untraced


def test_traced_date_take_selects_every_row_on_the_device():
    out = run("shipdate.take256", trace=True)
    assert out["correct"]
    assert out["metrics"]["card_select_share.take"]["value"] == 100.0
    assert "card_select_share.take" not in run("vector256k.take256", trace=True)["metrics"]


def test_altered_take_kernel_answer_is_not_correct(monkeypatch):
    from repro_torch.kernels import ops

    real = ops.miniblock_take

    def altered(*args, **kw):
        out = real(*args, **kw)
        out += 1
        return out

    monkeypatch.setattr(ops, "miniblock_take", altered)
    out = run("shipdate.take256")
    assert not out["correct"] and out["compared"]["wrong_values"]["value"] > 0
