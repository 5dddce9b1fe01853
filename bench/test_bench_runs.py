"""Whole runs of every cell on the CPU at a tiny size (the harness's look
for a card skipped, the port's kernels in their plain versions): a sound run
reads as correct; the timed path broken underneath, or a control in its
place, reads as not correct; and ``run.py`` refuses to run without a card."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from bench import cell, control, controls, manifest

DOC = manifest.load()
CELLS = [w["name"] for w in DOC["workloads"]]
TINY = {"tpch-sf1-lineitem-shipdate": {"rows": 20_000, "fragments": 3},
        "lance-paper-vector-256k": {"rows": 1_500, "fragments": 1}}


def tiny(name):
    c = manifest.cell(name, DOC)
    w = next(w for w in DOC["workloads"] if w["name"] == name)
    c.config = dict(c.config, **TINY[w["config"]])
    c.traffic = dict(c.traffic, warmup_requests=2)
    return c


def run(name, trace=False, seconds=0.3):
    return cell.run_cell(tiny(name), 2**31 + 977, seconds, trace, device="cpu")


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    out = run(name)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] > 0
    assert set(out) == {"correct", "attempted", "failed", "metrics", "device", "compared"}
    assert list(out)[-1] == "compared"
    e2e = {m["name"] for m in DOC["end_to_end"] if manifest.applies(m, name)}
    assert set(out["metrics"]) == e2e
    assert all(c["value"] == 0 == c["limit"] for c in out["compared"].values())


@pytest.mark.parametrize("name", CELLS)
def test_traced_run_reports_host_layers(name):
    out = run(name, trace=True)
    assert out["correct"]
    names = set(out["metrics"])
    layer = {m["name"] for m in DOC["per_layer"] if manifest.applies(m, name)}
    assert names <= layer
    # on the CPU no device metric is read
    host = {m["name"] for m in DOC["per_layer"]
            if manifest.applies(m, name) and m["source"] != "device_trace"}
    assert names == host


def alter_output(monkeypatch, kernel):
    """The kernel's output changed where it is produced: every element off
    by one, so every answer that passes through it is wrong."""
    from repro_torch.kernels import ops

    real = getattr(ops, kernel)

    def altered(*args, **kw):
        out = real(*args, **kw)
        first = out[-1] if isinstance(out, tuple) else out
        first += 1
        return out

    monkeypatch.setattr(ops, kernel, altered)


@pytest.mark.parametrize("name", CELLS)
def test_altered_answer_is_not_correct(name, monkeypatch):
    w = next(w for w in DOC["workloads"] if w["name"] == name)
    kernel = "fullzip_gather" if "vector" in w["config"] else "miniblock_decode"
    alter_output(monkeypatch, kernel)
    out = run(name)
    assert not out["correct"] and out["compared"]["wrong_values"]["value"] > 0


@pytest.mark.parametrize("name", CELLS)
def test_half_the_batch_left_out_is_not_correct(name, monkeypatch):
    from repro_torch.dataset.reader import DatasetReader

    real_take, real_scan = DatasetReader.take, DatasetReader.scan

    def half_take(self, column, rows):
        return real_take(self, column, np.asarray(rows)[: len(rows) // 2])

    def half_scan(self, column, **kw):
        out = real_scan(self, column, **kw)
        return out.take(np.arange(len(out.validity) // 2))

    monkeypatch.setattr(DatasetReader, "take", half_take)
    monkeypatch.setattr(DatasetReader, "scan", half_scan)
    out = run(name)
    assert not out["correct"] and out["compared"]["missing_rows"]["value"] > 0


@pytest.mark.parametrize("name", CELLS)
def test_the_cells_control_is_not_correct(name):
    c = tiny(name)
    mix = c.traffic["kind"]
    order = control.run_control(c, 5, 0.2, controls.CONTROLS[mix][1])
    assert not order["correct"] and order["compared"]["wrong_values"] > 0
    precision = control.run_control(c, 5, 0.2, "precision")
    if c.config["type"]["dtype"] == "float32":  # bfloat16 loses bits
        assert not precision["correct"]
    else:  # every TPC-H date fits int16: the narrower decode is exact here
        assert precision["correct"]


def test_fallback_to_the_host_counts_as_failed(monkeypatch):
    from repro_torch.kernels import ops

    real = ops.miniblock_decode

    def noting(*args, **kw):
        ops.note_fallback("miniblock", "test")
        return real(*args, **kw)

    monkeypatch.setattr(ops, "miniblock_decode", noting)
    out = run("shipdate.take256")
    assert out["failed"] == out["attempted"] > 0


def command(cwd, *extra):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run([sys.executable, "bench/run.py", "--workload", CELLS[0],
                           "--seed", str(2**31 + 5), "--seconds", "1", "--trace", "0", *extra],
                          cwd=cwd, capture_output=True, text=True, timeout=300, env=env)


def no_result(p):
    lines = p.stdout.strip().splitlines()
    return not lines or '"correct"' not in lines[-1]


def test_run_without_a_card_fails_and_prints_no_result():
    p = command(manifest.ROOT)
    assert p.returncode != 0 and no_result(p)
    assert "CUDA device" in p.stderr


def test_run_from_the_benchmark_files_alone_fails(tmp_path):
    shutil.copy(manifest.MANIFEST, tmp_path / "BENCHMARK.json")
    shutil.copytree(manifest.BENCH, tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = command(tmp_path)
    assert p.returncode != 0 and no_result(p)


def test_jax_in_the_process_is_found():
    assert cell.forbidden_modules(["numpy", "jax.numpy", "repro_torch.core"]) == ["jax"]
    assert cell.forbidden_modules(["repro.core.file", "flax"]) == ["flax", "repro"]
    assert cell.forbidden_modules(["repro_torch", "reprox", "jaxtyping"]) == []


def test_result_line_is_json():
    out = run(CELLS[0])
    assert json.loads(json.dumps(out)) == out

