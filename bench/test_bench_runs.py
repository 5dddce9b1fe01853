"""Whole runs of every cell on the CPU at a tiny size (the harness's look
for a card skipped, the port's kernels in their plain versions): a sound run
reads as correct; the timed path broken underneath, or a control in its
place, reads as not correct; a run the card would not run ends before its
window; and ``run.py`` refuses to run without a card.

Each configuration file gives its own CPU size under ``tiny`` (``rows``,
``fragments``), which only these tests read, so a configuration and its
cells are added with no edit here."""

import functools
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from bench import cell, control, controls, devtrace, manifest
from bench.reference import Column

DOC = manifest.load()
CELLS = [w["name"] for w in DOC["workloads"]]
SEED = 2**31 + 977


def tiny(name):
    c = manifest.cell(name, DOC)
    c.config = dict(c.config, **c.config["tiny"])
    c.traffic = dict(c.traffic, warmup_requests=2)
    return c


def run(name, trace=False, seconds=0.3):
    return cell.run_cell(tiny(name), SEED, seconds, trace, device="cpu")


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


def _noting(name, real, calls, *args, **kw):
    out = real(*args, **kw)
    calls.append(name)  # on return: a kernel that runs another inside ends last
    return out


def last_kernel(name):
    """The ``ops`` kernel that the cell's tiny run calls last before its
    answer, found by wrapping every kernel for one run (on the CPU
    ``miniblock_take`` decodes through ``miniblock_decode``; the outer call
    is the one that gives the answer)."""
    from repro_torch.kernels import ops

    calls = []
    with pytest.MonkeyPatch.context() as mp:
        for k in ops.launches:
            mp.setattr(ops, k, functools.partial(_noting, k, getattr(ops, k), calls))
        run(name)
    assert calls, f"{name}'s run called no kernel"
    return calls[-1]


@pytest.mark.parametrize("name", CELLS)
def test_altered_answer_is_not_correct(name, monkeypatch):
    alter_output(monkeypatch, last_kernel(name))
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


def lower_precision_is_exact(c, seed):
    """Whether ``controls.lower_precision`` leaves every valid value of the
    cell's column, as a run with ``seed`` makes it, bit for bit unchanged."""
    col = cell.make_column(c.config, np.random.default_rng(cell.seed_streams(seed)[0]))
    v = col.values[col.validity]
    bits = np.dtype(f"u{v.dtype.itemsize}")
    return np.array_equal(controls.lower_precision(v).view(bits), v.view(bits))


@pytest.mark.parametrize("name", CELLS)
def test_the_cells_control_is_not_correct(name):
    c = tiny(name)
    mix = c.traffic["kind"]
    order = control.run_control(c, 5, 0.2, controls.CONTROLS[mix][1])
    assert not order["correct"] and order["compared"]["wrong_values"] > 0
    precision = control.run_control(c, 5, 0.2, "precision")
    # the narrower decode reads as correct exactly where it loses nothing
    # on this column (every TPC-H date fits int16; bfloat16 drops bits)
    assert precision["correct"] == lower_precision_is_exact(c, 5)


def note_fallback_on_every_read(monkeypatch):
    """Every take and scan of the port's reader notes a fallback to the host."""
    from repro_torch.dataset.reader import DatasetReader
    from repro_torch.kernels import ops

    def noting(real):
        def read(self, *args, **kw):
            ops.note_fallback("miniblock", "test")
            return real(self, *args, **kw)
        return read

    monkeypatch.setattr(DatasetReader, "take", noting(DatasetReader.take))
    monkeypatch.setattr(DatasetReader, "scan", noting(DatasetReader.scan))


@pytest.mark.parametrize("name", CELLS)
def test_fallback_in_warm_up_ends_the_run_before_its_window(name, monkeypatch):
    note_fallback_on_every_read(monkeypatch)
    monkeypatch.setattr(cell, "drive", lambda *a, **kw: pytest.fail("the window started"))
    with pytest.raises(cell.NoDeviceRoute, match="decode.fallback.miniblock.test"):
        run(name)


def test_fallback_to_the_host_counts_as_failed(monkeypatch):
    """A fallback that first shows inside the window fails its request."""
    warm_up = cell.warm_up
    for name in CELLS:
        with monkeypatch.context() as mp:
            def then_fall_back(*args, **kw):
                warm_up(*args, **kw)
                note_fallback_on_every_read(mp)

            mp.setattr(cell, "warm_up", then_fall_back)
            out = run(name)
        assert out["failed"] == out["attempted"] > 0, name


def wide_cell(kind):
    """A cell of unsigned 64-bit values of 2**32 or more, built here and in
    no ``BENCHMARK.json``: the port's mini-block kernels read 31 bits at most."""
    mix = {"kind": kind, "loop": "closed", "rows_per_request": 64, "warmup_requests": 2,
           "check_requests": 4, "reader": {}}
    config = {"rows": 3000, "fragments": 2, "data": {"kind": "in-test"},
              "type": {"kind": "primitive", "dtype": "uint64", "nullable": True}}
    return manifest.Cell(name=f"wide64.{kind}", chips=1, config=config, traffic=mix,
                         end_to_end=[], per_layer=[], readers={})


def wide_column(config, rng):
    n = int(config["rows"])
    return Column(rng.random(n) >= 0.1, rng.integers(2**32, 2**60, n, dtype=np.uint64))


@pytest.mark.parametrize("kind", ["take", "scan"])
def test_column_the_card_cannot_read_ends_before_its_window(kind, monkeypatch):
    from repro_torch.dataset.reader import DatasetReader

    monkeypatch.setattr(cell, "make_column", wide_column)
    calls = []

    def counting(real):
        def read(self, *args, **kw):
            calls.append(1)
            return real(self, *args, **kw)
        return read

    monkeypatch.setattr(DatasetReader, kind, counting(getattr(DatasetReader, kind)))
    c = wide_cell(kind)
    with pytest.raises(cell.NoDeviceRoute, match="decode.fallback.miniblock"):
        cell.run_cell(c, SEED, 0.3, False, device="cpu")
    assert len(calls) == c.traffic["warmup_requests"]  # no window request


@pytest.mark.parametrize("busy_s", [0.0, -1.0, None])
def test_traced_window_without_device_time_is_no_result(busy_s):
    t = None if busy_s is None else devtrace.DeviceTrace(
        window_s=30.0, busy_s=busy_s, kernel_s=0.0, copy_s=0.0, device_ops=[], idle_gaps=[])
    with pytest.raises(cell.NoDeviceRoute, match="no device time"):
        cell.require_device_time(t)
    cell.require_device_time(devtrace.DeviceTrace(30.0, 0.02, 0.01, 0.01, [], []))


def test_run_reports_no_device_route(monkeypatch, capsys):
    """``run.py`` turns the error into exit code 4, one line on standard
    error and no result."""
    import torch

    from bench import run as run_py

    for var in run_py.CACHE_VARS:
        monkeypatch.setenv(var, "unset")
    monkeypatch.setattr(sys, "path", list(sys.path))
    monkeypatch.setattr(run_py, "pin_allocator", lambda: None)  # this process's allocator
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)

    def no_route(*args, **kw):
        raise cell.NoDeviceRoute("decode.fallback.miniblock.>31-bit x4 in warm-up")

    monkeypatch.setattr(cell, "run_cell", no_route)
    rc = run_py.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1"])
    out, err = capsys.readouterr()
    assert rc == 4 and '"correct"' not in out
    assert err.strip().splitlines()[-1] == (
        f"{CELLS[0]}: no device route: decode.fallback.miniblock.>31-bit x4 in warm-up")


@pytest.mark.parametrize("cfg", DOC["configs"], ids=lambda c: c["name"])
def test_every_configuration_has_a_tiny_size(cfg):
    with open(manifest.ROOT / cfg["file"]) as f:
        body = json.load(f)
    t = body["tiny"]
    assert set(t) == {"rows", "fragments"}
    assert 1 <= t["fragments"] <= t["rows"] <= body["rows"]
    for w in DOC["workloads"]:
        if w["config"] == cfg["name"]:
            assert t["rows"] >= tiny(w["name"]).traffic.get("rows_per_request", 1)


def test_no_bench_test_names_a_configuration():
    names = {c["name"] for c in DOC["configs"]}
    names |= {os.path.basename(c["file"]) for c in DOC["configs"]}
    for path in sorted(manifest.BENCH.glob("test_*.py")):
        text = path.read_text()
        assert not [n for n in names if n in text], path.name


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

