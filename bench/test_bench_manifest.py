"""``BENCHMARK.json`` keeps the benchmark's rules, and every cell finds its
configuration, mix and metric readers by name."""

import json
import re

import pytest

from bench import manifest, traffic

DOC = manifest.load()
CELLS = [w["name"] for w in DOC["workloads"]]
METRICS = DOC["end_to_end"] + DOC["per_layer"]
LINE = re.compile(r"[^\n\t]{1,200}")


def test_manifest_has_no_problems():
    assert manifest.problems(DOC) == []


def test_command_and_paths():
    assert DOC["command"] == ["python3", "bench/run.py"]
    assert DOC["paths"] == ["bench"]
    assert all(re.fullmatch(r"[A-Za-z0-9_./\-]{1,200}", p) for p in DOC["paths"])
    assert 1 <= DOC["run_seconds"] <= 51 and isinstance(DOC["run_seconds"], int)


def test_entries_have_just_their_keys():
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"},
            "end_to_end": {"name", "unit", "better", "bound", "source"},
            "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}
    for group, want in keys.items():
        for e in DOC[group]:
            assert set(e) - {"workloads"} == want, (group, e["name"])


@pytest.mark.parametrize("text", [c["why"] for c in DOC["configs"] + DOC["workloads"]]
                         + [c["source"] for c in DOC["configs"]]
                         + [m["layer"] for m in DOC["per_layer"]] + DOC["command"])
def test_one_line_texts(text):
    assert LINE.fullmatch(text)


@pytest.mark.parametrize("m", METRICS, ids=lambda m: m["name"])
def test_metric_names_and_units(m):
    assert manifest.NAME.fullmatch(m["name"]) and manifest.UNIT.fullmatch(m["unit"])
    assert manifest.reader_path(m["name"]) is not None


def test_one_layer_one_name():
    by_stem = {}
    for m in DOC["per_layer"]:
        by_stem.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_stem.values())


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves_by_name(name):
    c = manifest.cell(name, DOC)
    traffic.check(c.traffic)
    assert c.config["rows"] >= c.traffic.get("rows_per_request", 1)
    reported = {m["name"] for m in c.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2 and c.per_layer
    for m in c.per_layer:  # each per-layer metric's cells report what it moves
        assert m["moves"] in reported


@pytest.mark.parametrize("cfg", DOC["configs"], ids=lambda c: c["name"])
def test_config_files(cfg):
    with open(manifest.ROOT / cfg["file"]) as f:
        body = json.load(f)
    assert body["name"] == cfg["name"] and body["source"] == cfg["source"]
    assert body["reduced"] == cfg["reduced"]
    assert {"rows", "fragments", "type", "data", "assumed", "guarantees"} <= set(body)
    assert cfg["file"].startswith("bench/configs/")


def test_four_chip_cells_are_few():
    four = sum(w["chips"] == 4 for w in DOC["workloads"])
    assert four <= max(1, len(DOC["workloads"]) // 4)


def test_check_fits_its_time_with_24_cells():
    # 2 + 14 runs a cell, each run_seconds + 60, 2 x 90 s a cell to compile,
    # and 1,200 s spare, within 43,200 s
    runs = 2 + 14 * 24
    assert runs * (DOC["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_problems_catches_breaches():
    bad = json.loads(json.dumps(DOC))
    bad["workloads"][0]["name"] = "has space"
    bad["end_to_end"][0]["unit"] = "rows per second"
    bad["end_to_end"][0]["bound"] = 0.5
    bad["per_layer"][0]["moves"] = "nothing"
    found = " ".join(manifest.problems(bad))
    for part in ("bad name", "bad unit", "bound", "moves unknown"):
        assert part in found
