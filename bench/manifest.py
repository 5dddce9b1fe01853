"""``BENCHMARK.json``: its rules, and a cell resolved by name to its files.

A cell (an entry of ``workloads``) names a configuration, found at the
configuration's ``file``, and a traffic mix, found at
``bench/traffic/<traffic>.json``.  Each metric's reader is
``bench/metrics/<name>.py``, or else ``bench/metrics/<name up to its first
dot>.py`` (so ``copy_ms.take`` and ``copy_ms.scan`` share ``copy_ms.py``),
and has ``read(record) -> float | None``.  Adding a configuration, a mix or
a metric adds files and entries; no file here changes.  A configuration's
file also gives its size in the CPU tests under ``tiny`` (``rows``,
``fragments``); a run never reads it.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
from pathlib import Path
from typing import Callable, Dict, List, Optional

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "bench"
MANIFEST = ROOT / "BENCHMARK.json"

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}
E2E_SOURCES = {"host_clock", "device_trace"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict  # the configuration file's contents
    traffic: dict  # the mix's file's contents
    end_to_end: List[dict]  # the manifest's metric entries this cell reports
    per_layer: List[dict]
    readers: Dict[str, Callable]  # metric name -> read(record)


def load(path: Path = MANIFEST) -> dict:
    with open(path) as f:
        return json.load(f)


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def reader_path(name: str) -> Optional[Path]:
    for stem in (name, name.split(".", 1)[0]):
        p = BENCH / "metrics" / f"{stem}.py"
        if p.is_file():
            return p
    return None


def load_reader(name: str) -> Callable:
    path = reader_path(name)
    if path is None:
        raise FileNotFoundError(f"no reader for metric {name} under bench/metrics/")
    spec = importlib.util.spec_from_file_location(
        "bench.metrics._" + re.sub(r"\W", "_", name), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def traffic_path(traffic: str) -> Path:
    return BENCH / "traffic" / f"{traffic}.json"


def cell(name: str, doc: Optional[dict] = None) -> Cell:
    """The cell called ``name``, with its configuration, mix and readers."""
    doc = load() if doc is None else doc
    work = {w["name"]: w for w in doc["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = work[name]
    cfg = {c["name"]: c for c in doc["configs"]}[w["config"]]
    with open(ROOT / cfg["file"]) as f:
        config = json.load(f)
    with open(traffic_path(w["traffic"])) as f:
        traffic = json.load(f)
    e2e = [m for m in doc["end_to_end"] if applies(m, name)]
    layer = [m for m in doc["per_layer"] if applies(m, name)]
    return Cell(name=name, chips=int(w["chips"]), config=config, traffic=traffic,
                end_to_end=e2e, per_layer=layer,
                readers={m["name"]: load_reader(m["name"]) for m in e2e + layer})


def problems(doc: dict) -> List[str]:
    """What in ``doc`` breaks the benchmark's rules (empty: nothing)."""
    out = []
    if set(doc) != TOP_KEYS:
        out.append(f"top-level keys {sorted(doc)}")
    names = {}
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in doc.get(group, []):
            n = entry.get("name", "")
            if not NAME.fullmatch(n):
                out.append(f"{group}: bad name {n!r}")
            kind = "metric" if group in ("end_to_end", "per_layer") else group
            if (kind, n) in names:
                out.append(f"{group}: {n} named twice")
            names[(kind, n)] = entry
    cfgs = {c["name"] for c in doc.get("configs", [])}
    cells = {w["name"]: w for w in doc.get("workloads", [])}
    e2e = {m["name"]: m for m in doc.get("end_to_end", [])}
    for c in doc.get("configs", []):
        if not (ROOT / c["file"]).is_file():
            out.append(f"config {c['name']}: no file {c['file']}")
        if not any(w["config"] == c["name"] for w in cells.values()):
            out.append(f"config {c['name']} is in no cell")
        for k in c.get("reduced", []):
            if not NAME.fullmatch(k):
                out.append(f"config {c['name']}: bad reduced key {k!r}")
    pairs = set()
    for w in cells.values():
        if w["config"] not in cfgs:
            out.append(f"workload {w['name']}: unknown config {w['config']}")
        if not NAME.fullmatch(w["traffic"]) or not traffic_path(w["traffic"]).is_file():
            out.append(f"workload {w['name']}: no traffic file for {w['traffic']}")
        if (w["config"], w["traffic"]) in pairs:
            out.append(f"workload {w['name']}: config and traffic twice")
        pairs.add((w["config"], w["traffic"]))
        if w.get("chips") not in (1, 4):
            out.append(f"workload {w['name']}: chips must be 1 or 4")
        reported = [m for m in e2e.values() if applies(m, w["name"])]
        if "setup_s" not in {m["name"] for m in reported} or len(reported) < 2:
            out.append(f"workload {w['name']}: needs setup_s and another end-to-end metric")
        if not any(applies(m, w["name"]) for m in doc.get("per_layer", [])):
            out.append(f"workload {w['name']}: no per-layer metric")
    if "setup_s" not in e2e:
        out.append("no setup_s")
    for group, sources in (("end_to_end", E2E_SOURCES), ("per_layer", SOURCES)):
        for m in doc.get(group, []):
            if not UNIT.fullmatch(m.get("unit", "")):
                out.append(f"{m['name']}: bad unit {m.get('unit')!r}")
            if m.get("better") not in ("lower", "higher"):
                out.append(f"{m['name']}: better must be lower or higher")
            if m.get("source") not in sources:
                out.append(f"{m['name']}: source {m.get('source')!r}")
            for c in m.get("workloads", []):
                if c not in cells:
                    out.append(f"{m['name']}: unknown workload {c}")
            if reader_path(m["name"]) is None:
                out.append(f"{m['name']}: no reader under bench/metrics/")
    for m in doc.get("end_to_end", []):
        b = m.get("bound")
        if not isinstance(b, (int, float)) or not 0.01 <= b <= 0.25:
            out.append(f"{m['name']}: bound {b!r} outside [0.01, 0.25]")
    for m in doc.get("per_layer", []):
        moved = e2e.get(m.get("moves"))
        if moved is None:
            out.append(f"{m['name']}: moves unknown metric {m.get('moves')!r}")
            continue
        if not m.get("layer") or "\n" in m["layer"] or len(m["layer"]) > 200:
            out.append(f"{m['name']}: bad layer")
        for c in (m.get("workloads") or list(cells)):
            if not applies(moved, c):
                out.append(f"{m['name']}: cell {c} does not report {moved['name']}")
    return out
