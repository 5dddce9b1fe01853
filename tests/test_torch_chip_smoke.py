"""chip_smoke.py, rehearsed on the CPU (tools/rehearse_chip_smoke.py): every
phase runs at a tiny size with the kernels' plain versions and the CUDA
measurement, streams and graphs stubbed, and the result lines keep the shape
the card's run must print.  No number here is a measurement."""

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
KEYS = {"name", "path", "step", "route", "source", "replaces", "launches", "max_abs_err",
        "ms", "graph_ms", "cold_ms", "launch_us", "plain_ms", "bound_ms", "bound_by",
        "library_ms", "library_graph_ms", "shape", "bytes", "operations", "cases",
        "mismatches"}


def test_chip_smoke_rehearses_on_the_cpu():
    run = subprocess.run([sys.executable, str(ROOT / "tools" / "rehearse_chip_smoke.py")],
                         cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-3000:]
    lines = run.stdout.strip().splitlines()
    assert json.loads(lines[-1]) == {"ok": True, "device": {
        "platform": "gpu", "kind": "CPU rehearsal", "count": 1}}
    assert "CPU rehearsal, 0 W" in lines[:-2]
    kernels = json.loads(lines[-2])["kernels"]
    for k in kernels:
        assert KEYS <= set(k), KEYS - set(k)
        # the 2**24 unpack row is off every path; every other row's path launched it
        assert (k["launches"] > 0) != (k["step"] == "2**24") and k["mismatches"] == 0
        assert k["source"] == f"src/repro_torch/kernels/csrc/{k['name']}.cu"
        assert (k["library_ms"] is None) == (k["name"] != "fullzip_gather")
    entries = {(k["name"], k["path"], k["step"]) for k in kernels}
    assert len(entries) == len(kernels)
    assert {("miniblock_decode", "take", None), ("miniblock_decode", "search", None),
            ("miniblock_decode", "tiered", None), ("fullzip_gather", "tiered", None),
            ("fullzip_gather", "take", None), ("fullzip_gather", "search", None),
            ("ivf_topk", "search", "probe"), ("bitunpack", "bitunpack", None),
            ("bitunpack", "bitunpack", "2**24")} <= entries
    assert {s for n, _, s in entries if n == "ivf_topk"} == {
        "probe", "candidates q=1", "candidates q=4", "candidates q=8"}
    phases = [json.loads(ln).get("phase") for ln in lines if ln.startswith("{")]
    for phase in ("device", "build", "kernels", "gather_streams", "take_path", "search_path",
                  "tiered", "tiered_path", "bitunpack_path", "done"):
        assert phase in phases
    records = [json.loads(ln) for ln in lines if ln.startswith('{"phase"')]
    streams = next(r for r in records if r["phase"] == "gather_streams")
    assert streams["rows_wrong"] == {"streams": 0, "graph": 0, "direct": 0}
    steps = {(r["store"], r["step"]) for r in records if r["phase"] == "tiered"}
    assert {("tiered", "take cold"), ("tiered", "take warm"), ("tiered", "scan id, cold"),
            ("hot", "take warm"), ("tiered-auto", "scan id, then takes"),
            ("tiered", "Retriever.fetch warm"),
            ("tiered", "DatasetWriter(files) ingest, write-back"),
            ("tiered", "append uncommitted, simulate_crash, scan")} <= steps
    tiered = next(r for r in records if r["phase"] == "tiered_path")
    assert tiered["launches"]["miniblock_decode"] > 0 and tiered["launches"]["fullzip_gather"] > 0
    assert tiered["fallbacks"] == {}
