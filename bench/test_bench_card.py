"""Every cell's own command on the card, with a short window: the result
line is the contract's and reads as correct.  Run on the card with
``PYTHONPATH=src python -m pytest -q -m cuda bench/test_bench_card.py``."""

import json
import subprocess
import sys

import pytest

from bench import manifest

DOC = manifest.load()


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", [w["name"] for w in DOC["workloads"]])
def test_cell_on_the_card(card, name, trace):
    p = subprocess.run([sys.executable, "bench/run.py", "--workload", name, "--seed",
                        str(2**31 + 31), "--seconds", "2", "--trace", str(trace)],
                       cwd=manifest.ROOT, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["failed"] == 0
    assert out["device"]["platform"] == "gpu" and out["device"]["count"] == 1
    group = DOC["per_layer"] if trace else DOC["end_to_end"]
    want = {m["name"] for m in group if manifest.applies(m, name)}
    assert set(out["metrics"]) == want
    if trace:
        assert out["device"]["busy_s"] > 0 and "breakdown" in out
        roof = [v["value"] for k, v in out["metrics"].items() if "roofline" in k]
        assert roof and all(0 < r <= 100 for r in roof)
    assert p.stderr.strip().splitlines()[-1].startswith("compared ")
