"""The port stands alone: no module of ``src/repro_torch`` and not
``chip_smoke.py`` imports jax or the JAX package, importing the port leaves
jax unloaded, and its entry points never run on the CPU unasked."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core.file import FileReader, WriteOptions, write_table
from repro_torch.core import arrays as A
from repro_torch.dataset import DatasetReader, DatasetWriter, write_fragments
from repro_torch.kernels import ops

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif isinstance(node, ast.Call) and getattr(node.func, "id", "") == "__import__":
            for arg in node.args[:1]:
                if isinstance(arg, ast.Constant):
                    yield str(arg.value)


@pytest.mark.parametrize("path", PORT_FILES, ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_no_jax_or_reference_import(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), f"{path} imports {mod}"


def test_import_leaves_jax_out():
    code = ("import sys, repro_torch.core, repro_torch.obs, repro_torch.store, "
            "repro_torch.dataset, repro_torch.serve, repro_torch.kernels.ops, "
            "repro_torch.kernels.build, "
            "repro_torch.kernels.ref; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'repro')); "
            "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def _file():
    arr = A.PrimitiveArray.build(np.arange(100, dtype=np.int64), nullable=False)
    return write_table({"c": arr}, WriteOptions("lance-miniblock"))


def test_readers_default_to_cuda_and_raise_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fb = _file()
    for make in (lambda: FileReader(fb), lambda: FileReader(fb, device="cuda"),
                 lambda: FileReader(fb, decode="numpy"), lambda: DatasetWriter(),
                 lambda: DatasetReader(write_fragments(
                     {"c": A.PrimitiveArray.build(np.arange(10), nullable=False)}, 2))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    fr = FileReader(fb, device="cpu")
    assert fr.device == torch.device("cpu")
    with pytest.raises(ValueError):
        ops.resolve_device("meta")
