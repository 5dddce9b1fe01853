"""The port stands alone: no module of ``src/repro_torch``, not
``chip_smoke.py`` and not the examples ``quickstart_torch.py``,
``retrieval_serve_torch.py`` and ``train_lm_torch.py`` import jax or the
JAX package, importing the port leaves jax unloaded, and its entry points
(the readers and writer, the LM's ``LMModel``/``build_model``,
``BatchedEngine``, ``launch.serve.run``, ``launch.train.train``,
``launch.mesh.make_host_mesh`` and the training example's ``run``) never
run on the CPU unasked."""

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
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "examples" / "quickstart_torch.py",
    ROOT / "examples" / "retrieval_serve_torch.py", ROOT / "examples" / "train_lm_torch.py"]


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
            "repro_torch.dataset, repro_torch.serve, repro_torch.data, repro_torch.kernels.ops, "
            "repro_torch.kernels.build, "
            "repro_torch.kernels.ref, repro_torch.configs, repro_torch.models, "
            "repro_torch.models.convert, repro_torch.launch, repro_torch.launch.serve, "
            "repro_torch.train, repro_torch.train.optimizer, repro_torch.train.train_loop, "
            "repro_torch.launch.train, repro_torch.launch.mesh; "
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


def test_lm_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    import importlib.util

    from repro_torch.configs import reduced_config
    from repro_torch.launch import mesh, serve, train
    from repro_torch.models import LMModel, build_model
    from repro_torch.serve import BatchedEngine

    spec = importlib.util.spec_from_file_location("train_lm_torch",
                                                  ROOT / "examples" / "train_lm_torch.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(example.C, "ARCHS", dict(example.C.ARCHS))  # run() registers its config
    cfg = reduced_config("smollm-360m")
    cpu_model = build_model(cfg, device="cpu")
    for make in (lambda: LMModel(cfg), lambda: build_model(cfg),
                 lambda: build_model(cfg, device="cuda"), lambda: BatchedEngine(cpu_model),
                 lambda: serve.run(docs=100), lambda: train.train("smollm-360m", steps=1),
                 lambda: train.train("smollm-360m", steps=1, device="cuda"),
                 lambda: train.main(["--steps", "1"]),
                 lambda: example.run(example.smollm_100m(), steps=1, batch=2, seq=16),
                 lambda: mesh.make_host_mesh(), lambda: mesh.make_host_mesh("cuda")):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    assert cpu_model.device == torch.device("cpu")
    assert BatchedEngine(cpu_model, device="cpu").device == torch.device("cpu")
