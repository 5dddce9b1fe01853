"""Nothing of the benchmark imports JAX or the JAX package (``repro``),
compared by whole top-level module name; the reference and the generators
import nothing of the port either; nothing opens a path in the older
benchmark folder of the JAX package."""

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent
BANNED = {"jax", "jaxlib", "flax", "repro"}
OLD = "bench" + "marks"  # the JAX package's benchmark folder
# the yardstick: these import numpy, the standard library and each other
PLAIN = ["reference.py", "controls.py", "peaks.py", "datagen"]


def modules():
    return sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts)


def imported(path: Path):
    """Top-level names of every module ``path`` imports (absolute imports)."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".")[0])
    return names


@pytest.mark.parametrize("path", modules(), ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_or_reference_package(path):
    found = imported(path) & BANNED
    assert not found, f"{path.name} imports {found}"


def plain_modules():
    out = []
    for entry in PLAIN:
        p = BENCH / entry
        out += sorted(p.rglob("*.py")) if p.is_dir() else [p]
    return out


@pytest.mark.parametrize("path", plain_modules(), ids=lambda p: str(p.relative_to(BENCH)))
def test_yardstick_imports_nothing_of_the_port(path):
    found = imported(path) - {"numpy", "dataclasses", "typing", "__future__"}
    assert not found, f"{path.name} imports {found}"


@pytest.mark.parametrize("path", modules(), ids=lambda p: str(p.relative_to(BENCH)))
def test_reads_nothing_of_benchmarks_folder(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            assert OLD + "/" not in node.value and node.value != OLD, path.name
    assert OLD not in imported(path)


def test_the_scan_compares_whole_top_level_names(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import repro_torch.core\nfrom repro_torch import kernels\n")
    assert not imported(src) & BANNED
    src.write_text("import os\nfrom repro.core import file\n")
    assert imported(src) & BANNED == {"repro"}
