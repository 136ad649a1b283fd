"""Nothing under portbench/ imports JAX or the JAX package; the reference
imports nothing of the program; a run without a card prints no result."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import run

HERE = Path(__file__).resolve().parents[1]
REPO = HERE.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "modppl_tpu"}


def imported_top_levels(path):
    """Top-level names (before the first dot) of every import in a file."""
    tree = ast.parse(path.read_text(), str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


PY_FILES = sorted(HERE.rglob("*.py"))


@pytest.mark.parametrize("path", PY_FILES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_file_imports_jax_or_the_jax_package(path):
    assert not imported_top_levels(path) & FORBIDDEN


@pytest.mark.parametrize(
    "path", sorted((HERE / "reference").glob("*.py")),
    ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    names = imported_top_levels(path)
    assert "modppl_tpu_torch" not in names
    assert names <= {"math", "numpy", "torch", "portbench"}


def test_forbidden_names_compare_whole_top_levels(monkeypatch):
    import modppl_tpu_torch  # noqa: F401  (the port passes)

    monkeypatch.setitem(sys.modules, "jaxtyping", object())
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "modppl_tpu.core", object())
    assert run.forbidden_modules() == ["modppl_tpu"]


def test_a_run_without_a_card_prints_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "spiral-bpf.16m-particles", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=REPO, capture_output=True, text=True,
        timeout=120)
    assert proc.returncode != 0
    assert proc.stdout == ""


def test_benchmark_names_only_files_under_its_paths():
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    assert bench["paths"] == ["portbench"]
    for c in bench["configs"]:
        assert c["file"].startswith("portbench/")
        assert (REPO / c["file"]).is_file()
    assert bench["command"] == ["python3", "portbench/run.py"]
