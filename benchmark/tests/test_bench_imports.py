"""What the benchmark imports, and how a run ends where it cannot run."""

from __future__ import annotations

import ast
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import harness

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


SOURCES = sorted(HERE.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax(path):
    assert not top_level_imports(path) & set(harness.FORBIDDEN)


@pytest.mark.parametrize("path", sorted((HERE / "reference").rglob("*.py"))
                         + sorted((HERE / "data").rglob("*.py")),
                         ids=lambda p: str(p.relative_to(HERE)))
def test_reference_and_data_import_nothing_of_the_program(path):
    assert not top_level_imports(path) & {"vettore_tpu_torch", "benchmark"} - (
        {"benchmark"} if path.parent.name == "data" else set())
    assert top_level_imports(path) <= {"__future__", "math", "numpy", "torch"}


def test_forbidden_modules_compare_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "vettore_tpu_torch_like", object())
    assert "vettore_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "vettore_tpu.collection", object())
    assert "vettore_tpu" in harness.forbidden_modules()


def _run(cwd: Path):
    return subprocess.run([sys.executable, "benchmark/run.py", "--workload", "flat1m.batch512",
                           "--seed", str(2**31 + 3), "--seconds", "1", "--trace", "0"],
                          cwd=cwd, capture_output=True, text=True, timeout=300)


def test_no_card_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    p = _run(ROOT)
    assert p.returncode != 0 and p.stdout.strip() == "", p.stderr


def test_benchmark_alone_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _run(tmp_path)
    assert p.returncode != 0 and p.stdout.strip() == "", p.stderr
