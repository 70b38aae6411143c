"""The benchmark stands apart: nothing under ``perfbench/`` imports JAX or
the JAX package (top-level names compared whole, since ``repro_torch``
begins with ``repro``), the references import nothing of the program,
and a run refuses to print a result without the card, without the
program, or with JAX loaded."""

import ast
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from perfbench import run

ROOT = Path(__file__).resolve().parents[2]
PB = ROOT / "perfbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                    "import_module", "__import__") and node.args \
                and isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


def _sources():
    return sorted(p for p in PB.rglob("*.py") if "__pycache__" not in p.parts)


def test_top_level_names_compared_whole():
    assert "repro_torch".split(".")[0] not in FORBIDDEN
    assert "repro.models".split(".")[0] in FORBIDDEN


@pytest.mark.parametrize("path", _sources(), ids=lambda p: p.relative_to(
    ROOT).as_posix())
def test_no_jax_import(path):
    assert not set(_imports(path)) & FORBIDDEN


def test_sources_cover_run_metrics_and_references():
    names = {p.relative_to(PB).as_posix() for p in _sources()}
    assert "run.py" in names
    assert any(n.startswith("metrics/") for n in names)
    assert {"reference/dense.py", "reference/moe.py"} <= names


@pytest.mark.parametrize("path", sorted((PB / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_references_import_nothing_of_the_program(path):
    found = set(_imports(path))
    assert "repro_torch" not in found
    assert found <= {"__future__", "math", "typing", "torch", "perfbench"}
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.ImportFrom) and node.module and \
                node.module.startswith("perfbench"):
            assert node.module.startswith("perfbench.reference")


def test_forbidden_modules_reads_sys_modules(monkeypatch):
    # other test files of this process may have loaded JAX already
    before = set(run.forbidden_modules())
    monkeypatch.setitem(sys.modules, "repro", object())
    monkeypatch.setitem(sys.modules, "repro.models", object())
    monkeypatch.setitem(sys.modules, "repro_torch_extra", object())
    assert set(run.forbidden_modules()) == before | {"repro"}
    assert "repro_torch_extra" not in run.forbidden_modules()


def _cli(cwd: Path, *extra):
    return subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         "qwen2-0.5b.reason-batch", "--seed", "2147483659", "--seconds",
         "1", "--trace", "0", *extra], cwd=cwd, capture_output=True,
        text=True, timeout=300, env={"PATH": "/usr/bin:/bin",
                                     "CUDA_VISIBLE_DEVICES": ""})


def test_no_card_no_result():
    out = _cli(ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_benchmark_alone_no_result(tmp_path):
    """In a directory that holds only BENCHMARK.json and the files under
    ``paths``, a run fails and prints no result."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(PB, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _cli(tmp_path)
    assert out.returncode != 0
    assert "repro_torch" in out.stderr
    assert out.stdout.strip() == ""
    for line in out.stdout.splitlines():
        with pytest.raises(json.JSONDecodeError):
            json.loads(line)
