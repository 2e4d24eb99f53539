"""No JAX, no JAX package, no benchmarks/ in anything the benchmark
runs; the plain references import nothing of the program."""
import ast
import pathlib
import subprocess
import sys

import pytest

from portbench.tests import _tiny

ROOT = pathlib.Path(__file__).resolve().parents[2]
PB = ROOT / "portbench"


def _run_module():
    from portbench import run
    return run


def test_forbidden_names_are_whole_top_level_names():
    run = _run_module()
    assert run.forbidden_modules(["repro_torch", "repro_torch.api",
                                  "reprox", "jaxtyping", "torch"]) == []
    assert run.forbidden_modules(["repro", "repro.core", "jax.numpy",
                                  "jaxlib", "flax.linen", "benchmarks.run",
                                  "repro_torch"]) == [
        "benchmarks.run", "flax.linen", "jax.numpy", "jaxlib", "repro",
        "repro.core"]


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted(PB.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(PB)))
def test_no_file_imports_jax_or_the_jax_package(path):
    bad = [m for m in _imports(path)
           if m.split(".")[0] in ("jax", "jaxlib", "flax", "repro",
                                  "benchmarks")]
    assert bad == []


@pytest.mark.parametrize("path", sorted((PB / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert [m for m in _imports(path)
            if m.split(".")[0] == "repro_torch"] == []


def test_reference_loads_without_the_program():
    code = ("import sys; sys.path.insert(0, %r); "
            "import portbench.reference.ser_fl;"
            " bad = [m for m in sys.modules if m.split('.')[0] in "
            "('repro_torch', 'repro', 'jax')]; print(bad); "
            "sys.exit(1 if bad else 0)" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_run_refuses_without_a_card_and_prints_no_result(tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run(
        [sys.executable, str(PB / "run.py"), "--workload",
         _tiny.FL_CELL, "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=120,
        cwd=tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_run_fails_in_a_checkout_of_the_benchmark_alone(tmp_path):
    import shutil
    shutil.copytree(PB, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         _tiny.FL_CELL, "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=120,
        cwd=tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""
