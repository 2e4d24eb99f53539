"""The PyTorch port stands alone: no module under ``src/repro_torch``
imports ``jax`` or anything of the JAX reference package ``repro``."""
import ast
import os
import pathlib
import subprocess
import sys

import pytest

PORT = pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch"


def _modules():
    root = PORT.parent
    out = []
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(root).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        out.append(".".join(parts))
    return out


def test_port_has_the_slice_modules():
    mods = set(_modules())
    for m in ("repro_torch.pytree", "repro_torch.core.dp",
              "repro_torch.kernels.dp_clip.dp_clip",
              "repro_torch.kernels.dp_clip.ops",
              "repro_torch.kernels.dp_clip.ref",
              "repro_torch.engine.cohort_step", "repro_torch.engine.engine",
              "repro_torch.core.testbed", "repro_torch.models.convert"):
        assert m in mods


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(PORT)))
def test_no_reference_or_jax_imports(path):
    """Static scan: no ``import jax``/``repro`` and no ``from repro...``
    anywhere in the port (module level or inside functions)."""
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (
                f"{path}: imports {name}")


def test_every_port_module_imports_with_jax_and_repro_blocked():
    code = (
        "import sys, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        f"for m in {_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "assert 'jax' not in {k for k, v in sys.modules.items() if v}\n"
        "print('ok')\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = str(PORT.parent)
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_cuda_default_raises_without_a_card(monkeypatch):
    """No silent CPU fallback: the default device is the card."""
    import torch
    from repro_torch.device import resolve_device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    assert resolve_device("cpu").type == "cpu"
