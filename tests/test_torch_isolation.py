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
              "repro_torch.core.testbed", "repro_torch.models.convert",
              "repro_torch.data.tokens", "repro_torch.models.base",
              "repro_torch.configs", "repro_torch.configs.zamba2_1_2b",
              "repro_torch.models.layers", "repro_torch.models.mamba2",
              "repro_torch.models.hybrid", "repro_torch.kernels.build",
              "repro_torch.kernels.ssd_scan.ssd_scan",
              "repro_torch.kernels.ssd_scan.ops",
              "repro_torch.kernels.ssd_scan.ref",
              "repro_torch.kernels.flash_attn.flash_attn",
              "repro_torch.kernels.flash_attn.ops",
              "repro_torch.kernels.flash_attn.ref",
              "repro_torch.core.faults", "repro_torch.core.screening",
              "repro_torch.core.server", "repro_torch.core.fl_step",
              "repro_torch.engine.statestore", "repro_torch.api.spec",
              "repro_torch.api.session", "repro_torch.analysis",
              "repro_torch.analysis.guard", "repro_torch.analysis.lint",
              "repro_torch.analysis.rules", "repro_torch.analysis.audits",
              "repro_torch.analysis.hlo",
              "repro_torch.checkpoint", "repro_torch.checkpoint.checkpoint",
              "repro_torch.engine.resilience",
              "repro_torch.models.transformer", "repro_torch.models.moe",
              "repro_torch.models.xlstm", "repro_torch.models.whisper",
              "repro_torch.models.vlm", "repro_torch.configs.gemma2_2b",
              "repro_torch.configs.phi3_vision_4_2b",
              "repro_torch.configs.ser_cnn", "repro_torch.launch",
              "repro_torch.launch.train", "repro_torch.launch.mesh",
              "repro_torch.launch.shardings",
              "repro_torch.launch.collectives",
              "repro_torch.launch.dryrun",
              "repro_torch.engine.mesh_backend"):
        assert m in mods


@pytest.mark.parametrize(
    "path", sorted(PORT.rglob("*.py")) + [PORT.parents[1] / "chip_smoke.py"]
    + sorted((PORT.parents[1] / "examples").glob("torch_*.py")),
    ids=lambda p: str(p.relative_to(PORT)) if PORT in p.parents else p.name)
def test_no_reference_or_jax_imports(path):
    """Static scan: no ``import jax``/``repro`` and no ``from repro...``
    anywhere in the port (module level or inside functions), nor in the
    scripts that drive it on the card, nor in its examples."""
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
        "sys.modules['triton'] = None\n"
        f"for m in {_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "assert 'jax' not in {k for k, v in sys.modules.items() if v}\n"
        "print('ok')\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = str(PORT.parent)
    # no nvcc either: the CUDA kernels build at first launch, not import
    env["PATH"] = os.path.dirname(sys.executable)
    env.pop("CUDA_HOME", None)
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
