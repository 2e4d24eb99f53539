"""Device resolution and numerics policy for the port's entry points.

Entry points (``run_experiment``, ``build_testbed``, the engine loops)
take ``device=None`` meaning the card: they raise when CUDA is missing
instead of silently running on the CPU.  ``device="cpu"`` is an explicit
request (the parity tests use it).

On the card every float32 convolution and matrix product runs in full
float32 (cuDNN defaults convolutions to TF32, which keeps about three
decimal digits), and cuDNN picks deterministic algorithms so a rerun is
bit-identical — the reference's rerun guarantee.
"""
from __future__ import annotations

import torch


def configure_numerics() -> None:
    """Full-float32, deterministic cuDNN/cuBLAS settings (process-wide)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False


def numerics_flags() -> dict:
    return {
        "cudnn.allow_tf32": torch.backends.cudnn.allow_tf32,
        "cuda.matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32,
        "cudnn.deterministic": torch.backends.cudnn.deterministic,
        "cudnn.benchmark": torch.backends.cudnn.benchmark,
    }


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda`` (raises without a card); anything else is taken
    as given.  Applies :func:`configure_numerics` either way."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' to run the plain CPU path")
    configure_numerics()
    return dev
