"""Kernel dispatch rule (the port's counterpart of
``repro/kernels/common.py::interpret_info``).

The rule has no override and no environment switch:

* a tensor on the CPU goes to the kernel's plain PyTorch version (the
  CPU tests run it against the JAX reference);
* a CUDA tensor launches the hand-written kernel — or the wrapper raises.
  There is no fallback that silently runs the plain version on the card.

:func:`kernel_info` is the record the engine writes into
``RunLog.engine_stats["pallas_interpret"]`` (the slot name is kept so the
stats schema stays key-for-key the reference's).
"""
from __future__ import annotations

import torch


def uses_kernel(t: torch.Tensor) -> bool:
    """True when ``t`` must go through the hand-written kernel."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(
        f"no kernel or plain route for device {t.device} "
        "(expected cpu or cuda)")


def kernel_info(device: torch.device, launches: int) -> dict:
    dev = torch.device(device)
    return {"backend": dev.type,
            "kernel": "triton" if dev.type == "cuda" else "plain",
            "launches": int(launches)}
