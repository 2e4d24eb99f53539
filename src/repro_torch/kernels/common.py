"""Kernel dispatch rule (the port's counterpart of
``repro/kernels/common.py::interpret_info``) and the input checks every
kernel launcher shares.

The rule has no override and no environment switch:

* a tensor on the CPU goes to the kernel's plain PyTorch version (the
  CPU tests run it against the JAX reference);
* a CUDA tensor launches the hand-written kernel — or the wrapper raises.
  There is no fallback that silently runs the plain version on the card;
* a ``meta`` tensor (shapes only, as ``launch/dryrun.py`` traces a
  program) goes to the plain version too: nothing is computed on meta,
  so no kernel is stood in for, and a FLOP counter then counts the plain
  version's products, which for ``flash_decode`` and ``ssd_intra_chunk``
  are the kernels' own contractions.

:func:`kernel_info` is the record the engine writes into
``RunLog.engine_stats["pallas_interpret"]`` (the slot name is kept so the
stats schema stays key-for-key the reference's).
"""
from __future__ import annotations

import functools

import torch


def uses_kernel(t: torch.Tensor) -> bool:
    """True when ``t`` must go through the hand-written kernel."""
    if t.device.type == "cuda":
        return True
    if t.device.type in ("cpu", "meta"):
        return False
    raise ValueError(
        f"no kernel or plain route for device {t.device} "
        "(expected cpu, cuda or meta)")


def kernel_info(device: torch.device, kernel, launches: int) -> dict:
    """``kernel`` is the kernel module that ran on ``device``; its
    ``ROUTE`` ("triton" or "cuda") names the kernel on a CUDA device."""
    dev = torch.device(device)
    return {"backend": dev.type,
            "kernel": kernel.ROUTE if dev.type == "cuda" else "plain",
            "launches": int(launches)}


def check_tensor(name, t, shape, dtypes, device) -> None:
    """Shape, dtype and device of one input (both routes)."""
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name} has dtype {t.dtype}, expected one of "
                         f"{[str(d) for d in dtypes]}")
    if t.device != device:
        raise ValueError(f"{name} lies on {t.device}, expected {device}")


def check_launchable(name, t) -> None:
    """What a CUDA kernel further needs of an input: a CUDA tensor,
    contiguous, at a 16-byte aligned address."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must lie on a CUDA device: {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must start at a 16-byte aligned address")


def check_no_grad(name: str, *tensors) -> None:
    """A forward-only kernel's guard: its output is made by the kernel
    with no ``grad_fn``, so with grad mode on an input that requires a
    gradient would get a detached result in silence.  Raises instead,
    naming the kernel."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise ValueError(
            f"{name} has no backward: an input requires grad; call it "
            "under torch.no_grad() or on detached tensors")


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device) -> int:
    """Streaming multiprocessors of a CUDA device (a host-side property;
    the kernels' launch plans are sized from it)."""
    dev = torch.device(device)
    return _sm_count(torch.cuda.current_device() if dev.index is None
                     else dev.index)
