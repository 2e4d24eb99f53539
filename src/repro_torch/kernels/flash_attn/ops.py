"""Dispatching wrapper of the flash decode kernel (port of
``repro/kernels/flash_attn/ops.py``).

Dispatch (:mod:`repro_torch.kernels.common`): a CPU tensor takes the
plain version in :mod:`.ref`; a CUDA tensor launches the CUDA kernel of
:mod:`.flash_attn` or raises.  The JAX wrapper's tile size ``ts`` has no
counterpart: the kernel sweeps S in 32-key tiles per warp.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.common import uses_kernel
from repro_torch.kernels.flash_attn import flash_attn
from repro_torch.kernels.flash_attn.ref import flash_decode_ref


def flash_decode(q, k, v, pos, *, window: int = 0,
                 softcap: float = 0.0) -> torch.Tensor:
    """q: (B, H, Dh); k/v: (B, S, Hkv, Dh); pos: (B,) int32 -> (B, H, Dh)."""
    flash_attn.check_inputs(q, k, v, pos)
    if not uses_kernel(q):
        return flash_decode_ref(q, k, v, pos, window=window, softcap=softcap)
    return flash_attn.flash_decode(q, k, v, pos, window=window,
                                   softcap=softcap)
