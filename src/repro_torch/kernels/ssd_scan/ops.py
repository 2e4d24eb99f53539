"""Dispatching wrapper of the SSD intra-chunk block (port of
``repro/kernels/ssd_scan/ops.py``).

Dispatch (:mod:`repro_torch.kernels.common`): a CPU tensor takes the
plain version in :mod:`.ref`; a CUDA tensor launches the CUDA kernel of
:mod:`.ssd_scan` or raises.  Both routes return xr's dtype.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.common import uses_kernel
from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.kernels.ssd_scan.ref import ssd_intra_chunk_ref


def ssd_intra_chunk(xr, ar, Br, Cr) -> torch.Tensor:
    """xr: (b,c,q,h,p); ar: (b,h,c,q) f32; Br/Cr: (b,c,q,n) -> (b,c,q,h,p)."""
    ssd_scan.check_inputs(xr, ar, Br, Cr)
    if not uses_kernel(xr):
        return ssd_intra_chunk_ref(xr, ar, Br, Cr).to(xr.dtype)
    return ssd_scan.ssd_intra_chunk(xr, ar, Br, Cr)
