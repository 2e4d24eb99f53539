"""Dispatching wrapper of the SSD intra-chunk block (port of
``repro/kernels/ssd_scan/ops.py``).

Dispatch (:mod:`repro_torch.kernels.common`): a CPU tensor takes the
plain version in :mod:`.ref` under native autograd; a CUDA tensor
launches the CUDA kernel of :mod:`.ssd_scan` or raises.  Both routes
return xr's dtype.

The CUDA route is a ``torch.autograd.Function``: its forward is the
kernel (the same launch with grad mode on or off, so the same bits), its
backward the plain closed form :func:`.ref.ssd_intra_chunk_bwd_ref`.  The
JAX package never differentiates its Pallas kernel (``use_kernel``
defaults to False and its training path takes the jnp version), so it has
no backward kernel to port; a hand-written backward kernel is later
performance work (ROADMAP.md queue 2).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.common import uses_kernel
from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.kernels.ssd_scan.ref import (
    ssd_intra_chunk_bwd_ref, ssd_intra_chunk_ref)


class SSDIntraChunk(torch.autograd.Function):
    """The CUDA kernel forward, the plain closed-form backward."""

    @staticmethod
    def forward(xr, ar, Br, Cr):
        return ssd_scan.ssd_intra_chunk(xr, ar, Br, Cr)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)

    @staticmethod
    def backward(ctx, dY):
        return ssd_intra_chunk_bwd_ref(*ctx.saved_tensors, dY)


def ssd_intra_chunk(xr, ar, Br, Cr) -> torch.Tensor:
    """xr: (b,c,q,h,p); ar: (b,h,c,q) f32; Br/Cr: (b,c,q,n) -> (b,c,q,h,p)."""
    ssd_scan.check_inputs(xr, ar, Br, Cr)
    if not uses_kernel(xr):
        return ssd_intra_chunk_ref(xr, ar, Br, Cr).to(xr.dtype)
    return SSDIntraChunk.apply(xr, ar, Br, Cr)
