"""Launcher of the SSD intra-chunk kernels, CUDA C++ for Hopper: bf16
inputs on the tensor cores (``kernels/csrc/ssd_intra_tc.cu``), f32 inputs
on the CUDA cores (``kernels/csrc/ssd_intra.cu``).

It replaces the Pallas TPU kernel ``ssd_intra_chunk`` of
``repro/kernels/ssd_scan/ssd_scan.py``; each source's note gives its bound
on the H100 and what the design does about it.  The library is built at
the first launch (:mod:`repro_torch.kernels.build`).  The output is
allocated here with ``torch.empty``; the kernel runs on PyTorch's current
stream and allocates nothing.

The kernels are forward only.  Training differentiates them through
``ops.SSDIntraChunk``, an ``autograd.Function`` whose backward is the
plain closed form ``ref.ssd_intra_chunk_bwd_ref``: the JAX package never
differentiates its Pallas kernel (its training path takes the jnp
version), so there is no TPU backward kernel to port, and a hand-written
backward kernel is later performance work (ROADMAP.md queue 2).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import check_launchable, check_tensor

ROUTE = "cuda"
DTYPES = (torch.float32, torch.bfloat16)

# launch counter: one per kernel launch, added where the kernel launches
ssd_intra_launches = 0


def launches() -> int:
    return ssd_intra_launches


def reset_launches() -> None:
    global ssd_intra_launches
    ssd_intra_launches = 0


def check_inputs(xr, ar, Br, Cr):
    """Shapes, dtypes and devices of both routes -> (b, c, q, h, p, n).

    xr (b,c,q,h,p) f32 or bf16; ar (b,h,c,q) f32; Br, Cr (b,c,q,n) in
    xr's dtype, all on xr's device."""
    if xr.dim() != 5 or Br.dim() != 4:
        raise ValueError(f"xr must be (b,c,q,h,p) and Br (b,c,q,n): "
                         f"{tuple(xr.shape)} {tuple(Br.shape)}")
    b, c, q, h, p = xr.shape
    n = Br.shape[-1]
    check_tensor("xr", xr, (b, c, q, h, p), DTYPES, xr.device)
    check_tensor("ar", ar, (b, h, c, q), (torch.float32,), xr.device)
    check_tensor("Br", Br, (b, c, q, n), (xr.dtype,), xr.device)
    check_tensor("Cr", Cr, (b, c, q, n), (xr.dtype,), xr.device)
    return b, c, q, h, p, n


def ssd_intra_chunk(xr, ar, Br, Cr) -> torch.Tensor:
    """One kernel launch -> Y_diag (b,c,q,h,p) in xr's dtype."""
    global ssd_intra_launches
    b, c, q, h, p, n = check_inputs(xr, ar, Br, Cr)
    for name, t in (("xr", xr), ("ar", ar), ("Br", Br), ("Cr", Cr)):
        check_launchable(name, t)
        if type(t) is not torch.Tensor:
            # a tensor subclass (a DTensor) is no buffer to hand the kernel:
            # on the model axis each rank passes its own heads' tensors
            raise TypeError(f"ssd_intra_chunk launches on plain tensors; "
                            f"{name} is a {type(t).__name__}")
    if q % 4 or p % 4:
        raise ValueError(f"the kernel tiles 4 x 4: chunk q={q} and head "
                         f"dim p={p} must be multiples of 4")
    y = torch.empty_like(xr)
    lib = build.library()
    fn = (lib.ssd_intra_chunk_bf16 if xr.dtype == torch.bfloat16
          else lib.ssd_intra_chunk_f32)
    with torch.cuda.device(xr.device):
        err = fn(xr.data_ptr(), ar.data_ptr(), Br.data_ptr(), Cr.data_ptr(),
                 y.data_ptr(), b, c, q, h, p, n, build.stream_ptr(xr.device))
    build.check(err, "ssd_intra_chunk")
    ssd_intra_launches += 1
    return y
