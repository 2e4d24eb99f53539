"""Plain PyTorch version of the SSD intra-chunk kernel (transcription of
``repro/kernels/ssd_scan/ref.py``): the CPU route, and the oracle
``chip_smoke.py`` holds the CUDA kernel against."""
from __future__ import annotations

import torch


def ssd_intra_chunk_ref(xr, ar, Br, Cr):
    """xr: (b,c,q,h,p); ar: (b,h,c,q) f32; Br/Cr: (b,c,q,n).
    Y_diag[b,c,q,h,p] = sum_k C_q.B_k * exp(segsum(a))[q,k] * x_k  (causal).

    As in the JAX package the scores C.B^T round to the operands' dtype
    and the rest runs in f32, so the result is f32."""
    from repro_torch.models.mamba2 import _segsum
    Lm = torch.exp(_segsum(ar))                              # (b,h,c,q,k)
    scores = torch.matmul(Cr, Br.transpose(-1, -2))          # (b,c,q,k)
    w = scores.float()[:, :, None] * Lm.permute(0, 2, 1, 3, 4)  # (b,c,h,q,k)
    y = torch.matmul(w, xr.float().permute(0, 1, 3, 2, 4))   # (b,c,h,q,p)
    return y.permute(0, 1, 3, 2, 4)
