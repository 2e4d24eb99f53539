"""Plain PyTorch version of the SSD intra-chunk kernel (transcription of
``repro/kernels/ssd_scan/ref.py``): the CPU route, and the oracle
``chip_smoke.py`` holds the CUDA kernel against; and its closed-form
gradient, the backward of the CUDA route (:mod:`.ops`)."""
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


def ssd_intra_chunk_bwd_ref(xr, ar, Br, Cr, dY):
    """The vector-Jacobian product of :func:`ssd_intra_chunk_ref`:
    ``dY`` (b,c,q,h,p) -> ``(dxr, dar, dBr, dCr)``, each in its input's
    dtype, accumulated in f32.

    With S = C.B^T (rounded to the operands' dtype, as the forward rounds
    it), L = exp(segsum(a)) (0 above the diagonal) and W = S o L per head:

        dx = W^T dY,   dW = dY x^T,   dS = sum_h dW o L,
        dC = dS B,     dB = dS^T C,
        dseg = dW o W  (the exp's derivative; 0 where L is masked),
        da = reverse cumsum of (row sums - column sums of dseg),

    the last because seg[i, j] = cs[i] - cs[j] with cs = cumsum(a)."""
    from repro_torch.models.mamba2 import _segsum
    Lm = torch.exp(_segsum(ar)).permute(0, 2, 1, 3, 4)       # (b,c,h,q,k)
    S = torch.matmul(Cr, Br.transpose(-1, -2)).float()       # (b,c,q,k)
    W = S[:, :, None] * Lm                                   # (b,c,h,q,k)
    dy = dY.float().permute(0, 1, 3, 2, 4)                   # (b,c,h,q,p)
    x = xr.float().permute(0, 1, 3, 2, 4)                    # (b,c,h,k,p)
    dx = torch.matmul(W.transpose(-1, -2), dy)               # (b,c,h,k,p)
    dW = torch.matmul(dy, x.transpose(-1, -2))               # (b,c,h,q,k)
    dS = torch.sum(dW * Lm, dim=2)                           # (b,c,q,k)
    dseg = dW * W
    dcs = dseg.sum(-1) - dseg.sum(-2)                        # (b,c,h,q)
    da = torch.flip(torch.cumsum(torch.flip(dcs, (-1,)), -1), (-1,))
    dC = torch.matmul(dS, Br.float())                        # (b,c,q,n)
    dB = torch.matmul(dS.transpose(-1, -2), Cr.float())      # (b,c,k,n)
    return (dx.permute(0, 1, 3, 2, 4).to(xr.dtype),
            da.permute(0, 2, 1, 3).to(ar.dtype),
            dB.to(Br.dtype), dC.to(Cr.dtype))
