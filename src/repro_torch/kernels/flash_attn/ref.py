"""Plain PyTorch version of the flash decode kernel (transcription of
``repro/kernels/flash_attn/ref.py``): the CPU route, and the oracle
``chip_smoke.py`` holds the CUDA kernel against."""
from __future__ import annotations

import torch


def flash_decode_ref(q, k, v, pos, *, window: int = 0, softcap: float = 0.0):
    """q: (B, H, Dh); k/v: (B, S, Hkv, Dh); pos: (B,).  GQA via H % Hkv == 0.
    Returns (B, H, Dh) attention output over cache entries <= pos (and
    within the sliding window when window > 0)."""
    B, S, Hkv, Dh = k.shape
    H = q.shape[1]
    rep = H // Hkv
    kk = torch.repeat_interleave(k, rep, dim=2) if rep > 1 else k
    vv = torch.repeat_interleave(v, rep, dim=2) if rep > 1 else v
    logits = torch.matmul(q[:, :, None], kk.permute(0, 2, 3, 1))[:, :, 0]
    logits = logits.float() * (Dh ** -0.5)                   # (B, H, S)
    if softcap > 0:
        logits = torch.tanh(logits / softcap) * softcap
    idx = torch.arange(S, device=k.device)[None, None, :]
    cur = pos[:, None, None]
    eff_w = window if window > 0 else S + 1
    mask = (idx <= cur) & (idx > cur - eff_w)
    logits = torch.where(mask, logits, -1e30)
    probs = torch.softmax(logits, dim=-1)
    out = torch.matmul(probs[:, :, None], vv.float().permute(0, 2, 1, 3))
    return out[:, :, 0].to(q.dtype)
