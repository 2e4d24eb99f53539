"""Plain PyTorch version of the fused DP clip kernels (the CPU route and
the oracle ``chip_smoke.py`` holds the Triton kernels against).

Mirrors ``repro/kernels/dp_clip/ref.py`` extended to the cohort op of
``repro/kernels/dp_clip/ops.py``: per-row norms, clip scales
``1 / max(1, ||g_i|| / C)``, per-member clipped mean, optional
``stddev * z`` noise.
"""
from __future__ import annotations

import torch


def sqnorms_ref(flat: torch.Tensor) -> torch.Tensor:
    """(R, D) -> (R,) per-row squared L2 norms (f32)."""
    return torch.sum(flat * flat, dim=1)


def cohort_scale_mean_ref(flat, scales, *, k: int, inv_b: float,
                          z=None, stddev=None) -> torch.Tensor:
    """(K*B, D) member-major rows, (K*B,) scales -> (K, D) clipped means,
    plus ``stddev * z`` when ``z`` ((K, D)) is given (``stddev`` a
    one-element tensor)."""
    r, d = flat.shape
    b = r // k
    out = (flat.view(k, b, d) * scales.view(k, b, 1)).sum(dim=1) * inv_b
    if z is not None:
        out = out + stddev.reshape(()) * z
    return out


def clip_scales(norms: torch.Tensor, clip_norm: float) -> torch.Tensor:
    """Eq. 4 per-sample scale 1 / max(1, ||g|| / C)."""
    return 1.0 / torch.clamp(norms / clip_norm, min=1.0)


def norm_stats(norms: torch.Tensor, clip_norm: float):
    """(K, B) norms -> (mean pre-clip norm (K,), clip fraction (K,))."""
    return (norms.mean(dim=1),
            (norms > clip_norm).to(torch.float32).mean(dim=1))


def stddev_tensor(noise_stddev, device) -> torch.Tensor:
    """The runtime noise scale as a one-element f32 tensor on ``device``."""
    if isinstance(noise_stddev, torch.Tensor):
        if noise_stddev.numel() != 1 or noise_stddev.dtype != torch.float32:
            raise ValueError(
                "noise_stddev must be a one-element float32 tensor: "
                f"{tuple(noise_stddev.shape)} {noise_stddev.dtype}")
        if noise_stddev.device != torch.device(device):
            raise ValueError(
                f"noise_stddev lies on {noise_stddev.device}, "
                f"expected {device}")
        return noise_stddev.reshape(1)
    return torch.tensor([float(noise_stddev)], dtype=torch.float32,
                        device=device)


def dp_clip_mean_noise_cohort_ref(g, clip_norm: float, noise_stddev=None,
                                  z=None):
    """g: (K, B, D) -> (means (K, D), mean_norms (K,), clip_fractions (K,))."""
    k, b, d = g.shape
    flat = g.reshape(k * b, d)
    norms = torch.sqrt(sqnorms_ref(flat))
    std = stddev_tensor(noise_stddev, g.device) if z is not None else None
    means = cohort_scale_mean_ref(flat, clip_scales(norms, clip_norm), k=k,
                                  inv_b=1.0 / b, z=z, stddev=std)
    return (means,) + norm_stats(norms.view(k, b), clip_norm)
