"""Dispatching wrappers around the fused DP clip kernels (port of
``repro/kernels/dp_clip/ops.py``).

Dispatch (:mod:`repro_torch.kernels.common`): a CPU tensor takes the
plain version in :mod:`.ref`; a CUDA tensor launches the Triton kernels
of :mod:`.dp_clip` (two launches: norms, then clipped mean + noise) or
raises.  Nothing is padded: the kernels mask ragged rows and tiles.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.common import uses_kernel
from repro_torch.kernels.dp_clip import dp_clip
from repro_torch.kernels.dp_clip.ref import (
    clip_scales, cohort_scale_mean_ref, dp_clip_mean_noise_cohort_ref,
    norm_stats, stddev_tensor)


def _check_inputs(g, noise_stddev, z):
    if g.dim() != 3:
        raise ValueError(f"g must be (K, B, D): {tuple(g.shape)}")
    if g.dtype != torch.float32:
        raise ValueError(f"g must be float32: {g.dtype}")
    if not g.is_contiguous():
        raise ValueError("g must be contiguous")
    k, b, d = g.shape
    if z is not None:
        if tuple(z.shape) != (k, d) or z.dtype != torch.float32:
            raise ValueError(
                f"z must be float32 of shape {(k, d)}: "
                f"{tuple(z.shape)} {z.dtype}")
        if z.device != g.device:
            raise ValueError(f"z lies on {z.device}, g on {g.device}")
        if noise_stddev is None:
            raise ValueError("z needs noise_stddev")
    return k, b, d


def dp_clip_mean_noise_cohort(g: torch.Tensor, clip_norm: float,
                              noise_stddev=None, z=None):
    """g: (K, B, D) stacked per-example grads of a whole cohort ->
    ``(means (K, D), mean_norms (K,), clip_fractions (K,))``.

    With ``z`` ((K, D) standard-normal draws), ``noise_stddev`` (a float
    or a one-element f32 tensor on g's device — the runtime sigma*C/B)
    scales it: ``means[m] += stddev * z[m]``."""
    k, b, d = _check_inputs(g, noise_stddev, z)
    if not uses_kernel(g):
        return dp_clip_mean_noise_cohort_ref(g, clip_norm, noise_stddev, z)
    flat = g.view(k * b, d)
    norms = torch.sqrt(dp_clip.sqnorms(flat))
    std = stddev_tensor(noise_stddev, g.device) if z is not None else None
    means = dp_clip.cohort_scale_mean(
        flat, clip_scales(norms, clip_norm), k=k, inv_b=1.0 / b,
        z=None if z is None else z.contiguous(), stddev=std)
    return (means,) + norm_stats(norms.view(k, b), clip_norm)


def dp_clip_mean_flat(flat: torch.Tensor, clip_norm: float):
    """flat: (B, D) -> (mean_clipped (D,), mean_norm, clip_fraction):
    the single-member (K=1) view of the cohort op."""
    means, nrms, fracs = dp_clip_mean_noise_cohort(flat[None], clip_norm)
    return means[0], nrms[0], fracs[0]


def scale_mean(flat: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Single-member clipped batch mean (port of ``dp_clip.scale_mean``):
    (B, D) rows, (B,) scales -> (D,)."""
    b = flat.shape[0]
    if not uses_kernel(flat):
        return cohort_scale_mean_ref(flat, scales, k=1, inv_b=1.0 / b)[0]
    return dp_clip.cohort_scale_mean(flat, scales, k=1, inv_b=1.0 / b)[0]
