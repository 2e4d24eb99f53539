"""DP-SGD primitives (paper Sec. 3.2, Eq. 4-6) in PyTorch (port of
``repro/core/dp.py``).

Per-example gradients come from ``torch.func.vmap(torch.func.grad(...))``;
each is clipped to C, the clipped gradients are averaged and Gaussian
noise of stddev sigma*C/B is added to the mean (Abadi et al., as the
reference and Opacus do).

``dp_path`` keeps the reference's config strings so reference specs keep
their meaning:

  * ``"jnp"``    — the per-leaf path (norms summed over leaves, per-leaf
                   scaled means, per-leaf noise);
  * ``"pallas"`` — the fused ``repro_torch.kernels.dp_clip`` op over the
                   flattened (1, B, D) matrix (Triton kernels on the card,
                   their plain version on the CPU).

Noise: ``jax.random`` streams cannot be replayed by ``torch.Generator``,
so every noising function takes the standard-normal draws ``z`` as one
flat f32 vector in the flat leaf order of :mod:`repro_torch.pytree`, or a
``generator`` to draw them from.  Both paths add ``stddev * z``, so for
the same ``z`` they agree to float tolerance — and the parity tests inject
the reference's own draws (``repro.pytree.tree_gaussian_vector_like``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch
from torch.func import grad, vmap

from repro_torch.pytree import (
    tree_flatten_to_vector, tree_global_norm, tree_leaves, tree_map,
    tree_scale, tree_size, tree_unflatten_from_vector)


DP_PATHS = ("jnp", "pallas")


def validate_dp_path(dp_path: str) -> str:
    if dp_path not in DP_PATHS:
        raise ValueError(
            f"dp_path must be one of {DP_PATHS}, got {dp_path!r}")
    return dp_path


@dataclass(frozen=True)
class DPConfig:
    clip_norm: float = 1.0        # C  (paper: C = 1)
    noise_multiplier: float = 0.0  # sigma (paper: {0.5, 1, 1.5, 2}); 0 = off
    granularity: str = "per_example"  # per_example | per_microbatch | client_level

    @property
    def enabled(self) -> bool:
        return self.noise_multiplier > 0.0 or self.clip_norm > 0.0


def _is_zero(stddev) -> bool:
    """A CONCRETE zero stddev means no noise; a tensor always noises (the
    engine's runtime stddev), as the reference's short-circuit."""
    return isinstance(stddev, (int, float)) and stddev == 0.0


def noise_vector_like(generator: torch.Generator, tree) -> torch.Tensor:
    """Standard-normal draws for every element of ``tree``, as one flat
    f32 vector in flat leaf order, from ``generator``."""
    leaf = tree_leaves(tree)[0]
    return torch.randn(tree_size(tree), generator=generator,
                       dtype=torch.float32, device=leaf.device)


def clip_tree(grads, clip_norm: float):
    """Eq. (4): g <- g / max(1, ||g||_2 / C).  Returns (clipped, pre_norm)."""
    nrm = tree_global_norm(grads)
    scale = 1.0 / torch.clamp(nrm / clip_norm, min=1.0)
    return tree_scale(grads, scale), nrm


def noise_tree(grads, stddev, z=None, generator=None):
    """Add ``stddev * z`` leafwise (``z`` flat in leaf order, or drawn from
    ``generator``)."""
    if _is_zero(stddev):
        return grads
    if z is None:
        z = noise_vector_like(generator, grads)
    noise = tree_unflatten_from_vector(z, grads)
    return tree_map(lambda g, n: g + n * stddev, grads, noise)


def per_example_grads(loss_fn: Callable, params, batch):
    """vmap(grad) over the leading batch axis of every tensor in ``batch``
    (``loss_fn(params, example) -> scalar`` on ONE example).  Returns a
    param-shaped dict with a leading batch axis on every leaf."""
    return vmap(grad(loss_fn), in_dims=(None, 0))(params, batch)


def dp_mean_gradient(loss_fn: Callable, params, batch, cfg: DPConfig,
                     dp_path: str = "jnp", noise_stddev=None, z=None,
                     generator=None):
    """Per-example DP-SGD gradient (Eq. 4-6): clip each sample's grad to C,
    average, add N(0, (sigma*C/B)^2) to the mean.

    ``noise_stddev`` overrides the static ``sigma * C / B`` (the engine
    passes a runtime tensor).  Noise draws are ``z`` (flat, leaf order) or
    come from ``generator``.  Returns ``(noised_mean_grad, aux)`` with the
    mean pre-clip norm and the clipped fraction."""
    validate_dp_path(dp_path)
    g_per = per_example_grads(loss_fn, params, batch)
    bsz = tree_leaves(g_per)[0].shape[0]
    stddev = (cfg.noise_multiplier * cfg.clip_norm / bsz
              if noise_stddev is None else noise_stddev)
    add_noise = not _is_zero(stddev)
    if add_noise and z is None:
        z = noise_vector_like(generator, params)

    if dp_path == "pallas":
        from repro_torch.kernels.dp_clip.ops import dp_clip_mean_noise_cohort

        flat = tree_flatten_to_vector(g_per, lead=1)          # (B, D)
        if add_noise:
            mean_flat, nrm, frac = dp_clip_mean_noise_cohort(
                flat[None], cfg.clip_norm, stddev, z[None])
        else:
            mean_flat, nrm, frac = dp_clip_mean_noise_cohort(
                flat[None], cfg.clip_norm)
        noised = tree_unflatten_from_vector(mean_flat[0], params)
        return noised, {"mean_grad_norm": nrm[0], "clip_fraction": frac[0]}

    sq = sum(torch.sum(torch.square(l.float()).reshape(bsz, -1), dim=1)
             for l in tree_leaves(g_per))
    norms = torch.sqrt(sq)                                       # (B,)
    scales = 1.0 / torch.clamp(norms / cfg.clip_norm, min=1.0)  # (B,)
    mean = tree_map(
        lambda l: torch.mean(
            l * scales.reshape((bsz,) + (1,) * (l.dim() - 1)), dim=0),
        g_per)
    aux = {"mean_grad_norm": torch.mean(norms),
           "clip_fraction": torch.mean(
               (norms > cfg.clip_norm).to(torch.float32))}
    noised = noise_tree(mean, stddev, z=z) if add_noise else mean
    return noised, aux


def dp_microbatch_gradient(grads, cfg: DPConfig, num_microbatches: int):
    """Per-microbatch granularity: clip one microbatch's (already averaged)
    gradient as a unit; noise is added once after accumulation by
    :func:`dp_accumulate_noise`."""
    return clip_tree(grads, cfg.clip_norm)


def dp_accumulate_noise(summed_clipped, cfg: DPConfig, num_units: int,
                        z=None, generator=None):
    """Average ``num_units`` clipped units and add N(0, (sigma*C/num_units)^2)."""
    mean = tree_scale(summed_clipped, 1.0 / num_units)
    stddev = cfg.noise_multiplier * cfg.clip_norm / num_units
    return noise_tree(mean, stddev, z=z, generator=generator)


def dp_client_delta(delta, cfg: DPConfig, z=None, generator=None):
    """Client-level DP (DP-FedAvg): clip the round's model delta to C and
    noise it before it leaves the (virtual) device."""
    clipped, nrm = clip_tree(delta, cfg.clip_norm)
    noised = noise_tree(clipped, cfg.noise_multiplier * cfg.clip_norm,
                        z=z, generator=generator)
    return noised, nrm
