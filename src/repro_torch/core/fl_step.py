"""The production FL round (port of ``repro/core/fl_step.py``): local
DP-SGD with per-microbatch clipping + noisy weighted aggregation, the
round ``launch/train.py spmd`` trains the architecture zoo with.

One ``fl_train_step`` = one federated round:

  1. **broadcast**: the f32 master params -> G client replicas in
     ``compute_dtype`` (the JAX package stacks them on a leading client
     dim; here the G clients run one after another on the one device, so
     no (G, ...) stack of replicas is ever held);
  2. **local phase**: each client runs ``n_local`` local SGD steps; each
     step accumulates ``n_micro`` microbatch gradients, clipping each to C
     (per-microbatch LDP granularity, paper Eq. 4), adds
     N(0, (sigma C / n_micro)^2) once (Eq. 5) and applies the local update
     (Eq. 6);
  3. **(optional) client-level DP**: the round delta is clipped + noised
     instead (DP-FedAvg granularity, Geyer et al. [17]);
  4. **aggregate**: Delta = sum_g w_g delta_g / sum_g w_g, deltas in f32;
  5. **server update**: FedAdam (or SGD) on the f32 master, with -Delta as
     the gradient.

Gradients come from ``torch.autograd.grad`` over the family's ``loss``.
The JAX models wrap their layers in ``jax.checkpoint``; the port keeps
every activation (no recomputation), so each Mamba2 layer launches
``ssd_intra_chunk`` once per microbatch forward.

Noise: ``jax.random`` streams cannot be replayed by ``torch.Generator``.
Each client draws from its own generator, leaf by leaf in the flat
(sorted-key) order of :mod:`repro_torch.pytree`, one draw per leaf per
local step; the client-level noise is one draw per leaf of the stacked
(G, ...) delta from a further generator.  Both functions below also take
a callable noise source in place of the generator, so the parity tests
inject the reference's ``jax.random.normal`` draws and hold a DP-on round
to it draw for draw.

The JAX package's ``client_shardings`` / ``master_shardings`` place the
round on a mesh; the port runs on one device and takes them only as
``None`` (the multi-device half is ROADMAP.md queue 1 item 14).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from repro_torch.core.dp import DPConfig
from repro_torch.optim.optimizers import SGD, Adam
from repro_torch.pytree import tree_leaves, tree_map, tree_unflatten_like


@dataclass(frozen=True)
class FLStepConfig:
    num_clients: int                  # G = product of data axes
    n_local: int = 1                  # local SGD steps per round
    n_micro: int = 2                  # grad-accum microbatches per local step
    local_lr: float = 0.02
    server_lr: float = 1e-3
    dp: DPConfig = DPConfig(clip_norm=1.0, noise_multiplier=1.0,
                            granularity="per_microbatch")
    server_opt: str = "adam"          # adam (FedAdam) | sgd
    compute_dtype: str = "bfloat16"


def make_server_optimizer(fl: FLStepConfig):
    if fl.server_opt == "adam":
        return Adam(lr=fl.server_lr)
    return SGD(lr=fl.server_lr)


def split_batch(x, G: int, n_local: int, n_micro: int):
    """Reshape one global-batch tensor to ``(G, n_local, n_micro,
    per_micro, ...)``: the per-client microbatch layout the local phase
    walks.  Divisibility is checked first, naming the shape and the
    config values that make it impossible."""
    b = int(x.shape[0])
    if b % G:
        raise ValueError(
            f"global batch dim {b} (leading dim of shape {tuple(x.shape)}) "
            f"is not divisible by num_clients G={G}")
    per_client = b // G
    if per_client % (n_local * n_micro):
        raise ValueError(
            f"per-client batch {per_client} (global batch {b} over G={G} "
            f"clients) is not divisible by n_local*n_micro = "
            f"{n_local}*{n_micro} = {n_local * n_micro}; use a global batch "
            f"that is a multiple of G*n_local*n_micro = "
            f"{G * n_local * n_micro}")
    per_micro = per_client // (n_local * n_micro)
    return x.reshape((G, n_local, n_micro, per_micro) + tuple(x.shape[1:]))


def loss_grad(loss_fn: Callable, params, batch):
    """``jax.grad(lambda p: loss_fn(p, batch))(params)`` by autograd: a
    tree of gradients in the params' dtypes (zeros for a leaf the loss
    does not reach)."""
    leaves = tree_leaves(params)
    with torch.enable_grad():
        live = [p.detach().requires_grad_() for p in leaves]
        loss = loss_fn(tree_unflatten_like(params, live), batch)
        grads = torch.autograd.grad(loss, live, allow_unused=True)
    return tree_unflatten_like(params, [
        torch.zeros_like(p) if g is None else g
        for p, g in zip(leaves, grads)])


def _draw(noise, step: int, leaf: int, shape, device) -> torch.Tensor:
    """Standard-normal f32 draws of ``shape`` for (``step``, ``leaf``):
    from a ``torch.Generator``, or from a callable source
    ``noise(step, leaf, shape)``."""
    if isinstance(noise, torch.Generator):
        return torch.randn(tuple(shape), generator=noise,
                           dtype=torch.float32, device=noise.device)
    return torch.as_tensor(noise(step, leaf, tuple(shape)),
                           dtype=torch.float32, device=device)


def _clip_f32(grads, clip_norm: float):
    """Eq. (4) on one microbatch gradient, as the JAX package computes it:
    the global norm in f32, and the scaled gradient promoted to f32."""
    leaves = tree_leaves(grads)
    nrm = torch.sqrt(sum(torch.sum(torch.square(l.float())) for l in leaves))
    scale = 1.0 / torch.clamp(nrm / clip_norm, min=1.0)
    return tree_map(lambda g: g.float() * scale, grads)


def make_local_phase(loss_fn: Callable, fl: FLStepConfig):
    """One client's local phase (paper Eq. 4-6): local SGD steps, each
    accumulating ``n_micro`` clipped microbatch gradients before one
    noise draw and the ``local_lr`` update.

    Factored out of :func:`make_fl_train_step` so the cohort engine can
    drive the same production round from its event loop
    (``client_axis="fl_step"``).

    Returns ``local_phase(client_params, client_batch, key, n_steps=None)``
    where ``client_batch`` leaves are ``(n_local, n_micro, per_micro,
    ...)`` (the step and microbatch counts are taken from the batch, not
    from ``fl``), ``key`` is the client's noise source (a
    ``torch.Generator``, or a callable ``key(step, leaf, shape)``), and
    ``n_steps`` optionally masks trailing steps: a masked step leaves the
    params untouched and draws nothing.
    """
    dp = fl.dp
    per_micro = dp.granularity == "per_microbatch"

    def local_phase(client_params, client_batch, key, n_steps=None):
        blead = tree_leaves(client_batch)[0]
        n_local, n_micro = int(blead.shape[0]), int(blead.shape[1])
        steps = n_local if n_steps is None else min(n_local, int(n_steps))
        params = client_params
        for i in range(steps):
            acc = None
            for m in range(n_micro):
                g = loss_grad(loss_fn, params,
                              tree_map(lambda l: l[i, m], client_batch))
                g = (_clip_f32(g, dp.clip_norm) if per_micro
                     else tree_map(lambda l: l.float(), g))
                acc = g if acc is None else tree_map(torch.add, acc, g)
            mean_g = tree_map(lambda a: a / n_micro, acc)
            if per_micro and dp.noise_multiplier > 0:
                stddev = dp.noise_multiplier * dp.clip_norm / n_micro
                mean_g = tree_unflatten_like(mean_g, [
                    g + stddev * _draw(key, i, j, g.shape, g.device)
                    for j, g in enumerate(tree_leaves(mean_g))])
            params = tree_map(
                lambda p, g: (p.float() - fl.local_lr * g).to(p.dtype),
                params, mean_g)
        return params

    return local_phase


def client_noise(key, G: int, device):
    """The G + 1 noise sources of one round (G clients, then the
    client-level delta noise) from ``key``: an int seed gives generators
    on ``device`` seeded from ``np.random.default_rng(key)``; a callable
    ``key(client, step, leaf, shape)`` is split per client."""
    if callable(key):
        return [(lambda step, leaf, shape, c=c: key(c, step, leaf, shape))
                for c in range(G + 1)]
    seeds = np.random.default_rng(int(key)).integers(0, 2 ** 62, size=G + 1)
    return [torch.Generator(device).manual_seed(int(s)) for s in seeds]


def make_fl_train_step(loss_fn: Callable, fl: FLStepConfig,
                       client_shardings=None, master_shardings=None):
    """``loss_fn(params, batch) -> scalar mean loss``, where every tensor
    in ``batch`` has a leading per-client batch dim.

    Returns ``fl_train_step(master, opt_state, batch, weights, key) ->
    (new_master, new_opt_state, metrics)``:

      master:    f32 param tree
      batch:     global batch; leading dim = G * per_client_batch
      weights:   (G,) aggregation weights (uniform p_k = FedAvg Eq. 9;
                 staleness alpha/(1+tau) = FedAsync Eq. 10)
      key:       the round's noise: an int seed, or a callable source
                 ``key(client, step, leaf, shape)`` (client G is the
                 client-level delta noise, drawn at step 0 with the
                 stacked (G, ...) shape)
      metrics:   ``{"delta_norm", "weight_sum"}``
    """
    if client_shardings is not None or master_shardings is not None:
        from repro_torch.engine.engine import not_ported
        raise not_ported("fl_step shardings (a mesh)", 14)
    G = fl.num_clients
    server_opt = make_server_optimizer(fl)
    cdtype = getattr(torch, fl.compute_dtype)
    local_phase = make_local_phase(loss_fn, fl)
    dp = fl.dp

    def fl_train_step(master, opt_state, batch, weights, key):
        device = tree_leaves(master)[0].device
        master_c = tree_map(lambda m: m.to(cdtype), master)
        cbatch = tree_map(
            lambda x: split_batch(x, G, fl.n_local, fl.n_micro), batch)
        sources = client_noise(key, G, device)
        deltas = []
        for g in range(G):
            new = local_phase(master_c, tree_map(lambda x: x[g], cbatch),
                              sources[g])
            deltas.append(tree_map(lambda n, s: n.float() - s.float(),
                                   new, master_c))
            del new
        if dp.granularity == "client_level":
            # per-client global norms across ALL leaves, then one noise
            # draw per leaf of the stacked (G, ...) delta
            norms = torch.sqrt(torch.stack([
                sum(torch.sum(torch.square(l)) for l in tree_leaves(d))
                for d in deltas]))
            scales = 1.0 / torch.clamp(norms / dp.clip_norm, min=1.0)
            deltas = [tree_map(lambda l, s=scales[g]: l * s, d)
                      for g, d in enumerate(deltas)]
            if dp.noise_multiplier > 0:
                stddev = dp.noise_multiplier * dp.clip_norm
                zs = [_draw(sources[G], 0, j, (G,) + tuple(l.shape), device)
                      for j, l in enumerate(tree_leaves(deltas[0]))]
                deltas = [tree_unflatten_like(d, [
                    l + stddev * z[g] for l, z in zip(tree_leaves(d), zs)])
                    for g, d in enumerate(deltas)]
        # weighted aggregation over the clients (paper Eq. 9 / 10-11)
        weights = torch.as_tensor(weights, device=device)
        wsum = torch.sum(weights)
        wn = (weights / wsum).to(torch.float32)
        agg = tree_map(lambda l: wn[0] * l, deltas[0])
        for g in range(1, G):
            agg = tree_map(lambda a, l, w=wn[g]: a + w * l, agg, deltas[g])
        del deltas
        # server update: FedAdam treats -Delta as the gradient
        neg = tree_map(torch.neg, agg)
        new_master, new_opt_state = server_opt.update(neg, opt_state, master)
        metrics = {
            "delta_norm": torch.sqrt(sum(
                torch.sum(torch.square(l)) for l in tree_leaves(agg))),
            "weight_sum": wsum,
        }
        return new_master, new_opt_state, metrics

    return fl_train_step
