"""The cohort step (port of ``repro/engine/cohort_step.py``, arena path):
every cohort member's whole local round plus the fused weighted merge.

The cohort assembles on the device from persistent arenas: all clients'
params / optimizer state live in stacked (A, ...) tensors (a slot per
client), every client's dataset was uploaded once, and
a cohort is gathered by ``index_select`` over a (K,) slot vector with its
minibatches gathered from the resident data by the (K, S_max, B) int32
plan.  The new optimizer state is scattered back into its slots in place
(the runner owns the arena; the reference copies it, being pure).
Slots may repeat only if they carry identical rows (the reference's pad
members); the port's runner never pads.

Two executors:

* **step-major fused** (``dp_path="pallas"`` with DP on) — all K members
  advance one local step together: per-example grads of the K members
  (``vmap`` over members of ``vmap(grad)`` over examples), ONE
  ``dp_clip`` call over the stacked (K, B, D) matrix (two Triton launches
  on the card), batched Adam, then the ``live = step < n_steps`` mask.
  Like the reference's step-major loop (cohort_step.py:468) every padded
  step launches, masked ones included.
* **member-major** (``use_dp=False`` or ``dp_path="jnp"``) — a Python
  loop over members and their own step counts, one ``dp_mean_gradient``
  (per-leaf path) or plain mean-loss gradient per step.

Noise: member k draws its ``z`` (length D, flat leaf order) once per local
step from its own generator, seeded from its dispatch seed, so the noise
depends only on (dispatch seed, local step) and never on how members
were grouped into cohorts.  The noise scale is a runtime one-element
tensor: one built step serves a whole sigma sweep.

The step returns ``(upload, arena_opt, screen)``: uploads pass through
the clean-scale ``_corrupt_members`` epilogue and ``_screen_members``
computes each member's finite verdict and update-delta norm, as the
reference's step always does (faults and screening themselves come with
a later slice, so the scale is always 1.0 here).
"""
from __future__ import annotations

from dataclasses import replace
from typing import Callable

import torch
from torch.func import grad, vmap

from repro_torch.core.dp import (
    DPConfig, dp_mean_gradient, per_example_grads, validate_dp_path)
from repro_torch.pytree import (
    tree_flatten_to_vector, tree_leaves, tree_map, tree_size,
    tree_unflatten_from_vector)

# make_cohort_step invocations since process start (the reference's
# cache-miss counter; a warm sigma sweep must not grow it per point)
_STEP_BUILDS = 0


def step_builds() -> int:
    return _STEP_BUILDS


def _bcast(v, leaf):
    return v.reshape(v.shape + (1,) * (leaf.dim() - v.dim()))


def _tree_where_members(live, new, old):
    """Per-member select over stacked (K, ...) trees: ``live`` is (K,)."""
    return tree_map(lambda n, o: torch.where(_bcast(live, n), n, o), new, old)


def _corrupt_members(ref, new, scale):
    """Member k's delivered params become ``p0 + scale[k] * (p - p0)``;
    ``scale[k] == 1.0`` is the clean sentinel and selects ``p`` verbatim."""
    def leaf(p0, p):
        s = _bcast(scale.to(torch.float32), p)
        clean = _bcast(scale == 1.0, p)
        p0f, pf = p0.float(), p.float()
        return torch.where(clean, pf, p0f + s * (pf - p0f)).to(p.dtype)

    return tree_map(leaf, ref, new)


def _screen_members(ref, new):
    """Per-member ``(finite, norm)`` of the update delta: f32 L2 norm over
    all leaves, accumulated in leaf order."""
    sq = None
    for p0, p in zip(tree_leaves(ref), tree_leaves(new)):
        d = p.float() - p0.float()
        part = torch.sum(d * d, dim=tuple(range(1, d.dim())))    # (K,)
        sq = part if sq is None else sq + part
    norm = torch.sqrt(sq)
    return torch.isfinite(norm), norm


def take_rows(tree, idx):
    """Gather rows ``idx`` (int64 device tensor) of every stacked leaf."""
    return tree_map(lambda l: l.index_select(0, idx), tree)


def put_rows_(tree, idx, rows):
    """In-place scatter of stacked ``rows`` into the rows ``idx``."""
    tree_map(lambda a, r: a.index_copy_(0, idx, r.to(a.dtype)), tree, rows)
    return tree


def _member(tree, i):
    return tree_map(lambda l: l[i], tree)


def _stack(trees):
    return tree_map(lambda *ls: torch.stack(ls), *trees)


def make_cohort_step(loss_fn: Callable, dp_cfg: DPConfig, opt,
                     use_dp: bool = True, dp_path: str = "jnp",
                     add_noise: bool = True):
    """Build ``(cohort_step, merge_cohort)``.

    ``cohort_step(arena_params, arena_opt, arena_data, slots, data_slots,
    batch_idx, gens, n_steps, noise_stddev, corrupt_scale)``:

      arena_params / arena_opt: stacked (A, ...) client state
      arena_data:  dict of (A_d, n_max, ...) resident datasets
      slots, data_slots: (K,) int64 device tensors
      batch_idx:   (K, S_max, B) int64 device tensor
      gens:        K device ``torch.Generator``s (member noise streams)
      n_steps:     (K,) host int array of real local steps per member
      noise_stddev: one-element f32 device tensor (runtime sigma*C/B)
      corrupt_scale: (K,) f32 device tensor (1.0 = clean)

    ``dp_cfg.noise_multiplier`` is ignored (the runtime stddev carries
    it); ``add_noise=False`` is the statically noise-free variant for
    sigma == 0 runs (clipping still applies).

    ``merge_cohort(global_params, stacked_uploads, coeffs, g_coeff)``
    computes ``g_coeff * g + sum_i coeffs[i] * upload_i`` with
    zero-coefficient members masked out before the reduction, so a
    nonfinite masked payload cannot poison it (0 * NaN = NaN).
    """
    global _STEP_BUILDS
    _STEP_BUILDS += 1
    dp_cfg = replace(dp_cfg, noise_multiplier=0.0)
    validate_dp_path(dp_path)
    fused_dp = bool(use_dp and dp_path == "pallas")

    def one_step(params, opt_state, batch, gen, noise_stddev):
        if use_dp:
            g, _aux = dp_mean_gradient(
                loss_fn, params, batch, dp_cfg, dp_path="jnp",
                noise_stddev=noise_stddev if add_noise else None,
                generator=gen)
        else:
            g = grad(lambda p: torch.mean(
                vmap(loss_fn, in_dims=(None, 0))(p, batch)))(params)
        return opt.update(g, opt_state, params)

    def run_members(stacked_params, stacked_opt, gens, batches, n_steps,
                    noise_stddev):
        """Member-major executor: member i runs its n_steps[i] steps."""
        outs_p, outs_o = [], []
        for i in range(len(gens)):
            p, o = _member(stacked_params, i), _member(stacked_opt, i)
            for s in range(int(n_steps[i])):
                batch = {k: v[i, s] for k, v in batches.items()}
                p, o = one_step(p, o, batch, gens[i], noise_stddev)
            outs_p.append(p)
            outs_o.append(o)
        return _stack(outs_p), _stack(outs_o)

    def run_members_fused(stacked_params, stacked_opt, gens, batches,
                          n_steps, noise_stddev):
        """Step-major executor: one dp_clip call per local step over the
        whole cohort's stacked (K, B, D) per-example grad matrix."""
        from repro_torch.kernels.dp_clip.ops import dp_clip_mean_noise_cohort

        template = _member(stacked_params, 0)
        d = tree_size(template)
        dev = tree_leaves(stacked_params)[0].device
        live_steps = torch.as_tensor(n_steps, dtype=torch.int32, device=dev)
        s_max = next(iter(batches.values())).shape[1]
        member_grads = vmap(lambda p, b: per_example_grads(loss_fn, p, b))
        p, o = stacked_params, stacked_opt
        for s in range(s_max):
            batch_s = {k: v[:, s] for k, v in batches.items()}
            flat = tree_flatten_to_vector(member_grads(p, batch_s), lead=2)
            if add_noise:
                z = torch.stack([
                    torch.randn(d, generator=g, dtype=torch.float32,
                                device=dev) for g in gens])
                means, _, _ = dp_clip_mean_noise_cohort(
                    flat, dp_cfg.clip_norm, noise_stddev, z)
            else:
                means, _, _ = dp_clip_mean_noise_cohort(flat, dp_cfg.clip_norm)
            grads = tree_unflatten_from_vector(means, template, lead=1)
            p_new, o_new = opt.update(grads, o, p)
            live = live_steps > s
            p = _tree_where_members(live, p_new, p)
            o = _tree_where_members(live, o_new, o)
        return p, o

    execute = run_members_fused if fused_dp else run_members

    def cohort_step(arena_params, arena_opt, arena_data, slots, data_slots,
                    batch_idx, gens, n_steps, noise_stddev, corrupt_scale):
        stacked_params = take_rows(arena_params, slots)
        stacked_opt = take_rows(arena_opt, slots)
        # in-step batch gather from the resident datasets: only the index
        # plan crossed host->device
        batches = {k: l[data_slots[:, None, None], batch_idx]
                   for k, l in arena_data.items()}
        new_params, new_opt = execute(stacked_params, stacked_opt, gens,
                                      batches, n_steps, noise_stddev)
        # write-back: the honest post-training state; corruption below
        # touches only the returned upload payload
        put_rows_(arena_opt, slots, new_opt)
        upload = _corrupt_members(stacked_params, new_params, corrupt_scale)
        screen = _screen_members(stacked_params, upload)
        return upload, arena_opt, screen

    def merge_cohort(global_params, stacked_uploads, coeffs, g_coeff):
        coeffs = coeffs.to(torch.float32)

        def leaf(g, s):
            sf = s.float()
            mask = _bcast(coeffs != 0.0, sf)
            sf = torch.where(mask, sf, torch.zeros_like(sf))
            return (g_coeff * g.float()
                    + torch.tensordot(coeffs, sf, dims=([0], [0]))
                    ).to(g.dtype)

        return tree_map(leaf, global_params, stacked_uploads)

    return cohort_step, merge_cohort
