"""The cohort step (port of ``repro/engine/cohort_step.py``): every
cohort member's whole local round plus the fused weighted merge.

Two data paths (``make_cohort_step(arena=...)``):

* **arena** (the engine's default) — the cohort assembles on the device
  from persistent arenas: the resident clients' params / optimizer state
  live in stacked (A, ...) tensors (a slot per resident client), every
  distinct dataset was uploaded once, and a cohort is gathered by
  ``index_select`` over a (K,) slot vector with its minibatches gathered
  from the resident data by the (K, S_max, B) int32 plan.  The new
  optimizer state is scattered back into its slots in place (the runner
  owns the arena; the reference copies it, being pure).  Slots may
  repeat only if they carry identical rows (a mesh's pad members, which
  all gather the pad row).
* **host-fed** (``EngineConfig(device_arena=False)``) — the runner stacks
  the members' params, optimizer states and (K, S_max, B, ...) batches
  itself and the step returns the new stacked optimizer state.

The reference's four client-axis executors (``client_axis``):

* ``"unroll"`` (default) — a Python loop over members and their own step
  counts, one ``dp_mean_gradient`` (per-leaf path) or plain mean-loss
  gradient per step.
* ``"map"`` — the reference's ``lax.map`` over the member axis.  In
  PyTorch a map over members is that same Python loop, so ``"map"`` runs
  the ``"unroll"`` program and is bit-identical to it.
* ``"vmap"`` — ``torch.func.vmap`` of one member's local round over the
  member axis, every member padded to S_max steps with the
  ``live = step < n_steps`` mask (the reference's masked steps).  vmap
  refuses a generator draw inside the mapped function, so each member's
  ``z`` is drawn from its own generator before the vmap, once per live
  step, exactly as ``"unroll"`` draws it.
* ``"fl_step"`` — the production local round,
  :func:`repro_torch.core.fl_step.make_local_phase` (per-microbatch DP
  clipping, one noise draw per leaf per local step from the member's
  generator, plain ``local_lr`` SGD; the client optimizer state passes
  through untouched), member by member.  It needs an ``FLStepConfig``
  (``fl_cfg``), whose ``dp`` carries its noise.

With ``dp_path="pallas"`` and DP on, the **step-major fused** executor
overrides the member-major ones, as in the reference
(cohort_step.py:494-499): all K members advance one local step together:
per-example grads of the K members (``vmap`` over members of
``vmap(grad)`` over examples), ONE ``dp_clip`` call over the stacked
(K, B, D) matrix (two Triton launches on the card), batched Adam, then
the ``live = step < n_steps`` mask.  Like the reference's step-major loop
(cohort_step.py:468) every padded step launches, masked ones included.

Noise: member k draws its ``z`` (length D, flat leaf order) once per local
step from its own noise stream, so the noise depends only on (dispatch
seed, local step) and never on how members were grouped into cohorts.
A stream is the member's ``torch.Generator``, seeded from its dispatch
seed, or a callable source ``noise(step, leaf, shape)``, the production
round's protocol (the engine's ``CohortRunner(noise_streams=...)``, which
the parity tests use to hand in the JAX package's draws); the executors
draw through :func:`draw_noise`, ``"fl_step"`` through the production
round's own ``draw_leaf``.  The noise scale is a runtime one-element
tensor: one built step serves a whole sigma sweep.

The step returns ``(upload, arena_opt, screen)``: each member's upload is
``p0 + scale * (p - p0)`` under its runtime transit-corruption scale
(``_corrupt_members``; 1.0 is the clean sentinel and passes ``p``
through), and ``_screen_members`` computes each member's finite verdict
and update-delta norm, which the engine compares with the screening
thresholds on the host — so faults and screening never change the step.

On a mesh (``sharding``, an
:class:`~repro_torch.engine.mesh_backend.CohortSharding`) each rank
trains its K / W members of the cohort (``sharding.rows``), with the
same executor on its own rows (the step-major one launches ``dp_clip``
on its (K / W, B, D) rows), then every rank all-gathers the trained
params and optimizer state in member order; the corruption, the screen
outputs, the arena write-back and the merge then run on the whole
cohort on every rank, as in one process.  The client-state arena stays
replicated on every rank (the reference's arena replicates too whenever
its row count does not divide the mesh).  The last cohort's rows of this
rank are kept as ``cohort_step.partition`` (a tree of
:class:`~repro_torch.engine.mesh_backend.Shard`) for
:func:`~repro_torch.engine.mesh_backend.assert_cohort_partitioned`.

Built steps are cached by their training config (:func:`cached_cohort_step`,
the reference's ``_STEP_CACHE``): sigma is stripped from the key (the
noise scale is a runtime tensor), so every runner over one testbed
config — a whole sigma sweep — shares one step, and :func:`step_builds`
counts cache misses.
"""
from __future__ import annotations

import functools
import math
from dataclasses import replace
from typing import Callable

import torch
from torch.func import grad, vmap

from repro_torch.core.dp import (
    DPConfig, dp_mean_gradient, per_example_grads, validate_dp_path)
from repro_torch.core.fl_step import draw_leaf
from repro_torch.pytree import (
    tree_flatten_to_vector, tree_leaves, tree_map, tree_size,
    tree_unflatten_from_vector)

# make_cohort_step invocations since process start: the step cache's
# misses (a warm sigma sweep must not grow it per point)
_STEP_BUILDS = 0

# the reference's executor set (cohort_step.py:110)
CLIENT_AXES = ("unroll", "map", "vmap", "fl_step")


def validate_client_axis(client_axis: str) -> str:
    if client_axis not in CLIENT_AXES:
        raise ValueError(
            f"client_axis must be one of {CLIENT_AXES}: {client_axis!r}")
    return client_axis


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


def draw_noise(noise, step: int, shapes, device) -> torch.Tensor:
    """A member's standard-normal f32 draws for local step ``step``, one
    per parameter in flat leaf order (``shapes``: the leaves' shapes): all
    at once from its ``torch.Generator``, or leaf by leaf from a callable
    source ``noise(step, leaf, shape)``, the production round's protocol
    (``core/fl_step.py::draw_leaf``)."""
    if isinstance(noise, torch.Generator):
        d = sum(math.prod(s) for s in shapes)
        return torch.randn(d, generator=noise, dtype=torch.float32,
                           device=device)
    return torch.cat([draw_leaf(noise, step, j, s, device).reshape(-1)
                      for j, s in enumerate(shapes)])


def _shapes(tree) -> list:
    return [tuple(l.shape) for l in tree_leaves(tree)]


def take_rows(tree, idx):
    """Gather rows ``idx`` (int64 device tensor) of every stacked leaf."""
    return tree_map(lambda l: l.index_select(0, idx), tree)


def put_rows_(tree, idx, rows):
    """In-place scatter of stacked ``rows`` into the rows ``idx``."""
    tree_map(lambda a, r: a.index_copy_(0, idx, r.to(a.dtype)), tree, rows)
    return tree


def unstack_tree(tree, i: int):
    """Member ``i``'s slice of a stacked tree."""
    return tree_map(lambda l: l[i], tree)


def stack_trees(trees):
    """Stack identically shaped trees on a new leading axis."""
    return tree_map(lambda *ls: torch.stack(ls), *trees)


def make_cohort_step(loss_fn: Callable, dp_cfg: DPConfig, opt,
                     use_dp: bool = True, dp_path: str = "jnp",
                     add_noise: bool = True, arena: bool = True,
                     client_axis: str = "unroll", fl_cfg=None,
                     sharding=None):
    """Build ``(cohort_step, merge_cohort)``.

    With ``arena=True``: ``cohort_step(arena_params, arena_opt,
    arena_data, slots, data_slots, batch_idx, gens, n_steps, noise_stddev,
    corrupt_scale, live_steps) -> (upload, arena_opt, screen)``:

      arena_params / arena_opt: stacked (A, ...) client state
      arena_data:  dict of (A_d, n_max, ...) resident datasets
      slots, data_slots: (K,) int64 device tensors
      batch_idx:   (K, S_max, B) int64 device tensor
      gens:        K member noise streams (device ``torch.Generator``s
                   or callable sources ``noise(step, leaf, shape)``,
                   :func:`draw_noise`)
      n_steps:     (K,) host int array of real local steps per member
      noise_stddev: one-element f32 device tensor (runtime sigma*C/B)
      corrupt_scale: (K,) f32 device tensor (1.0 = clean)
      live_steps:  the same (K,) counts as an int32 device tensor (the
                   step-major executor's live mask), staged with the
                   cohort so that the step itself uploads nothing.

    With ``arena=False`` (the host-fed path): ``cohort_step(
    stacked_params, stacked_opt, batches, gens, n_steps, noise_stddev,
    corrupt_scale, live_steps) -> (upload, new_opt, screen)`` with
    ``batches`` a dict of (K, S_max, B, ...) device tensors.

    ``dp_cfg.noise_multiplier`` is ignored (the runtime stddev carries
    it); ``add_noise=False`` is the statically noise-free variant for
    sigma == 0 runs (clipping still applies).

    ``merge_cohort(global_params, stacked_uploads, coeffs, g_coeff)``
    computes ``g_coeff * g + sum_i coeffs[i] * upload_i`` with
    zero-coefficient members masked out before the reduction, so a
    nonfinite masked payload cannot poison it (0 * NaN = NaN).

    ``client_axis`` picks the executor (module docstring); ``fl_cfg`` (an
    ``FLStepConfig``) is required by ``"fl_step"`` and ignored by the
    others.  ``sharding`` (a ``CohortSharding``) splits the members over
    the mesh's ranks (module docstring).
    """
    global _STEP_BUILDS
    _STEP_BUILDS += 1
    dp_cfg = replace(dp_cfg, noise_multiplier=0.0)
    validate_client_axis(client_axis)
    validate_dp_path(dp_path)
    if client_axis == "fl_step" and fl_cfg is None:
        raise ValueError(
            "client_axis='fl_step' drives the production local round and "
            "needs an FLStepConfig (EngineConfig.fl_cfg / fl_cfg=)")
    if client_axis == "fl_step" and dp_path == "pallas":
        raise ValueError(
            "dp_path='pallas' fuses the PER-EXAMPLE clip+noise mechanism "
            "(paper Eq. 4-6); client_axis='fl_step' runs the per-microbatch "
            "production mechanism from fl_cfg.dp — use dp_path='jnp' there")
    fused_dp = bool(use_dp and dp_path == "pallas")

    def one_step(params, opt_state, batch, gen, step, noise_stddev):
        if use_dp:
            z = (draw_noise(gen, step, _shapes(params),
                            tree_leaves(params)[0].device)
                 if add_noise else None)
            g, _aux = dp_mean_gradient(
                loss_fn, params, batch, dp_cfg, dp_path="jnp",
                noise_stddev=noise_stddev if add_noise else None, z=z)
        else:
            g = grad(lambda p: torch.mean(
                vmap(loss_fn, in_dims=(None, 0))(p, batch)))(params)
        return opt.update(g, opt_state, params)

    def run_members(stacked_params, stacked_opt, gens, batches, n_steps,
                    live_steps, noise_stddev):
        """Member-major executor (``"unroll"`` and ``"map"``): member i
        runs its n_steps[i] steps."""
        outs_p, outs_o = [], []
        for i in range(len(gens)):
            p, o = unstack_tree(stacked_params, i), unstack_tree(stacked_opt, i)
            for s in range(int(n_steps[i])):
                batch = {k: v[i, s] for k, v in batches.items()}
                p, o = one_step(p, o, batch, gens[i], s, noise_stddev)
            outs_p.append(p)
            outs_o.append(o)
        return stack_trees(outs_p), stack_trees(outs_o)

    def run_members_fused(stacked_params, stacked_opt, gens, batches,
                          n_steps, live_steps, noise_stddev):
        """Step-major executor: one dp_clip call per local step over the
        whole cohort's stacked (K, B, D) per-example grad matrix."""
        from repro_torch.kernels.dp_clip.ops import dp_clip_mean_noise_cohort

        template = unstack_tree(stacked_params, 0)
        shapes = _shapes(template)
        dev = tree_leaves(stacked_params)[0].device
        s_max = next(iter(batches.values())).shape[1]
        member_grads = vmap(lambda p, b: per_example_grads(loss_fn, p, b))
        p, o = stacked_params, stacked_opt
        for s in range(s_max):
            batch_s = {k: v[:, s] for k, v in batches.items()}
            flat = tree_flatten_to_vector(member_grads(p, batch_s), lead=2)
            if add_noise:
                z = torch.stack([draw_noise(g, s, shapes, dev)
                                 for g in gens])
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

    def run_members_vmap(stacked_params, stacked_opt, gens, batches,
                         n_steps, live_steps, noise_stddev):
        """``torch.func.vmap`` of one member's masked local round; the
        members' ``z`` are drawn before it (vmap refuses generator draws),
        one per live step in step order, from each member's generator."""
        s_max = next(iter(batches.values())).shape[1]
        noisy = use_dp and add_noise
        template = unstack_tree(stacked_params, 0)
        shapes = _shapes(template)
        d = tree_size(template) if noisy else 0
        dev = tree_leaves(stacked_params)[0].device
        z = torch.zeros((len(gens), s_max, d), dtype=torch.float32,
                        device=dev)
        for i, gen in enumerate(gens if noisy else ()):
            for s in range(int(n_steps[i])):
                z[i, s] = draw_noise(gen, s, shapes, dev)

        def member(p, o, member_batches, live_n, member_z):
            for s in range(s_max):
                batch = {k: v[s] for k, v in member_batches.items()}
                if use_dp:
                    g, _aux = dp_mean_gradient(
                        loss_fn, p, batch, dp_cfg, dp_path="jnp",
                        noise_stddev=noise_stddev if noisy else None,
                        z=member_z[s] if noisy else None)
                else:
                    g = grad(lambda q: torch.mean(
                        vmap(loss_fn, in_dims=(None, 0))(q, batch)))(p)
                p_new, o_new = opt.update(g, o, p)
                live = live_n > s
                p = tree_map(lambda n, q: torch.where(live, n, q), p_new, p)
                o = tree_map(lambda n, q: torch.where(live, n, q), o_new, o)
            return p, o

        return vmap(member)(stacked_params, stacked_opt, batches,
                            live_steps, z)

    if client_axis == "fl_step":
        from repro_torch.core.fl_step import make_local_phase

        def batch_mean_loss(p, mb):
            # the engine's loss is per-example; the production local phase
            # takes a batch-mean loss
            return torch.mean(vmap(loss_fn, in_dims=(None, 0))(p, mb))

        fl_local = make_local_phase(batch_mean_loss, fl_cfg)

        def to_micro(l):
            s, b = l.shape[0], l.shape[1]
            if b % fl_cfg.n_micro:
                raise ValueError(
                    f"cohort batch size {b} is not divisible by "
                    f"fl_cfg.n_micro={fl_cfg.n_micro}")
            return l.reshape((s, fl_cfg.n_micro, b // fl_cfg.n_micro)
                             + tuple(l.shape[2:]))

    def run_members_fl(stacked_params, stacked_opt, gens, batches, n_steps,
                       live_steps, noise_stddev):
        """The production local round, member by member; the optimizer
        state passes through untouched."""
        outs = []
        for i in range(len(gens)):
            micro = {k: to_micro(v[i]) for k, v in batches.items()}
            p = unstack_tree(stacked_params, i)
            outs.append(fl_local(p, micro, gens[i],
                                 n_steps=int(n_steps[i])))
        return stack_trees(outs), stacked_opt

    if fused_dp:
        execute = run_members_fused
    else:
        execute = {"vmap": run_members_vmap,
                   "fl_step": run_members_fl}.get(client_axis, run_members)

    def execute_rows(stacked_params, stacked_opt, gens, batches, n_steps,
                     live_steps, noise_stddev):
        """The executor over this rank's members, then every rank's
        trained members gathered in member order (without a mesh: the
        executor over the whole cohort)."""
        if sharding is None:
            return execute(stacked_params, stacked_opt, gens, batches,
                           n_steps, live_steps, noise_stddev)
        k = len(gens)
        lo, hi = sharding.rows(k)
        rows = slice(lo, hi)
        new_params, new_opt = execute(
            tree_map(lambda l: l[rows], stacked_params),
            tree_map(lambda l: l[rows], stacked_opt), gens[rows],
            {kk: v[rows] for kk, v in batches.items()}, n_steps[rows],
            live_steps[rows], noise_stddev)
        step.partition = sharding.record(new_params, k, lo)
        if not sharding.partitions(k):
            return new_params, new_opt
        return sharding.gather((new_params, new_opt))

    def cohort_step_arena(arena_params, arena_opt, arena_data, slots,
                          data_slots, batch_idx, gens, n_steps, noise_stddev,
                          corrupt_scale, live_steps):
        stacked_params = take_rows(arena_params, slots)
        stacked_opt = take_rows(arena_opt, slots)
        # in-step batch gather from the resident datasets: only the index
        # plan crossed host->device
        batches = {k: l[data_slots[:, None, None], batch_idx]
                   for k, l in arena_data.items()}
        new_params, new_opt = execute_rows(stacked_params, stacked_opt, gens,
                                           batches, n_steps, live_steps,
                                           noise_stddev)
        # write-back: the honest post-training state; corruption below
        # touches only the returned upload payload
        put_rows_(arena_opt, slots, new_opt)
        upload = _corrupt_members(stacked_params, new_params, corrupt_scale)
        screen = _screen_members(stacked_params, upload)
        return upload, arena_opt, screen

    def cohort_step_host(stacked_params, stacked_opt, batches, gens, n_steps,
                         noise_stddev, corrupt_scale, live_steps):
        new_params, new_opt = execute_rows(stacked_params, stacked_opt, gens,
                                           batches, n_steps, live_steps,
                                           noise_stddev)
        upload = _corrupt_members(stacked_params, new_params, corrupt_scale)
        screen = _screen_members(stacked_params, upload)
        return upload, new_opt, screen

    step = cohort_step_arena if arena else cohort_step_host
    step.partition = None

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

    return step, merge_cohort


# ---------------------------------------------------------------------------
# cross-run step cache: runs over the same testbed config (sweeps, parity
# tests) reuse the built step instead of building it again
# ---------------------------------------------------------------------------

_STEP_CACHE: dict = {}


def _hashable_loss(loss_fn):
    """Normalize ``functools.partial`` losses so two testbeds built from the
    same model config share one step."""
    if isinstance(loss_fn, functools.partial):
        try:
            key = (loss_fn.func, loss_fn.args,
                   tuple(sorted(loss_fn.keywords.items())))
            hash(key)
            return key
        except TypeError:
            pass
    return loss_fn


def cached_cohort_step(loss_fn, dp_cfg: DPConfig, opt, use_dp: bool = True,
                       dp_path: str = "jnp", add_noise: bool = True,
                       arena: bool = True, client_axis: str = "unroll",
                       fl_cfg=None, sharding=None):
    """Memoized :func:`make_cohort_step`, keyed as the reference keys it
    (training config, DP path, executor, ``fl_cfg``, the static noise
    on/off, the data path, the ``CohortSharding`` and so its mesh) minus
    what the port has no counterpart of (donation).
    ``dp_cfg.noise_multiplier`` is stripped from the key: the noise scale
    is a runtime argument, so every sigma of a sweep shares one entry
    (the ``"fl_step"`` executor's noise lives in ``fl_cfg``, which stays
    in the key).  The cache holds step functions only, never device
    buffers."""
    dp_cfg = replace(dp_cfg, noise_multiplier=0.0)

    def build():
        return make_cohort_step(
            loss_fn, dp_cfg, opt, use_dp=use_dp, dp_path=dp_path,
            add_noise=add_noise, arena=arena, client_axis=client_axis,
            fl_cfg=fl_cfg, sharding=sharding)

    key = (_hashable_loss(loss_fn), dp_cfg, opt, use_dp, dp_path,
           client_axis, fl_cfg, add_noise, arena, sharding)
    try:
        hash(key)
    except TypeError:
        return build()
    if key not in _STEP_CACHE:
        _STEP_CACHE[key] = build()
    return _STEP_CACHE[key]


def invalidate_step_cache(mesh=None) -> int:
    """Drop the cached steps (only those sharded over ``mesh`` when it is
    given); returns how many entries were dropped.  (The port keeps no
    compiled graph or other state behind the entries.)"""
    drop = [k for k in _STEP_CACHE
            if mesh is None or (k[-1] is not None and k[-1].mesh == mesh)]
    for k in drop:
        del _STEP_CACHE[k]
    return len(drop)
