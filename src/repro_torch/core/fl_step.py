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
As the JAX models wrap their layers in ``jax.checkpoint``, the port's
families rematerialize their training forwards (``models.layers.remat``:
each layer, segment or period, and each loss chunk), so each Mamba2
layer launches ``ssd_intra_chunk`` twice per microbatch: in the forward
and in the backward's recompute.

Noise: ``jax.random`` streams cannot be replayed by ``torch.Generator``.
Each client draws from its own generator, leaf by leaf in the flat
(sorted-key) order of :mod:`repro_torch.pytree`, one draw per leaf per
local step; the client-level noise is one draw per leaf of the stacked
(G, ...) delta from a further generator.  Both functions below also take
a callable noise source in place of the generator, so the parity tests
inject the reference's ``jax.random.normal`` draws and hold a DP-on round
to it draw for draw.

On a mesh (``client_shardings`` / ``master_shardings``, trees of
:class:`repro_torch.launch.shardings.NamedSharding` from
``tree_shardings``, on a :func:`repro_torch.launch.mesh.make_host_mesh`
mesh over the process group's W ranks) each rank runs G / W of the
clients, as the reference's stacked client dim is split over the data
axes:

  * the master and the server optimizer's state are ZeRO-sharded as
    ``master_shardings`` says (``leaf_spec(role="master")``: one d_model
    dim split over the data axis, or the leaf replicated): each rank
    holds its shards (:func:`shard_master`), the round all-gathers the
    compute-dtype master for its clients, reduce-scatters the weighted
    delta sum onto the shards (all-reduces the replicated leaves) and
    updates each shard;
  * client c's noise comes from its own generator or the injected source
    on whichever rank it runs, and the client-level noise of the stacked
    (G, ...) delta is drawn whole and each rank takes its clients' rows,
    so the draws are the one-process round's;
  * ``delta_norm`` and ``weight_sum`` are global, equal on every rank.

On a mesh whose model axis M is above 1 (every family of the zoo) the
ranks of one data coordinate form a model group that
runs the same clients together, tensor-parallel
(:mod:`repro_torch.models.layers`; the caller installs its mesh context):

  * the master and the optimizer state are 2-D blocks: the leaf's model
    dim (``leaf_spec``'s ``"model"``) over the model group, its ZeRO
    d_model dim over the data group; the broadcast all-gathers over the
    data group only, so each client replica holds the model group's
    blocks, and the delta sum is reduce-scattered over the data group on
    each rank's model block;
  * the clip norms (per microbatch, or per client at client level) cover
    the whole client gradient: the blocks' squares are added over the
    model group, a replicated leaf counted once;
  * every noise leaf is drawn whole from the client's generator or the
    injected source and cut to this rank's block, so the draws are the
    one-process round's;
  * ``delta_norm`` adds each leaf's blocks over the axes that cut it;
  * under ``attn_shard="heads_padded"`` a head count the axis does not
    divide is cut in GSPMD's padded blocks (``shardings.block``): the
    layers narrow a block to its real heads before any use and the noise
    is cut with zeros there, so the padded slots of the master, the
    gradient, the noise, the clip norms and the update are exactly zero,
    round after round; :func:`gather_master` drops them.

With client shardings of ``role="client_all_axes"`` (the reference's
``--client-placement dp``: the stacked client dim split over the data
axes and the model axis together) each rank of the mesh runs its own
clients, G a multiple of all the mesh's ranks, client c on the rank at
position c // (G / ranks) in (data, model) order:

  * the compute-dtype master is gathered whole on every rank, over the
    data axes and the model axis (:func:`gather_master`);
  * the local phase runs each client's model whole on its rank: no model
    group, and the layers' mesh context is set aside for it (the
    reference's ``attn_axis="none"``);
  * the weighted delta sum over every rank is left on the master's
    blocks (reduce-scattered over the data group, then over the model
    group on the leaves the model axis cuts, all-reduced there on the
    others), and ``delta_norm`` adds each leaf's blocks once.

Without a process group (W = 1) the shardings change nothing.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from repro_torch.core.dp import DPConfig
from repro_torch.launch import collectives as coll
from repro_torch.launch.mesh import num_client_groups, require_runnable
from repro_torch.launch.shardings import (
    block, client_all_axes, data_dim, model_dim, pad_to, real_range, slots)
from repro_torch.models import layers as L
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


def draw_leaf(noise, step: int, leaf: int, shape, device) -> torch.Tensor:
    """Standard-normal f32 draws of ``shape`` for (``step``, ``leaf``):
    from a ``torch.Generator``, or from a callable source
    ``noise(step, leaf, shape)`` (the parity tests hand in the JAX
    package's draws this way; the cohort step's executors take the same
    sources, ``engine/cohort_step.py::draw_noise``)."""
    if isinstance(noise, torch.Generator):
        return torch.randn(tuple(shape), generator=noise,
                           dtype=torch.float32, device=noise.device)
    z = torch.as_tensor(noise(step, leaf, tuple(shape)),
                        dtype=torch.float32, device=device)
    if tuple(z.shape) != tuple(shape):
        raise ValueError(f"noise source gave shape {tuple(z.shape)} for "
                         f"step {step} leaf {leaf}, expected {tuple(shape)}")
    return z


@dataclass(frozen=True)
class ModelAxis:
    """A client's model cut over the model group (``size`` ranks, this
    one ``rank``): ``dims[j]`` is the dim of leaf j cut into blocks
    (None: the leaf is whole on every rank), equal ones or, for a head
    count the axis does not divide (``heads_padded``), GSPMD's padded
    ones; ``shapes[j]`` is leaf j's whole shape."""

    group: object
    rank: int
    size: int
    dims: tuple
    shapes: tuple

    def cut(self, j: int, z: torch.Tensor, lead: int = 0) -> torch.Tensor:
        """This rank's block of a whole leaf-``j``-shaped ``z`` (after
        ``lead`` stacked dims): its real slots, then zeros to the block's
        size, so no draw lands on a padded slot."""
        d = self.dims[j]
        if d is None:
            return z
        n = z.shape[lead + d]
        lo, hi = real_range(n, self.size, self.rank)
        return pad_to(z.narrow(lead + d, lo, hi - lo), lead + d,
                      slots(n, self.size))

    def sq_norm(self, sqs) -> torch.Tensor:
        """The whole model's squared norm from its leaves' (this rank's
        blocks') squared norms: the cut leaves' sum added over the
        group, the whole leaves' once."""
        zero = torch.zeros((), dtype=sqs[0].dtype, device=sqs[0].device)
        cut = sum((q for q, d in zip(sqs, self.dims) if d is not None), zero)
        rest = sum((q for q, d in zip(sqs, self.dims) if d is None), zero)
        return coll.all_reduce_sum(cut, self.group) + rest


def _sq_norm(leaves, model):
    sqs = [torch.sum(torch.square(l.float())) for l in leaves]
    return sum(sqs) if model is None else model.sq_norm(sqs)


def _clip_f32(grads, clip_norm: float, model=None):
    """Eq. (4) on one microbatch gradient, as the JAX package computes it:
    the global norm in f32, and the scaled gradient promoted to f32 (with
    ``model``, the norm of the whole gradient across the blocks)."""
    nrm = torch.sqrt(_sq_norm(tree_leaves(grads), model))
    scale = 1.0 / torch.clamp(nrm / clip_norm, min=1.0)
    return tree_map(lambda g: g.float() * scale, grads)


def make_local_phase(loss_fn: Callable, fl: FLStepConfig,
                     model: "ModelAxis | None" = None):
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
    params untouched and draws nothing.  ``model``: the client's params
    are this rank's blocks on the model axis (module docstring).
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
                g = (_clip_f32(g, dp.clip_norm, model) if per_micro
                     else tree_map(lambda l: l.float(), g))
                acc = g if acc is None else tree_map(torch.add, acc, g)
            mean_g = tree_map(lambda a: a / n_micro, acc)
            if per_micro and dp.noise_multiplier > 0:
                stddev = dp.noise_multiplier * dp.clip_norm / n_micro
                mean_g = tree_unflatten_like(mean_g, [
                    g + stddev * _draw_block(key, i, j, g.shape, g.device,
                                             model)
                    for j, g in enumerate(tree_leaves(mean_g))])
            params = tree_map(
                lambda p, g: (p.float() - fl.local_lr * g).to(p.dtype),
                params, mean_g)
        return params

    return local_phase


def _draw_block(noise, step: int, j: int, shape, device, model, lead=()):
    """:func:`draw_leaf` for leaf ``j``, whose block on this rank has
    ``shape`` (after the stacked dims ``lead``): drawn whole, then cut to
    the block, so the draws are the one-process round's."""
    if model is None:
        return draw_leaf(noise, step, j, tuple(lead) + tuple(shape), device)
    return model.cut(j, draw_leaf(noise, step, j, tuple(lead)
                                  + tuple(model.shapes[j]), device),
                     len(lead))


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


def _sharding_leaves(shardings):
    return [] if shardings is None else tree_leaves(shardings)


def master_dims(master_shardings) -> "list | None":
    """Per master leaf, the dim its sharding splits over the data axis
    (None: replicated); None without shardings."""
    if master_shardings is None:
        return None
    return [data_dim(s) for s in tree_leaves(master_shardings)]


def master_model_dims(master_shardings) -> "list | None":
    """Per master leaf, the dim its sharding cuts over the model axis
    (None: whole on every rank of a model group)."""
    if master_shardings is None:
        return None
    return [model_dim(s) for s in tree_leaves(master_shardings)]


def shard_master(tree, master_shardings):
    """This rank's blocks of a whole master-shaped tree (the params, or
    any tree shaped like them): no communication."""
    if master_shardings is None:
        return tree
    mesh = tree_leaves(master_shardings)[0].mesh
    return tree_unflatten_like(tree, [
        block(l, s, mesh.rank, mesh.model_rank).contiguous()
        for l, s in zip(tree_leaves(tree), tree_leaves(master_shardings))])


def gather_master(tree, master_shardings):
    """Whole leaves from this rank's blocks (all-gathers over the data and
    the model axis on a mesh with a process group, padded blocks narrowed
    to the whole leaf; every rank must call it)."""
    if master_shardings is None:
        return tree
    shs = tree_leaves(master_shardings)
    mesh = shs[0].mesh
    if mesh.group is None:
        return tree
    tree = coll.all_gather_tree(tree, master_dims(master_shardings),
                                mesh.group)
    if mesh.shape["model"] > 1:
        dims = master_model_dims(master_shardings)
        tree = coll.all_gather_tree(tree, dims, mesh.model_group)
        tree = tree_unflatten_like(tree, [
            l if d is None else l.narrow(d, 0, s.shape[d])
            for l, d, s in zip(tree_leaves(tree), dims, shs)])
    return tree


def _round_mesh(fl: FLStepConfig, client_shardings, master_shardings):
    """(mesh of the shardings (None without), checked runnable; whether
    the clients span every axis) and the client split: every client leaf
    split on its leading dim, G a multiple of the data-axis product, or
    with ``role="client_all_axes"`` shardings of all the mesh's ranks."""
    shs = (_sharding_leaves(client_shardings)
           + _sharding_leaves(master_shardings))
    if not shs:
        return None, False
    mesh = shs[0].mesh
    if any(s.mesh != mesh for s in shs):
        raise ValueError("client and master shardings lie on different "
                         "meshes")
    require_runnable(mesh)
    clients = _sharding_leaves(client_shardings)
    for s in clients:
        if data_dim(s) != 0:
            raise ValueError(
                f"client sharding {s.spec} does not split the leading "
                "client dim over the data axis")
    spans = {client_all_axes(s) for s in clients}
    if len(spans) > 1:
        raise ValueError("some client shardings span the model axis and "
                         "some do not")
    all_axes = spans == {True}
    w = mesh.size if all_axes else num_client_groups(mesh)
    if fl.num_clients % w:
        what = ("all the mesh's ranks" if all_axes
                else "the data-axis product")
        raise ValueError(
            f"num_clients G={fl.num_clients} is not a multiple of "
            f"{what} {w}: the clients cannot split over it")
    master_dims(master_shardings)       # validates the master specs
    return mesh, all_axes


def _sum_blocks(sq, split, group):
    """Per leaf, the squared norm summed over ``group`` where ``split``
    (the leaf is cut on that axis), else as it is."""
    part = coll.all_reduce_sum(torch.stack([
        q if s else torch.zeros_like(q) for q, s in zip(sq, split)]), group)
    return [part[j] if s else q for j, (q, s) in enumerate(zip(sq, split))]


def make_fl_train_step(loss_fn: Callable, fl: FLStepConfig,
                       client_shardings=None, master_shardings=None):
    """``loss_fn(params, batch) -> scalar mean loss``, where every tensor
    in ``batch`` has a leading per-client batch dim.

    Returns ``fl_train_step(master, opt_state, batch, weights, key) ->
    (new_master, new_opt_state, metrics)``:

      master:    f32 param tree (on a mesh: this rank's shards, from
                 :func:`shard_master`; the optimizer state likewise)
      batch:     global batch; leading dim = G * per_client_batch
      weights:   (G,) aggregation weights (uniform p_k = FedAvg Eq. 9;
                 staleness alpha/(1+tau) = FedAsync Eq. 10)
      key:       the round's noise: an int seed, or a callable source
                 ``key(client, step, leaf, shape)`` (client G is the
                 client-level delta noise, drawn at step 0 with the
                 stacked (G, ...) shape)
      metrics:   ``{"delta_norm", "weight_sum"}``

    ``client_shardings`` / ``master_shardings``: the round on a mesh
    (module docstring); on a model axis above 1 the step raises unless
    the layers' mesh context of that mesh is installed
    (``models.layers.set_mesh_context``).
    """
    G = fl.num_clients
    mesh, all_axes = _round_mesh(fl, client_shardings, master_shardings)
    group = mesh.group if mesh is not None else None
    dims = master_dims(master_shardings)
    # the model axis: the local phase's (tensor parallelism inside each
    # client), or with the clients over every axis only the master's
    # blocks, which the delta sum and its norm cover
    blocks = model = None
    if group is not None and mesh.shape["model"] > 1:
        blocks = ModelAxis(mesh.model_group, mesh.model_rank,
                           mesh.shape["model"],
                           tuple(master_model_dims(master_shardings)),
                           tuple(s.shape for s in
                                 tree_leaves(master_shardings)))
        model = None if all_axes else blocks
    if group is None:
        w, r = 1, 0
    elif all_axes:
        w = mesh.size
        r = mesh.rank * mesh.shape["model"] + mesh.model_rank
    else:
        w, r = num_client_groups(mesh), mesh.rank
    mine = range(r * G // w, (r + 1) * G // w)
    server_opt = make_server_optimizer(fl)
    cdtype = getattr(torch, fl.compute_dtype)
    local_phase = make_local_phase(loss_fn, fl, model)
    dp = fl.dp

    def fl_train_step(master, opt_state, batch, weights, key):
        device = tree_leaves(master)[0].device
        if model is not None and L.model_group() is not model.group:
            raise ValueError(
                "the round on a model axis needs the layers' mesh context: "
                "models.layers.set_mesh_context(mesh, cfg=cfg)")
        master_c = tree_map(lambda m: m.to(cdtype), master)
        leaf_dims = dims or [None] * len(tree_leaves(master))
        if all_axes:
            # the broadcast: each client whole on its rank
            master_c = gather_master(master_c, master_shardings)
        elif group is not None:
            # the broadcast: the compute-dtype shards all-gathered over the
            # data axis (each rank keeps its model blocks)
            master_c = coll.all_gather_tree(master_c, leaf_dims, group)
        cbatch = tree_map(
            lambda x: split_batch(x, G, fl.n_local, fl.n_micro), batch)
        sources = client_noise(key, G, device)
        deltas = []
        with L.no_mesh_context() if all_axes else contextlib.nullcontext():
            for g in mine:
                new = local_phase(master_c, tree_map(lambda x: x[g], cbatch),
                                  sources[g])
                deltas.append(tree_map(lambda n, s: n.float() - s.float(),
                                       new, master_c))
                del new
        del master_c
        if dp.granularity == "client_level":
            # per-client global norms across ALL leaves, then one noise
            # draw per leaf of the stacked (G, ...) delta, this rank's
            # clients' rows of it
            norms = torch.sqrt(torch.stack([
                _sq_norm(tree_leaves(d), model) for d in deltas]))
            scales = 1.0 / torch.clamp(norms / dp.clip_norm, min=1.0)
            deltas = [tree_map(lambda l, s=scales[i]: l * s, d)
                      for i, d in enumerate(deltas)]
            if dp.noise_multiplier > 0:
                stddev = dp.noise_multiplier * dp.clip_norm
                zs = [_draw_block(sources[G], 0, j, l.shape, device, model,
                                  (G,))
                      for j, l in enumerate(tree_leaves(deltas[0]))]
                deltas = [tree_unflatten_like(d, [
                    l + stddev * z[g] for l, z in zip(tree_leaves(d), zs)])
                    for g, d in zip(mine, deltas)]
                del zs
        # weighted aggregation over the clients (paper Eq. 9 / 10-11)
        weights = torch.as_tensor(weights, device=device)
        wsum = torch.sum(weights)
        wn = (weights / wsum).to(torch.float32)
        # in place over the deltas (the same products and sums, one f32
        # copy of the model fewer)
        agg = tree_map(lambda l: l.mul_(wn[mine[0]]), deltas[0])
        for g, d in zip(mine[1:], deltas[1:]):
            tree_map(lambda a, l, w_=wn[g]: a.add_(w_ * l), agg, d)
        del deltas
        if group is not None:
            # the sum over ranks, left on the master's shards
            agg = coll.reduce_scatter_tree(agg, leaf_dims, group)
        if all_axes and blocks is not None:
            # ... and over the model group, left on the model blocks (a
            # head count the axis does not divide padded to its blocks)
            agg = tree_unflatten_like(agg, [
                l if d is None else pad_to(l, d, blocks.size * slots(
                    l.shape[d], blocks.size))
                for l, d in zip(tree_leaves(agg), blocks.dims)])
            agg = coll.reduce_scatter_tree(agg, list(blocks.dims),
                                           blocks.group)
        # server update: FedAdam treats -Delta as the gradient
        neg = tree_map(torch.neg, agg)
        new_master, new_opt_state = server_opt.update(neg, opt_state, master)
        sq = [torch.sum(torch.square(l)) for l in tree_leaves(agg)]
        if group is not None:
            # each leaf's sum over the blocks of the axes that cut it; a
            # leaf whole on an axis counts once there
            sq = _sum_blocks(sq, [d is not None for d in leaf_dims], group)
        if blocks is not None:
            sq = _sum_blocks(sq, [d is not None for d in blocks.dims],
                             blocks.group)
        metrics = {"delta_norm": torch.sqrt(sum(sq)), "weight_sum": wsum}
        return new_master, new_opt_state, metrics

    return fl_train_step
