"""Serving on a mesh: a model's params, its caches and the batch's rows
placed on this rank (the port's counterpart of the JAX dry run's
``build_prefill`` / ``build_decode`` placement, which GSPMD executes).

On a ``(data, model)`` mesh (``launch/mesh.py``) each rank serves

* the params' blocks of ``tree_shardings(..., role="serve")`` (the leaf
  rule on the model axis, whole over the data axes);
* the batch's rows of its data coordinate when the batch divides the
  data axes (the reference's ``tok_sh`` / ``pos_sh`` rule), else every
  row;
* its blocks of the caches, 1/M of each leaf's bytes on a model axis of
  M, cut where the leaf's own compute is cut (:func:`cache_placement`).

The family functions (``prefill``, ``decode_step``) run unchanged inside
:func:`context`, which installs the layers' mesh context: every layer
reads its blocks against the config's whole shapes
(``models/layers.py``).  Where the placement differs from the reference's
``cache_shardings`` (which cuts the rightmost dim whose size is a
candidate):

==================  ================================  ======================
cache leaf          ``cache_shardings`` cuts          served on
==================  ================================  ======================
KV (self, cross)    head_dim                          the kv heads when the
                                                      axis divides them,
                                                      else head_dim
Mamba2 SSM state    the state dim N                   the SSM heads
Mamba2 conv state   the channels                      the channels
mLSTM state         the key dim                       the heads when the
                                                      axis divides them,
                                                      else the key dim
sLSTM state         its head dim (when it divides)    whole
==================  ================================  ======================

A KV block on the kv heads goes through ``flash_decode`` where it lies
(this rank's kv heads and their query heads); a KV block on head_dim is
all-gathered whole before each step's attention
(``layers.decode_attention``).  The sLSTM's recurrence runs whole on
every rank, so its small state is whole too.

    mesh = make_host_mesh(data=1, model=2)       # in every rank
    params = serve.place_params(fam.init_params(cfg, 0, dev), cfg, mesh)
    cache = serve.init_cache(cfg, B, max_len, mesh, dev)
    with serve.context(mesh, cfg, B):
        logits, cache = fam.prefill(params, serve.rows(batch, mesh, B),
                                    cfg, cache)
"""
from __future__ import annotations

import contextlib

import torch

from repro_torch.device import resolve_device
from repro_torch.launch.mesh import data_axes, num_client_groups
from repro_torch.launch.shardings import NamedSharding, block, tree_shardings
from repro_torch.pytree import (
    tree_flatten_with_path, tree_leaves, tree_map, tree_unflatten_like)

# cache leaf (its top-level key in the family's cache dict) -> (the dims
# from the end of its batch dim and of the dims it may be cut on, in
# order of preference)
_KV = (-4, (-2, -1))
_LEAVES = {
    "k": _KV, "v": _KV, "xk": _KV, "xv": _KV,            # dense, moe, vlm,
    "attn_k": _KV, "attn_v": _KV,                        # whisper, hybrid
    "seg_conv": (-3, (-1,)), "tail_conv": (-3, (-1,)),   # (B, K - 1, C)
    "seg_ssm": (-4, (-3,)), "tail_ssm": (-4, (-3,)),     # (B, H, P, N)
    "m_seg": (-4, (-3, -2)), "m_tail": (-4, (-3, -2)),   # (B, H, dk, dv + 1)
    "s_seg": (-3, ()),                                   # (B, H, dh), whole
}


def rows_split(mesh, batch_size: int) -> bool:
    """Whether the batch's rows are split over the data axes."""
    n = num_client_groups(mesh)
    return n > 1 and batch_size % n == 0


def place_params(params, cfg, mesh):
    """This rank's blocks of the whole ``params`` (no communication)."""
    shs = tree_leaves(tree_shardings(params, cfg, mesh, role="serve"))
    return tree_unflatten_like(params, [
        block(l, s, 0, mesh.model_rank).contiguous()
        for l, s in zip(tree_leaves(params), shs)])


def cache_placement(cache, cfg, mesh, batch_size: int):
    """A :class:`NamedSharding` per leaf of the whole ``cache`` (tensors or
    ``meta`` tensors): the served placement (module docstring)."""
    m = mesh.shape["model"]
    daxes = data_axes(mesh)
    d_ax = daxes if len(daxes) > 1 else daxes[0]
    split = rows_split(mesh, batch_size)
    specs = []
    for path, leaf in tree_flatten_with_path(cache):
        batch_dim, cuts = _LEAVES[path[0]]
        shape = tuple(leaf.shape)
        spec = [None] * len(shape)
        if split:
            spec[len(shape) + batch_dim] = d_ax
        dim = next((len(shape) + d for d in cuts if shape[d] % m == 0), None)
        if m > 1 and dim is not None:
            spec[dim] = "model"
        specs.append(NamedSharding(mesh, tuple(spec)))
    return tree_unflatten_like(cache, specs)


def init_cache(cfg, batch_size: int, max_len: int, mesh, device=None):
    """This rank's blocks of the family's zero cache, allocated at their
    own size (the whole cache is never made), on ``device`` (the card
    unless the caller passes another)."""
    from repro_torch.models.base import get_family
    device = resolve_device(device)
    whole = get_family(cfg.family).init_cache(cfg, batch_size, max_len,
                                              device="meta")
    shs = tree_leaves(cache_placement(whole, cfg, mesh, batch_size))
    return tree_unflatten_like(whole, [
        torch.zeros(block(l, s, mesh.rank, mesh.model_rank).shape,
                    dtype=l.dtype, device=device)
        for l, s in zip(tree_leaves(whole), shs)])


def rows(tree, mesh, batch_size: int):
    """This rank's rows (dim 0) of every tensor of a batch of
    ``batch_size`` rows: its data coordinate's block when the rows split
    over the data axes, else every row."""
    if not rows_split(mesh, batch_size):
        return tree
    c = batch_size // num_client_groups(mesh)
    return tree_map(lambda t: t.narrow(0, mesh.rank * c, c), tree)


@contextlib.contextmanager
def context(mesh, cfg, batch_size: int):
    """The layers' mesh context for serving a batch of ``batch_size`` rows
    on ``mesh`` (its rows split over the data axes where they divide)."""
    from repro_torch.models import layers as L
    L.set_mesh_context(mesh, cfg=cfg, rows=rows_split(mesh, batch_size))
    try:
        yield
    finally:
        L.clear_mesh_context()
