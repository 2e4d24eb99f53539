"""Parameter / activation sharding rules, by dimension-size matching (port
of ``repro/launch/shardings.py``).

The rules are the reference's, pure shape logic.  Each leaf's spec is a
tuple with one entry per dim, equal to the entries of the reference's
``PartitionSpec``: ``None`` (replicated), ``"model"``, ``"data"``, or a
tuple of data axes.  Derived from the leaf's SHAPE against the
architecture config:

  * the last dim (searching right-to-left) whose size matches a
    "model-parallel candidate" (experts, vocab, d_ff, d_expert, d_inner,
    heads, kv-heads, head_dim) AND divides evenly by the model-axis size
    is sharded over ``model``;
  * for the f32 master params / server-optimizer state (role="master"),
    the first remaining dim matching d_model that divides by the data-axis
    product is sharded over the data axes (ZeRO-style);
  * for G-stacked per-client tensors (role="client"), the LEADING client
    dim is sharded over the data axes and d_model dims stay unsharded;
    with role="client_all_axes" (one client per rank) it is sharded over
    the data axes and the model axis together and nothing else is.

Executing a spec is the callers' job (:func:`data_dim` and
:func:`model_dim` read one): on each axis a leaf is split along at most
one dim into equal blocks, or replicated; :func:`block` cuts a rank's
block out of a whole leaf.  Under ``attn_shard="heads_padded"`` a head
count that the model axis does not divide is cut as GSPMD pads it:
blocks of ``c = ceil(n / M)`` slots, rank r holding the real slots
``[r*c, min((r+1)*c, n))`` (:func:`real_range`) and zeros up to ``c``,
so a rank may hold padding only (15 heads on 2 ranks: 8 + 8 slots, the
last one zero).  A ``"model"`` entry is a no-op on a model
axis of 1 (the rule names ``"model"`` wherever a candidate divides by
1).  :func:`cache_shardings` is the reference's rule for the serving
caches; ``launch/serve.py`` places the caches it serves from, and says
where that differs from this rule.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.launch.mesh import data_axes as _data_axes
from repro_torch.pytree import tree_map

# global sharding options (the reference's hillclimb knobs)
#   attn_shard: "even"         — only evenly-divisible dims are sharded
#               "heads_padded" — head-count dims are sharded FIRST, with
#                                padding when uneven (e.g. 56 -> 64)
_OPTS = {"attn_shard": "even"}


def set_sharding_options(**kw):
    _OPTS.update(kw)


def _model_candidates(cfg) -> list:
    cand = []
    if getattr(cfg, "n_experts", 0):
        cand.append(cfg.n_experts + getattr(cfg, "expert_pad", 0))
        cand.append(cfg.n_experts)
    if _OPTS["attn_shard"] == "heads_padded":
        cand += [cfg.n_heads, cfg.n_kv_heads]
    cand.append(cfg.vocab)
    if cfg.d_ff:
        cand += [cfg.d_ff, 2 * cfg.d_ff]
    if getattr(cfg, "d_expert", 0):
        cand.append(cfg.d_expert)
    # ssm / xlstm inner dims
    if getattr(cfg, "ssm_state", 0) or cfg.family in ("ssm", "hybrid"):
        di = 2 * cfg.d_model
        cand += [di, 2 * di]  # d_inner, mlstm up-proj
        if cfg.family == "hybrid":
            from repro_torch.models.mamba2 import conv_channels
            from repro_torch.models.mamba2 import d_inner as dih
            cand.append(conv_channels(cfg))
            cand.append(2 * dih(cfg) + 2 * cfg.ssm_state
                        + (dih(cfg) // cfg.ssm_head_dim))
    if cfg.family == "ssm":
        from repro_torch.models.xlstm import slstm_ff
        cand.append(slstm_ff(cfg))
    cand += [cfg.n_heads, cfg.n_kv_heads, cfg.head_dim]
    # dedupe preserving priority order
    seen, out = set(), []
    for c in cand:
        if c and c not in seen:
            seen.add(c)
            out.append(c)
    return out


def leaf_spec(shape, cfg, mesh, role: str = "master",
              skip_leading: int = 0) -> tuple:
    """The spec of one leaf of the given shape: a tuple, one entry per dim."""
    model_size = mesh.shape["model"]
    daxes = _data_axes(mesh)
    data_size = int(np.prod([mesh.shape[a] for a in daxes]))
    cand = _model_candidates(cfg)

    spec = [None] * len(shape)
    if role == "client_all_axes" and len(shape) > 0:
        # pure-DP placement: the client dim spans data AND model axes;
        # tensor dims stay replicated
        spec[0] = tuple(daxes) + ("model",)
        return tuple(spec)
    if role == "client" and len(shape) > 0:
        spec[0] = daxes if len(daxes) > 1 else daxes[0]
        skip_leading = max(skip_leading, 1)

    model_dim = None
    if _OPTS["attn_shard"] == "heads_padded":
        # candidate-priority search; head-count dims shard with padding
        # when uneven
        uneven_ok = {cfg.n_heads, cfg.n_kv_heads}
        for c in cand:
            for i in range(len(shape) - 1, skip_leading - 1, -1):
                if spec[i] is not None or shape[i] != c:
                    continue
                if shape[i] % model_size == 0 or (c in uneven_ok
                                                  and shape[i] > 1):
                    model_dim = i
                    break
            if model_dim is not None:
                break
    else:
        # baseline: right-to-left, first evenly-divisible candidate match
        for i in range(len(shape) - 1, skip_leading - 1, -1):
            if spec[i] is None and shape[i] % model_size == 0:
                for c in cand:
                    if shape[i] == c:
                        model_dim = i
                        break
                if model_dim is not None:
                    break
    if model_dim is not None:
        spec[model_dim] = "model"

    # ZeRO data dim for master-role tensors
    if role == "master":
        for i in range(skip_leading, len(shape)):
            if (spec[i] is None and shape[i] == cfg.d_model
                    and shape[i] % data_size == 0):
                spec[i] = daxes if len(daxes) > 1 else daxes[0]
                break
    return tuple(spec)


@dataclass(frozen=True)
class NamedSharding:
    """A leaf's spec on a mesh (the port's ``jax.sharding.NamedSharding``);
    ``shape``: the whole leaf's shape where the maker knew it (a padded
    block does not tell its whole size)."""

    mesh: object
    spec: tuple
    shape: "tuple | None" = None


def tree_shardings(tree, cfg, mesh, role: str = "master",
                   skip_leading: int = 0):
    """A :class:`NamedSharding` per leaf of ``tree`` (tensors, ``meta``
    tensors or anything with a ``.shape``)."""
    return tree_map(
        lambda l: NamedSharding(mesh, leaf_spec(
            tuple(l.shape), cfg, mesh, role, skip_leading),
            tuple(l.shape)), tree)


def batch_spec(mesh, extra_dims: int = 1) -> tuple:
    """Global-batch tensors: batch dim over all data axes."""
    daxes = _data_axes(mesh)
    return (daxes if len(daxes) > 1 else daxes[0],) + (None,) * extra_dims


def cache_shardings(cache_tree, cfg, mesh, batch_size: int):
    """KV/SSM caches -- the batch dim (identified by size) goes over the
    data axes when evenly divisible; one head/state/channel dim goes over
    ``model`` when even.  batch=1 (long_500k) stays replicated over data."""
    model_size = mesh.shape["model"]
    daxes = _data_axes(mesh)
    d_ax = daxes if len(daxes) > 1 else daxes[0]
    data_size = int(np.prod([mesh.shape[a] for a in daxes]))

    cand = [cfg.n_kv_heads, cfg.n_heads, cfg.head_dim]
    if cfg.family in ("ssm", "hybrid"):
        from repro_torch.models.mamba2 import (
            conv_channels, d_inner, n_heads_ssm)
        cand = [n_heads_ssm(cfg), conv_channels(cfg), d_inner(cfg),
                2 * cfg.d_model] + cand
    if cfg.family == "ssm":
        from repro_torch.models.xlstm import d_inner as xdi, mlstm_heads
        cand = [mlstm_heads(cfg), xdi(cfg) // mlstm_heads(cfg)] + cand

    def spec_for(l):
        shape = tuple(l.shape)
        spec = [None] * len(shape)
        # batch dim: prefer dim 1 (convention: [stack, B, ...]), else first
        # match; only shard when evenly divisible by the data-axis product
        batch_dim = None
        if batch_size % data_size == 0:
            if len(shape) > 1 and shape[1] == batch_size:
                batch_dim = 1
            else:
                batch_dim = next((i for i, s in enumerate(shape)
                                  if s == batch_size), None)
        if batch_dim is not None:
            spec[batch_dim] = d_ax
        # model dim: search from the right
        for i in range(len(shape) - 1,
                       (batch_dim if batch_dim is not None else 0), -1):
            if (spec[i] is None and shape[i] % model_size == 0
                    and shape[i] in cand):
                spec[i] = "model"
                break
        return NamedSharding(mesh, tuple(spec))

    return tree_map(spec_for, cache_tree)


def _axis_dim(sharding, names) -> "int | None":
    found = None
    for i, entry in enumerate(sharding.spec):
        got = entry if isinstance(entry, tuple) else (entry,)
        if any(n in names for n in got if n is not None):
            if found is not None:
                raise ValueError(f"spec {sharding.spec} splits two dims "
                                 f"over {sorted(names)}")
            found = i
    return found


def data_dim(sharding) -> "int | None":
    """The dim a :class:`NamedSharding` splits over the data axes (None:
    replicated on the data axis)."""
    return _axis_dim(sharding, set(_data_axes(sharding.mesh)))


def model_dim(sharding) -> "int | None":
    """The dim a :class:`NamedSharding` splits over the model axis (None:
    replicated on it, which a model axis of 1 always is)."""
    if sharding.mesh.shape["model"] == 1:
        return None
    return _axis_dim(sharding, {"model"})


def client_all_axes(sharding) -> bool:
    """Whether a client sharding splits its leading client dim over the
    model axis too (``role="client_all_axes"``: one client per rank)."""
    lead = sharding.spec[0] if sharding.spec else None
    return isinstance(lead, tuple) and "model" in lead


def slots(n: int, m: int) -> int:
    """The slots of a rank's block when ``n`` is cut over ``m`` ranks:
    ``ceil(n / m)`` (GSPMD's padded block; ``n / m`` when it divides)."""
    return -(-n // m)


def real_range(n: int, m: int, r: int) -> tuple:
    """(lo, hi): the real slots ``[lo, hi)`` of ``n`` that rank ``r`` of
    ``m`` holds in its padded block (``lo == hi``: padding only)."""
    c = slots(n, m)
    return min(r * c, n), min((r + 1) * c, n)


def pad_to(t, dim: int, size: int):
    """``t`` with zeros appended along ``dim`` up to ``size`` (``t`` itself
    when it is that long)."""
    extra = size - t.shape[dim]
    if extra == 0:
        return t
    return torch.cat([t, t.new_zeros(t.shape[:dim] + (extra,)
                                     + t.shape[dim + 1:])], dim)


def block(leaf, sharding, data_rank: int = 0, model_rank: int = 0):
    """The block of the whole ``leaf`` that the rank at (``data_rank``,
    ``model_rank``) holds under ``sharding`` (a view where no padding is
    needed; no communication).  A model dim that the axis does not divide
    gives GSPMD's padded block under ``heads_padded`` (the only option
    whose leaf rule cuts one); any other uneven cut raises."""
    shape = sharding.mesh.shape
    padded = _OPTS["attn_shard"] == "heads_padded"
    for dim, r, n, pad_ok in (
            (data_dim(sharding), data_rank,
             int(np.prod([shape[a] for a in _data_axes(sharding.mesh)])),
             False),
            (model_dim(sharding), model_rank, shape["model"], padded)):
        if dim is None or n == 1:
            continue
        size = leaf.shape[dim]
        if size % n and not pad_ok:
            raise ValueError(f"dim {dim} of {tuple(leaf.shape)} does not "
                             f"split evenly over {n} ranks")
        lo, hi = real_range(size, n, r)
        leaf = pad_to(leaf.narrow(dim, lo, hi - lo), dim, slots(size, n))
    return leaf
