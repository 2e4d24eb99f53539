"""Param-dict utilities (port of ``repro/pytree.py``).

Params are nested dicts of tensors.  Leaves are visited in
``jax.tree_util`` order — dict keys sorted, recursively — so the flat
f32 vector (the DP kernel's D axis and the order the noise ``z`` is laid
out in) matches the reference element for element:
``conv1.b, conv1.w, conv2.b, conv2.w, fc1.b, fc1.w, gn1.bias, gn1.scale,
gn2.bias, gn2.scale, out.b, out.w``.

Every function takes an optional number of leading "stack" axes so the
same helpers serve one model and a stacked (K, ...) cohort.
"""
from __future__ import annotations

import torch


def tree_flatten_with_path(tree, prefix=()) -> list:
    """``[(path, leaf), ...]`` in ``jax.tree_util`` order, the one walker
    every flat layout here follows (the DP vector, the checkpoint keys):
    dicts by sorted key, NamedTuples (optimizer states) by field, as the
    component ``.name`` that ``jax.tree_util`` prints for a field, tuples
    and lists by index.  ``None`` is an empty subtree, as in JAX."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        items = ((k, tree[k]) for k in sorted(tree))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = ((f".{name}", v) for name, v in zip(tree._fields, tree))
    elif isinstance(tree, (tuple, list)):
        items = enumerate(tree)
    else:
        return [(prefix, tree)]
    return [pl for k, v in items
            for pl in tree_flatten_with_path(v, prefix + (k,))]


def tree_paths(tree) -> list:
    """Leaf paths (tuples of components) in ``jax.tree_util`` order."""
    return [p for p, _ in tree_flatten_with_path(tree)]


def tree_leaves(tree) -> list:
    """Leaves in ``jax.tree_util`` order."""
    return [l for _, l in tree_flatten_with_path(tree)]


def tree_unflatten_like(template, leaves: list):
    """Rebuild ``template``'s structure from ``leaves`` given in
    :func:`tree_leaves` order."""
    it = iter(leaves)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            vals = {k: build(t[k]) for k in sorted(t)}
            return {k: vals[k] for k in t}      # keep the template's order
        if isinstance(t, tuple) and hasattr(t, "_fields"):
            return type(t)(*[build(v) for v in t])
        if isinstance(t, (tuple, list)):
            return type(t)(build(v) for v in t)
        return next(it)

    return build(template)


def tree_map(fn, tree, *rest):
    """Apply ``fn`` leafwise over trees of identical structure (dicts,
    tuples and NamedTuples such as optimizer states).  ``None`` is an
    empty subtree, as in JAX."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, tuple):
        vals = [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
        return type(tree)(*vals) if hasattr(tree, "_fields") else tuple(vals)
    return fn(tree, *rest)


def tree_global_norm(tree) -> torch.Tensor:
    """L2 norm over every leaf (float32 accumulation)."""
    leaves = tree_leaves(tree)
    sq = sum(torch.sum(torch.square(l.float())) for l in leaves)
    return torch.sqrt(sq)


def tree_scale(tree, s):
    return tree_map(lambda l: l * s, tree)


def tree_add(a, b):
    return tree_map(torch.add, a, b)


def tree_lin(a, b, wa, wb):
    """wa*a + wb*b leafwise (FedAsync merge, Eq. 11)."""
    return tree_map(lambda x, y: wa * x + wb * y, a, b)


def tree_size(tree) -> int:
    return sum(l.numel() for l in tree_leaves(tree))


def tree_flatten_to_vector(tree, lead: int = 0) -> torch.Tensor:
    """Concatenate all leaves into one f32 vector per stacked entry:
    leaves (*S, ...) -> (*S, D) with ``S`` the ``lead`` leading axes."""
    leaves = tree_leaves(tree)
    s = leaves[0].shape[:lead]
    return torch.cat([l.reshape(s + (-1,)).float() for l in leaves], dim=lead)


def tree_unflatten_from_vector(vec, template, lead: int = 0):
    """Inverse of :func:`tree_flatten_to_vector`: ``vec`` (*S, D) ->
    tree shaped like ``template`` (an UNstacked tree) with the ``lead``
    stack axes of ``vec`` prepended to every leaf."""
    s = vec.shape[:lead]
    out, off = [], 0
    for l in tree_leaves(template):
        n = l.numel()
        out.append(vec[..., off:off + n].reshape(s + tuple(l.shape))
                   .to(l.dtype))
        off += n
    return tree_unflatten_like(template, out)
