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


def tree_paths(tree, prefix=()) -> list:
    """Leaf paths (tuples of keys) in sorted-key order."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(tree_paths(tree[k], prefix + (k,)))
        return out
    return [prefix]


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [l for k in sorted(tree) for l in tree_leaves(tree[k])]
    return [tree]


def tree_map(fn, tree, *rest):
    """Apply ``fn`` leafwise over trees of identical structure (dicts,
    tuples and NamedTuples such as optimizer states)."""
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
    off = [0]

    def take(l):
        n = l.numel()
        part = vec[..., off[0]:off[0] + n].reshape(s + tuple(l.shape))
        off[0] += n
        return part.to(l.dtype)

    # tree_map visits dict items in insertion order; rebuild in sorted
    # order so offsets follow the flat layout
    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        return take(t)

    return build(template)
