"""Functional Adam and SGD over dicts of tensors (port of
``repro/optim/optimizers.py``; not ``torch.optim``).

Updates are pure functions ``update(grads, state, params) -> (params,
state)`` and work unchanged on a stacked cohort: every leaf may carry
leading member axes, and Adam's step counter then has those axes too
(shape (K,)), its bias corrections broadcasting over each leaf.  The bias
corrections ``1 - b**t`` are computed in float32, as the reference does
(optimizers.py:45), not as Python float64.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from repro_torch.pytree import tree_leaves, tree_map


class AdamState(NamedTuple):
    step: torch.Tensor   # int32, shape = the stack axes (() for one model)
    mu: dict
    nu: dict


def _bcast(v, leaf):
    """Reshape a per-member (K,) vector to broadcast over a (K, ...) leaf."""
    return v.reshape(v.shape + (1,) * (leaf.dim() - v.dim()))


@dataclass(frozen=True)
class Adam:
    lr: float = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0

    def init(self, params, stack_shape=()) -> AdamState:
        """Zero moments; ``stack_shape`` is the leading member axes of a
        stacked params tree (the step counter gets that shape)."""
        dev = tree_leaves(params)[0].device
        zeros = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                         params)
        return AdamState(
            step=torch.zeros(stack_shape, dtype=torch.int32, device=dev),
            mu=zeros, nu=tree_map(torch.clone, zeros))

    def update(self, grads, state: AdamState, params):
        step = state.step + 1
        t = step.to(torch.float32)
        mu = tree_map(lambda m, g: self.b1 * m + (1 - self.b1) * g.float(),
                      state.mu, grads)
        nu = tree_map(
            lambda v, g: self.b2 * v + (1 - self.b2) * torch.square(g.float()),
            state.nu, grads)
        bc1 = 1 - torch.pow(torch.full_like(t, self.b1), t)
        bc2 = 1 - torch.pow(torch.full_like(t, self.b2), t)

        def upd(p, m, v):
            u = (m / _bcast(bc1, m)) / (torch.sqrt(v / _bcast(bc2, v))
                                         + self.eps)
            if self.weight_decay:
                u = u + self.weight_decay * p.float()
            return (p.float() - self.lr * u).to(p.dtype)

        new_params = tree_map(upd, params, mu, nu)
        return new_params, AdamState(step=step, mu=mu, nu=nu)


class SGDState(NamedTuple):
    mom: dict


@dataclass(frozen=True)
class SGD:
    lr: float = 0.01
    momentum: float = 0.0

    def init(self, params, stack_shape=()) -> SGDState:
        return SGDState(mom=tree_map(
            lambda p: torch.zeros_like(p, dtype=torch.float32), params))

    def update(self, grads, state: SGDState, params):
        if self.momentum:
            mom = tree_map(lambda m, g: self.momentum * m + g.float(),
                           state.mom, grads)
            eff = mom
        else:
            mom, eff = state.mom, grads
        new_params = tree_map(
            lambda p, g: (p.float() - self.lr * g.float()).to(p.dtype),
            params, eff)
        return new_params, SGDState(mom=mom)


