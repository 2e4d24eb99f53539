"""Server-side aggregation strategies (port of ``repro/core/aggregation.py``).

Paper-faithful:
  * :class:`FedAvg`    — Eq. (9): dataset-size-weighted average, barrier.
  * :class:`FedAsync`  — Eq. (10)-(11): immediate merge with staleness-aware
                         decay alpha_k = alpha / (1 + tau_k), or staleness-
                         unaware (``fedasync_nostale``, the paper's Fig. 4
                         variant).

Beyond-paper:
  * :class:`FedBuff`   — buffered async aggregation (Nguyen et al.).
  * :class:`AdaptiveAsync` — the merge weight also shrinks with the
                         client's cumulative privacy spend.
  * :class:`TrimmedMeanFedAvg` / :class:`NormBoundedFedAsync` — robust
                         aggregation under corrupt updates (coordinate-wise
                         trimmed mean; norm-clamped async merge), the
                         aggregation-side complement to update screening
                         (:mod:`repro_torch.core.screening`).

Params are dicts of tensors; every merge is float32 arithmetic in the
reference's order, so the same numpy params give the reference's result
to float32 rounding (``tests/test_torch_strategies.py``).
"""
from __future__ import annotations

from dataclasses import dataclass, field, fields
from functools import partial

import torch

from repro_torch.pytree import (
    tree_add, tree_leaves, tree_lin, tree_map, tree_scale)


@dataclass
class FedAvg:
    """Synchronous, dataset-size weighted (Eq. 9)."""

    name: str = "fedavg"
    is_async: bool = False

    def aggregate(self, global_params, updates):
        """``updates`` = list of (params_k, n_k).  Returns new globals."""
        total = float(sum(n for _, n in updates))
        acc = None
        for params_k, n_k in updates:
            contrib = tree_scale(params_k, n_k / total)
            acc = contrib if acc is None else tree_add(acc, contrib)
        return acc


@dataclass
class FedAsync:
    """Asynchronous with staleness-aware decay (Eq. 10-11)."""

    alpha: float = 0.4
    staleness_aware: bool = True
    name: str = "fedasync"
    is_async: bool = True

    def mixing_weight(self, staleness: int) -> float:
        if self.staleness_aware:
            return self.alpha / (1.0 + float(staleness))
        return self.alpha

    def merge(self, global_params, client_params, staleness: int):
        a_k = self.mixing_weight(staleness)
        return tree_lin(global_params, client_params, 1.0 - a_k, a_k), a_k


@dataclass
class TrimmedMeanFedAvg(FedAvg):
    """Robust synchronous aggregation: coordinate-wise trimmed mean.

    Sorts the K payloads per coordinate, drops the ``floor(trim_frac * K)``
    largest and smallest values (capped so at least one survives) and
    averages the rest.  Unweighted on purpose, and never fused into the
    weights-vector merge (a per-coordinate sort is not a weighted sum).
    """

    trim_frac: float = 0.2
    name: str = "fedavg_trimmed"

    def __post_init__(self):
        if not 0.0 <= self.trim_frac < 0.5:
            raise ValueError(
                f"trim_frac must be in [0, 0.5): {self.trim_frac} "
                "(trimming half or more from each end leaves nothing)")

    def aggregate(self, global_params, updates):
        k = len(updates)
        cut = min(int(self.trim_frac * k), (k - 1) // 2)
        payloads = [u for u, _ in updates]

        def leaf(*vals):
            v = torch.sort(torch.stack(vals, dim=0), dim=0).values
            return torch.mean(v[cut: k - cut], dim=0)

        return tree_map(leaf, *payloads)


@dataclass
class NormBoundedFedAsync(FedAsync):
    """Robust async merge: the client delta is norm-clamped before the
    staleness-weighted Eq. 11 merge — it moves the globals by
    ``min(1, norm_bound / ||p_k - g||)`` of the delta, a nonfinite
    update by nothing, and an in-bound update exactly like plain
    FedAsync.  The reported influence weight is the nominal
    ``alpha/(1+tau)``."""

    norm_bound: float = 10.0
    name: str = "fedasync_normbound"

    def __post_init__(self):
        if not self.norm_bound > 0:
            raise ValueError(f"norm_bound must be > 0: {self.norm_bound}")

    def merge(self, global_params, client_params, staleness: int):
        sq = None
        for g, p in zip(tree_leaves(global_params),
                        tree_leaves(client_params)):
            d = p.float() - g.float()
            part = torch.sum(d * d)
            sq = part if sq is None else sq + part
        norm = torch.sqrt(sq)
        one = torch.ones((), dtype=torch.float32, device=norm.device)
        clamp = torch.where(
            torch.isfinite(norm),
            torch.minimum(one, self.norm_bound
                          / torch.clamp(norm, min=1e-12)),
            torch.zeros_like(one))

        def leaf(g, p):
            gf, pf = g.float(), p.float()
            # a nonfinite payload contributes nothing: clamp is 0 there, and
            # its entries fall back to the globals so 0 * NaN cannot
            # re-poison the projection
            pf = torch.where(torch.isfinite(pf), pf, gf)
            proj = (gf + clamp * (pf - gf)).to(p.dtype)
            # clamp == 1 selects the payload verbatim: an in-bound update
            # merges bit-identically to plain FedAsync
            return torch.where(clamp == 1.0, p, proj)

        bounded = tree_map(leaf, global_params, client_params)
        return super().merge(global_params, bounded, staleness)


@dataclass
class FedBuff:
    """Buffered asynchronous aggregation: buffers ``buffer_size``
    staleness-weighted updates, then applies their weighted mean in one
    server step."""

    alpha: float = 0.4
    buffer_size: int = 3
    staleness_aware: bool = True
    name: str = "fedbuff"
    is_async: bool = True

    _buffer: list = field(default_factory=list, repr=False)

    def mixing_weight(self, staleness: int) -> float:
        if self.staleness_aware:
            return self.alpha / (1.0 + float(staleness))
        return self.alpha

    def offer(self, global_params, client_params, staleness: int):
        """Returns (new_globals | None, applied: bool, weight)."""
        w = self.mixing_weight(staleness)
        self._buffer.append((client_params, w))
        if len(self._buffer) < self.buffer_size:
            return None, False, w
        wsum = sum(w_ for _, w_ in self._buffer)
        mix = None
        for p, w_ in self._buffer:
            c = tree_scale(p, w_ / wsum)
            mix = c if mix is None else tree_add(mix, c)
        # effective server step: move by the mean weight toward the mix
        a = wsum / len(self._buffer)
        new_globals = tree_lin(global_params, mix, 1.0 - a, a)
        self._buffer = []
        return new_globals, True, w


@dataclass
class AdaptiveAsync(FedAsync):
    """Joint aggregation-privacy adaptation: the merge weight is scaled by
    the client's remaining privacy budget,
    w = alpha/(1+tau) * max(eps_floor, 1 - eps_k/eps_target)."""

    eps_target: float = 8.0
    eps_floor: float = 0.1
    name: str = "adaptive_async"

    def mixing_weight(self, staleness: int, eps_spent: float = 0.0) -> float:
        base = super().mixing_weight(staleness)
        budget_frac = max(self.eps_floor, 1.0 - eps_spent / self.eps_target)
        return base * budget_frac

    def merge(self, global_params, client_params, staleness: int,
              eps_spent: float = 0.0):
        a_k = self.mixing_weight(staleness, eps_spent)
        return tree_lin(global_params, client_params, 1.0 - a_k, a_k), a_k


def apply_update(strategy, global_params, params_k, tau: int,
                 eps_spent: float = 0.0):
    """Route one client update through ``strategy`` (the one switch the
    legacy loop and the cohort engine share).  Returns ``(new_globals,
    version_inc, weight)``; ``version_inc`` is 0 while FedBuff buffers."""
    if isinstance(strategy, FedBuff):
        new_g, applied, w = strategy.offer(global_params, params_k, tau)
        if applied:
            return new_g, 1, w
        return global_params, 0, w
    if isinstance(strategy, AdaptiveAsync):
        new_g, w = strategy.merge(global_params, params_k, tau,
                                  eps_spent=eps_spent)
        return new_g, 1, w
    new_g, w = strategy.merge(global_params, params_k, tau)
    return new_g, 1, w


# ---------------------------------------------------------------------------
# the name -> (constructor, tunable params) registry shared by
# make_strategy and repro_torch.api.StrategySpec
# ---------------------------------------------------------------------------

def _tunable_params(cls, exclude=()) -> tuple:
    """Init-able dataclass fields minus identity fields and private state."""
    skip = {"name", "is_async"} | set(exclude)
    return tuple(f.name for f in fields(cls)
                 if f.init and f.name not in skip
                 and not f.name.startswith("_"))


# fedasync_nostale pins staleness_aware=False (the paper's Fig. 4
# "without staleness control" variant), so that knob is not tunable there
STRATEGIES = {
    "fedavg": (FedAvg, ()),
    "fedavg_trimmed": (TrimmedMeanFedAvg,
                       _tunable_params(TrimmedMeanFedAvg)),
    "fedasync": (FedAsync, _tunable_params(FedAsync)),
    "fedasync_nostale": (
        partial(FedAsync, staleness_aware=False),
        _tunable_params(FedAsync, exclude=("staleness_aware",))),
    "fedasync_normbound": (NormBoundedFedAsync,
                           _tunable_params(NormBoundedFedAsync)),
    "fedbuff": (FedBuff, _tunable_params(FedBuff)),
    "adaptive_async": (AdaptiveAsync, _tunable_params(AdaptiveAsync)),
}

STRATEGY_NAMES = tuple(STRATEGIES)


def strategy_params(name: str) -> tuple:
    """Valid keyword params for ``name`` (raises on unknown names)."""
    try:
        return STRATEGIES[name.lower()][1]
    except KeyError:
        raise ValueError(
            f"unknown aggregation strategy: {name!r} "
            f"(valid: {', '.join(sorted(STRATEGIES))})") from None


def validate_strategy_params(name: str, kw: dict) -> str:
    """Check ``kw`` against the registry, values included (the dataclass
    is built once), and return the normalized name."""
    name = str(name).lower()
    allowed = strategy_params(name)
    unknown = sorted(set(kw) - set(allowed))
    if unknown:
        raise ValueError(
            f"unknown param(s) {', '.join(unknown)} for strategy "
            f"{name!r} (valid: {', '.join(allowed) or 'none'})")
    STRATEGIES[name][0](**kw)
    return name


def make_strategy(name: str, **kw):
    name = str(name).lower()
    if name == "fedasync_nostale":
        kw.pop("staleness_aware", None)  # the reference's frontend tolerance
    name = validate_strategy_params(name, kw)
    return STRATEGIES[name][0](**kw)
