"""Server-side aggregation (port of ``repro/core/aggregation.py``): the
paper's two strategies.

  * :class:`FedAvg`   — Eq. (9): dataset-size-weighted average, barrier.
  * :class:`FedAsync` — Eq. (10)-(11): immediate merge with staleness-aware
                        decay alpha_k = alpha / (1 + tau_k), or staleness-
                        unaware (``fedasync_nostale``, the paper's Fig. 4
                        variant).

The reference's other strategies (``fedavg_trimmed``,
``fedasync_normbound``, ``fedbuff``, ``adaptive_async``) come with the
legacy client/server slice of the port; asking for them raises.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial

from repro_torch.pytree import tree_add, tree_lin, tree_scale


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


STRATEGIES = {
    "fedavg": FedAvg,
    "fedasync": FedAsync,
    "fedasync_nostale": partial(FedAsync, staleness_aware=False),
}

# reference strategies the port has not reached yet (ROADMAP queue 1)
LATER_STRATEGIES = ("fedavg_trimmed", "fedasync_normbound", "fedbuff",
                    "adaptive_async")


def make_strategy(name: str, **kw):
    name = str(name).lower()
    if name in LATER_STRATEGIES:
        raise ValueError(
            f"strategy {name!r} is not ported yet: it comes with the legacy "
            "client/server slice (ROADMAP.md queue 1, 'legacy client and "
            "server loop'); this slice runs fedavg, fedasync and "
            "fedasync_nostale")
    if name not in STRATEGIES:
        raise ValueError(
            f"unknown aggregation strategy: {name!r} "
            f"(ported: {', '.join(sorted(STRATEGIES))})")
    if name == "fedasync_nostale":
        kw.pop("staleness_aware", None)  # the variant pins it False
    return STRATEGIES[name](**kw)
