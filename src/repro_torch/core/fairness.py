"""Fairness metrics (paper Sec. 4.2.2).

Participation percentages (PP), per-client accuracy gaps, and Jain's
fairness index over both participation counts and local accuracies.

Pure-numpy copy of ``repro/core/fairness.py``.
"""
from __future__ import annotations

import numpy as np


def participation_percentages(update_counts: dict) -> dict:
    total = float(sum(update_counts.values()))
    if total == 0:
        return {k: 0.0 for k in update_counts}
    return {k: 100.0 * v / total for k, v in update_counts.items()}


def jain_index(values) -> float:
    """Jain's fairness index: (sum x)^2 / (n * sum x^2).  1 = fair."""
    x = np.asarray(list(values), dtype=np.float64)
    if x.size == 0 or (x == 0).all():
        return 1.0
    return float((x.sum() ** 2) / (x.size * (x ** 2).sum()))


def accuracy_gap(per_client_acc: dict) -> float:
    vals = list(per_client_acc.values())
    return float(max(vals) - min(vals)) if vals else 0.0


def privacy_disparity(per_client_eps: dict) -> float:
    """max eps / min eps across clients (paper reports ~5-6x under FedAsync)."""
    vals = [v for v in per_client_eps.values() if v > 0]
    if not vals:
        return 1.0
    return float(max(vals) / max(min(vals), 1e-12))


def fairness_report(update_counts, per_client_acc, per_client_eps) -> dict:
    return {
        "participation_pct": participation_percentages(update_counts),
        "jain_participation": jain_index(update_counts.values()),
        "jain_accuracy": jain_index(per_client_acc.values()),
        "accuracy_gap": accuracy_gap(per_client_acc),
        "privacy_disparity": privacy_disparity(per_client_eps),
    }
