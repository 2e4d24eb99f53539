"""Client partitioners: IID (the paper's setting) and Dirichlet non-IID
(beyond-paper ablation).

Pure-numpy copy of ``repro/data/partition.py``, held bitwise equal by
the parity tests."""
from __future__ import annotations

import numpy as np


def iid_partition(data: dict, num_clients: int, seed: int = 0):
    """Shuffle and split evenly — the paper's 5-way IID split with balanced
    classes (we shuffle within class to keep balance exact)."""
    rng = np.random.default_rng(seed)
    y = data["y"]
    idx_by_class = [np.where(y == c)[0] for c in np.unique(y)]
    shards = [[] for _ in range(num_clients)]
    for idx in idx_by_class:
        idx = rng.permutation(idx)
        for i, chunk in enumerate(np.array_split(idx, num_clients)):
            shards[i].append(chunk)
    out = []
    for parts in shards:
        sel = rng.permutation(np.concatenate(parts))
        out.append({k: v[sel] for k, v in data.items()})
    return out


def dirichlet_partition(data: dict, num_clients: int, alpha: float = 0.5, seed: int = 0):
    """Label-skew non-IID split (beyond-paper heterogeneity ablation)."""
    rng = np.random.default_rng(seed)
    y = data["y"]
    classes = np.unique(y)
    client_idx = [[] for _ in range(num_clients)]
    for c in classes:
        idx = rng.permutation(np.where(y == c)[0])
        props = rng.dirichlet([alpha] * num_clients)
        cuts = (np.cumsum(props)[:-1] * len(idx)).astype(int)
        for i, chunk in enumerate(np.split(idx, cuts)):
            client_idx[i].append(chunk)
    out = []
    for parts in client_idx:
        sel = np.concatenate(parts) if parts else np.array([], dtype=int)
        sel = rng.permutation(sel)
        out.append({k: v[sel] for k, v in data.items()})
    return out
