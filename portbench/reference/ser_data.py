"""The SER corpus, its IID partition and its train/test splits, in plain
numpy: what the program's testbed builds from the same seeds.

Frozen copy of ``src/repro_torch/data/synthetic_ser.py::generate`` and
``train_test_split`` and of ``src/repro_torch/data/partition.py::
iid_partition`` (the generative model is the system's own definition of
its data: a reference that drew another corpus would compare nothing).
"""
from __future__ import annotations

import numpy as np


def _smooth_field(rng, n, length, smooth=6):
    z = rng.standard_normal((n, length + smooth))
    k = np.ones(smooth) / smooth
    out = np.stack([np.convolve(z[i], k, mode="valid")[:length]
                    for i in range(n)])
    return out / (out.std(axis=1, keepdims=True) + 1e-8)


def generate(d: dict, n_total: int, seed: int) -> dict:
    """``d``: the data keys of the configuration (classes, speakers, frames,
    mels, ranks, gains, noise, jitter, label noise)."""
    rng = np.random.default_rng(seed)
    T, M, R = d["time_frames"], d["n_mels"], d["rank"]
    basis_u = _smooth_field(rng, R, T)
    basis_v = _smooth_field(rng, R, M)
    cls_a = rng.standard_normal((d["n_classes"], R)) * d["class_gain"]
    ns, sr = d["n_speakers"], d["speaker_rank"]
    spk_u = _smooth_field(rng, ns * sr, T).reshape(ns, sr, T)
    spk_v = _smooth_field(rng, ns * sr, M).reshape(ns, sr, M)
    spk_b = rng.standard_normal((ns, sr)) * d["speaker_gain"]
    n = n_total
    y_true = rng.integers(0, d["n_classes"], size=n)
    spk = rng.integers(0, ns, size=n)
    coeffs = cls_a[y_true] + d["coeff_jitter"] * rng.standard_normal((n, R))
    x = np.einsum("nr,rt,rm->ntm", coeffs, basis_u, basis_v)
    x += np.einsum("ns,nst,nsm->ntm", spk_b[spk], spk_u[spk], spk_v[spk])
    x += d["noise"] * rng.standard_normal((n, T, M))
    x = (x - x.mean()) / (x.std() + 1e-8)
    y = y_true.copy()
    if d["label_noise"] > 0:
        flip = rng.random(n) < d["label_noise"]
        y[flip] = rng.integers(0, d["n_classes"], size=int(flip.sum()))
    return {"x": x.astype(np.float32), "y": y.astype(np.int32),
            "speaker": spk.astype(np.int32)}


def iid_partition(data: dict, num_clients: int, seed: int) -> list:
    rng = np.random.default_rng(seed)
    y = data["y"]
    shards = [[] for _ in range(num_clients)]
    for c in np.unique(y):
        idx = rng.permutation(np.where(y == c)[0])
        for i, chunk in enumerate(np.array_split(idx, num_clients)):
            shards[i].append(chunk)
    out = []
    for parts in shards:
        sel = rng.permutation(np.concatenate(parts))
        out.append({k: v[sel] for k, v in data.items()})
    return out


def train_test_split(data: dict, test_frac: float, seed: int):
    rng = np.random.default_rng(seed)
    n = data["y"].shape[0]
    perm = rng.permutation(n)
    n_test = int(n * test_frac)
    te, tr = perm[:n_test], perm[n_test:]
    return ({k: v[tr] for k, v in data.items()},
            {k: v[te] for k, v in data.items()})


def client_splits(d: dict, n_total: int, num_clients: int, seed: int):
    """Per client ``(train, test)`` without the speaker column, and the
    pooled test set, as the testbed lays them out."""
    raw = generate(d, n_total, seed)
    splits, tests = [], []
    for cid, part in enumerate(iid_partition(raw, num_clients, seed)):
        tr, te = train_test_split(part, 0.2, seed + cid)
        tr = {k: v for k, v in tr.items() if k != "speaker"}
        te = {k: v for k, v in te.items() if k != "speaker"}
        splits.append((tr, te))
        tests.append(te)
    pooled = {k: np.concatenate([t[k] for t in tests]) for k in tests[0]}
    return splits, pooled
