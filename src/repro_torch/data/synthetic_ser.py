"""Synthetic CREMA-D-shaped SER dataset (DESIGN.md sec 2).

Pure-numpy copy of ``repro/data/synthetic_ser.py`` (the port never
imports ``repro``); the parity tests hold it bitwise equal.

CREMA-D is not available offline, so we synthesize mel-spectrogram-like
patches with the same cardinality the paper uses after filtering:
5,882 clips, 4 classes (Neutral/Happy/Angry/Sad), 91 speakers, balanced
classes; 5 IID client partitions with 80/20 train/test (~941 train / ~234
test per client).

Generation model (shared-basis low-rank time-frequency fields):

    x = sum_r  a_r(class, sample) * u_r(t) v_r(f)   (SHARED basis; classes
                                                     differ only in their
                                                     coefficient vectors)
      + sum_s  b_s(speaker) * p_s(t) q_s(f)         (speaker nuisance)
      + noise * N(0,1)

plus label noise (a fraction of labels flipped uniformly).  Classes
sharing one smooth basis and differing only in mixing coefficients makes
the task genuinely hard for a small CNN (it must learn coefficient
geometry, not template matching), and label noise caps attainable accuracy
— giving the paper's 75 %-after-60-rounds convergence dynamics room to
appear under DP-SGD.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

CLASSES = ("neutral", "happy", "angry", "sad")


@dataclass(frozen=True)
class SERDataConfig:
    n_total: int = 5882
    n_classes: int = 4
    n_speakers: int = 91
    time_frames: int = 64
    n_mels: int = 40
    rank: int = 6           # shared basis rank
    speaker_rank: int = 2
    class_gain: float = 0.8     # scale of class coefficient separation
    speaker_gain: float = 1.0
    noise: float = 1.6
    coeff_jitter: float = 0.55  # per-sample jitter on class coefficients
    label_noise: float = 0.12   # fraction of labels flipped uniformly
    seed: int = 1234


def _smooth_field(rng, n, length, smooth=6):
    """(n, length) smooth random curves via moving-average of white noise."""
    z = rng.standard_normal((n, length + smooth))
    k = np.ones(smooth) / smooth
    out = np.stack([np.convolve(z[i], k, mode="valid")[:length] for i in range(n)])
    return out / (out.std(axis=1, keepdims=True) + 1e-8)


def generate(cfg: SERDataConfig = SERDataConfig()):
    """Returns dict with x: (N, T, M) float32, y: (N,) int32, speaker: (N,)."""
    rng = np.random.default_rng(cfg.seed)
    T, M, R = cfg.time_frames, cfg.n_mels, cfg.rank

    # ONE shared smooth basis; classes differ only in coefficient vectors
    basis_u = _smooth_field(rng, R, T)                     # (R, T)
    basis_v = _smooth_field(rng, R, M)                     # (R, M)
    cls_a = rng.standard_normal((cfg.n_classes, R)) * cfg.class_gain

    spk_u = _smooth_field(rng, cfg.n_speakers * cfg.speaker_rank, T).reshape(
        cfg.n_speakers, cfg.speaker_rank, T
    )
    spk_v = _smooth_field(rng, cfg.n_speakers * cfg.speaker_rank, M).reshape(
        cfg.n_speakers, cfg.speaker_rank, M
    )
    spk_b = rng.standard_normal((cfg.n_speakers, cfg.speaker_rank)) * cfg.speaker_gain

    n = cfg.n_total
    y_true = rng.integers(0, cfg.n_classes, size=n)
    spk = rng.integers(0, cfg.n_speakers, size=n)
    # per-sample coefficient jitter (prosody / utterance variability)
    coeffs = cls_a[y_true] + cfg.coeff_jitter * rng.standard_normal((n, R))

    x = np.einsum("nr,rt,rm->ntm", coeffs, basis_u, basis_v)
    x += np.einsum("ns,nst,nsm->ntm", spk_b[spk], spk_u[spk], spk_v[spk])
    x += cfg.noise * rng.standard_normal((n, T, M))
    x = (x - x.mean()) / (x.std() + 1e-8)

    # label noise: flip a fraction of labels uniformly at random
    y = y_true.copy()
    if cfg.label_noise > 0:
        flip = rng.random(n) < cfg.label_noise
        y[flip] = rng.integers(0, cfg.n_classes, size=int(flip.sum()))

    return {
        "x": x.astype(np.float32),
        "y": y.astype(np.int32),
        "speaker": spk.astype(np.int32),
    }


def train_test_split(data, test_frac=0.2, seed=0):
    rng = np.random.default_rng(seed)
    n = data["y"].shape[0]
    perm = rng.permutation(n)
    n_test = int(n * test_frac)
    te, tr = perm[:n_test], perm[n_test:]
    take = lambda idx: {k: v[idx] for k, v in data.items()}
    return take(tr), take(te)
