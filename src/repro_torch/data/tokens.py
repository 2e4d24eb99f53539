"""Synthetic LM token pipeline (numpy copy of ``repro/data/tokens.py``):
deterministic, seeded, learnable.

Sequences follow a noisy affine recurrence over a vocabulary subset
(t_{i+1} = (a * t_i + c) mod V' with probability 1-p, uniform otherwise).
The port's serving path takes its prompts from here; the tests hold it
bit for bit to the JAX package's copy.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class TokenDataConfig:
    vocab: int
    seq_len: int
    effective_vocab: int = 0     # 0 -> min(vocab, 4096)
    noise: float = 0.15
    seed: int = 0


def make_batches(cfg: TokenDataConfig, num_batches: int, batch_size: int):
    """Yields dicts {tokens (B,S), labels (B,S)} of int32."""
    rng = np.random.default_rng(cfg.seed)
    V = cfg.effective_vocab or min(cfg.vocab, 4096)
    a, c = 31, 17
    for _ in range(num_batches):
        t0 = rng.integers(0, V, size=(batch_size, 1))
        toks = [t0]
        for _ in range(cfg.seq_len):
            nxt = (a * toks[-1] + c) % V
            flip = rng.random((batch_size, 1)) < cfg.noise
            rand = rng.integers(0, V, size=(batch_size, 1))
            toks.append(np.where(flip, rand, nxt))
        seq = np.concatenate(toks, axis=1)
        yield {
            "tokens": seq[:, : cfg.seq_len].astype(np.int32),
            "labels": seq[:, 1 : cfg.seq_len + 1].astype(np.int32),
        }
