"""The production per-microbatch-DP round's config (port of
``repro/core/fl_step.py``, config only).

:class:`FLStepConfig` is here so that reference specs carrying it decode
(``repro_torch.api.spec``); the round itself and the ``"fl_step"``
client axis are not ported yet, and ``EngineConfig(fl_cfg=...)`` raises,
naming ROADMAP.md queue 1 item 14.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core.dp import DPConfig


@dataclass(frozen=True)
class FLStepConfig:
    num_clients: int                  # G = product of data axes
    n_local: int = 1                  # local SGD steps per round
    n_micro: int = 2                  # grad-accum microbatches per local step
    local_lr: float = 0.02
    server_lr: float = 1e-3
    dp: DPConfig = DPConfig(clip_norm=1.0, noise_multiplier=1.0,
                            granularity="per_microbatch")
    server_opt: str = "adam"          # adam (FedAdam) | sgd
    compute_dtype: str = "bfloat16"
