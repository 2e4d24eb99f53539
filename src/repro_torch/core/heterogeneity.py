"""Device-heterogeneity simulation layer (replaces the paper's physical
testbed — DESIGN.md sec 2).

Five hardware tiers HW_T1..HW_T5 (paper Table 1/2, Fig. 3), calibrated so
that the *emergent* behaviour matches the paper's measurements:

  * per-round local-training time: high-end 65-75 s, low-end 6-9x longer;
  * exchange latency ~25 ms high-end, ~7x higher low-end;
  * dropout/rejoin events on T1 (3 observed), T2 (2 observed) over 60 rounds;
  * under FedAsync the emergent staleness is tau ~ {7, 6, 4, 0, 0}.

The virtual clock is deterministic given a seed; nothing here touches real
wall time.

Pure-numpy copy of ``repro/core/heterogeneity.py``, held bitwise equal
by the parity tests.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class DeviceProfile:
    tier: str                 # "HW_T1".."HW_T5"
    device: str               # human-readable hardware name
    compute_time_s: float     # mean local-training time per round (seconds)
    compute_jitter: float     # lognormal sigma of compute time
    exchange_latency_s: float # model up+download latency per round
    ram_gb: float
    ram_usage_pct: float      # paper Table 2 (reported by resource monitor)
    cpu_user_s: float         # paper Table 2, cumulative over 60 rounds
    cpu_sys_s: float
    dropout_per_round: float  # P(drop this round); rejoin after penalty
    dropout_penalty_s: float  # extra delay when a dropout occurs
    application: str


# Calibration: paper Fig. 3b gives high-end ~65-75 s and low-end 6-9x longer
# (~420-600 s); T3 is ~3-4x faster than low-end, ~3-4x slower than high-end.
# Fig. 3c: exchange latency ~25 ms high-end, ~7x low-end (~175 ms).
# Dropout rates chosen so E[#dropouts over 60 rounds] = 3 / 2 / 0 (Table 2).
PROFILES = {
    "HW_T1": DeviceProfile(
        tier="HW_T1", device="Raspberry Pi 3 Model B",
        compute_time_s=540.0, compute_jitter=0.22, exchange_latency_s=0.175,
        ram_gb=1.0, ram_usage_pct=78.7, cpu_user_s=2268.2, cpu_sys_s=311.0,
        dropout_per_round=0.05, dropout_penalty_s=180.0,
        application="Smart Homes (low-end)",
    ),
    "HW_T2": DeviceProfile(
        tier="HW_T2", device="Raspberry Pi 3 Model B+",
        compute_time_s=470.0, compute_jitter=0.20, exchange_latency_s=0.16,
        ram_gb=1.0, ram_usage_pct=77.1, cpu_user_s=2087.9, cpu_sys_s=275.2,
        dropout_per_round=0.033, dropout_penalty_s=150.0,
        application="Entertainment (low-mid)",
    ),
    "HW_T3": DeviceProfile(
        tier="HW_T3", device="NXP HummingBoard",
        compute_time_s=230.0, compute_jitter=0.12, exchange_latency_s=0.09,
        ram_gb=1.0, ram_usage_pct=77.0, cpu_user_s=1117.3, cpu_sys_s=93.7,
        dropout_per_round=0.0, dropout_penalty_s=0.0,
        application="Healthcare (moderate)",
    ),
    "HW_T4": DeviceProfile(
        tier="HW_T4", device="Raspberry Pi 4 Model B (4GB)",
        compute_time_s=72.0, compute_jitter=0.06, exchange_latency_s=0.027,
        ram_gb=4.0, ram_usage_pct=49.6, cpu_user_s=1122.0, cpu_sys_s=83.3,
        dropout_per_round=0.0, dropout_penalty_s=0.0,
        application="Automotive (high-mid)",
    ),
    "HW_T5": DeviceProfile(
        tier="HW_T5", device="Raspberry Pi 4 Model B (8GB)",
        compute_time_s=66.0, compute_jitter=0.05, exchange_latency_s=0.025,
        ram_gb=8.0, ram_usage_pct=30.5, cpu_user_s=1036.4, cpu_sys_s=80.9,
        dropout_per_round=0.0, dropout_penalty_s=0.0,
        application="Education (high-end)",
    ),
}

TIERS = tuple(PROFILES)  # ordered T1..T5


class VirtualClock:
    """Deterministic event-time sampler for one client."""

    def __init__(self, profile: DeviceProfile, seed: int):
        self.profile = profile
        self.rng = np.random.default_rng(seed)
        self.dropouts = 0

    def round_duration(self) -> float:
        """Sample one round's wall time: compute + exchange (+ dropout)."""
        p = self.profile
        t = p.compute_time_s * float(
            self.rng.lognormal(mean=0.0, sigma=p.compute_jitter)
        )
        t += p.exchange_latency_s
        if p.dropout_per_round > 0 and self.rng.random() < p.dropout_per_round:
            self.dropouts += 1
            t += p.dropout_penalty_s
        return t

    def resource_sample(self):
        """RAM%/CPU-time sample consistent with paper Table 2 noise levels."""
        p = self.profile
        return {
            "ram_pct": p.ram_usage_pct + float(self.rng.normal(0, 1.5)),
            "cpu_user_s": p.cpu_user_s + float(self.rng.normal(0, p.cpu_user_s * 0.04)),
            "cpu_sys_s": p.cpu_sys_s + float(self.rng.normal(0, p.cpu_sys_s * 0.08)),
        }
