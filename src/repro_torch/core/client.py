"""FL client host state (port of ``repro/core/client.py``).

A client owns a local dataset partition, a hardware tier (VirtualClock)
and a MomentsAccountant, seeded exactly as the reference
(client.py:77-80), so the virtual-clock draws, minibatch permutations
and privacy bookkeeping replay the reference bit for bit.  Training runs
in the cohort engine (:mod:`repro_torch.engine`); the per-client
``local_train`` loop and personalized heads come with the legacy
client/server slice of the port.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

import numpy as np

from repro_torch.core.accountant import MomentsAccountant
from repro_torch.core.dp import DPConfig
from repro_torch.core.heterogeneity import DeviceProfile, VirtualClock
from repro_torch.optim.optimizers import Adam


@dataclass
class Client:
    cid: int
    tier: str
    profile: DeviceProfile
    data: dict                      # {"x": (N,...), "y": (N,)} numpy train split
    test_data: dict                 # numpy local test split
    loss_fn: Callable               # loss_fn(params, example) -> scalar
    dp_cfg: DPConfig
    opt: Adam
    batch_size: int = 128
    local_epochs: int = 1
    seed: int = 0
    use_dp: bool = True
    dp_path: str = "jnp"            # "jnp" | "pallas" (fused clip+noise kernel)

    clock: VirtualClock = field(init=False)
    accountant: MomentsAccountant = field(init=False)
    rng: np.random.Generator = field(init=False)
    model_version: int = 0          # global version this client last pulled
    update_count: int = 0

    def __post_init__(self):
        self.clock = VirtualClock(self.profile, seed=self.seed * 977 + self.cid)
        self.accountant = MomentsAccountant()
        self.rng = np.random.default_rng(self.seed * 131 + self.cid)

    def reset(self):
        """Restore construction-time state (clock/accountant/RNG chain and
        version bookkeeping) so a testbed can be reused across runs; the
        dataset partition and training config are untouched."""
        self.__post_init__()
        self.model_version = 0
        self.update_count = 0

    @property
    def n_train(self) -> int:
        return int(self.data["y"].shape[0])

    @property
    def q(self) -> float:
        """Sampling ratio for the accountant (paper: q = B/|D_k| ~ 0.136)."""
        return min(1.0, self.batch_size / self.n_train)

    def evaluate(self, params, accuracy_fn) -> float:
        return float(accuracy_fn(params, self.test_data))
