"""FL client: local DP-SGD training (port of ``repro/core/client.py``,
paper Algorithm 1, client side).

A client owns a local dataset partition, a hardware tier (VirtualClock),
an optimizer state and a MomentsAccountant, seeded exactly as the
reference (client.py:77-80), so the virtual-clock draws, minibatch
permutations and privacy bookkeeping replay the reference bit for bit.

``local_train`` is the legacy per-client loop's training (the cohort
engine, :mod:`repro_torch.engine`, trains many members at once instead):
E epochs of per-example DP-SGD through
:func:`repro_torch.core.dp.dp_mean_gradient`, one step per minibatch.
With ``dp_path="pallas"`` every step is one K = 1 ``dp_clip`` call (the
Triton kernels on the card).  The noise comes from a device
``torch.Generator`` seeded with the dispatch seed and drawn once per
local step (the port's RNG scheme, ROADMAP.md), the same stream a cohort
member with that seed draws, while the minibatch permutations come from
the reference's numpy stream ``self.rng``.

Personalized FL (``personal_keys``): those top-level param subtrees stay
on the client — restored over the received globals before training,
never uploaded (the upload carries the received values), and used by
:meth:`Client.evaluate`.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch
from torch.func import grad, vmap

from repro_torch.core.accountant import MomentsAccountant
from repro_torch.core.dp import DPConfig, dp_mean_gradient
from repro_torch.core.heterogeneity import DeviceProfile, VirtualClock
from repro_torch.optim.optimizers import Adam
from repro_torch.pytree import tree_leaves

# dispatch seeds are drawn as rng.integers(0, SEED_HIGH) from the run's
# np.random.default_rng(seed) (both backends, same order)
SEED_HIGH = 2 ** 62


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
    personal_keys: tuple = ()       # top-level subtrees kept on the client

    clock: VirtualClock = field(init=False)
    accountant: MomentsAccountant = field(init=False)
    rng: np.random.Generator = field(init=False)
    opt_state: object = field(init=False, default=None)
    model_version: int = 0          # global version this client last pulled
    update_count: int = 0
    staleness_history: list = field(default_factory=list)
    _personal: dict = field(init=False, default=None)

    def __post_init__(self):
        self.clock = VirtualClock(self.profile, seed=self.seed * 977 + self.cid)
        self.accountant = MomentsAccountant()
        self.rng = np.random.default_rng(self.seed * 131 + self.cid)

    def reset(self):
        """Restore construction-time state (clock/accountant/RNG chain,
        optimizer state, personal subtrees, version bookkeeping) so a
        testbed can be reused across runs: a reset run is bit-identical to
        one on a fresh testbed.  The dataset partition and the training
        config are untouched."""
        self.__post_init__()
        self.opt_state = None
        self.model_version = 0
        self.update_count = 0
        self.staleness_history = []
        self._personal = None

    @property
    def n_train(self) -> int:
        return int(self.data["y"].shape[0])

    @property
    def q(self) -> float:
        """Sampling ratio for the accountant (paper: q = B/|D_k| ~ 0.136)."""
        return min(1.0, self.batch_size / self.n_train)

    def local_train(self, global_params, seed: int, data=None):
        """Run E epochs of DP-SGD from ``global_params``; ``seed`` is the
        dispatch seed of this round's noise generator, ``data`` this
        client's train split on the params' device (its row of the data
        arena, ``statestore.DataArena``; uploaded for this call when
        None).

        Returns (new_params, info) with the virtual ``duration`` drawn from
        the tier's clock, the number of DP-SGD steps and the epsilon spent
        so far."""
        params = global_params
        if self.personal_keys:
            if self._personal is None:  # first round: adopt global init
                self._personal = {k: global_params[k]
                                  for k in self.personal_keys}
            params = dict(global_params)
            params.update(self._personal)
        if self.opt_state is None:
            self.opt_state = self.opt.init(params)
        opt_state = self.opt_state
        dev = tree_leaves(params)[0].device
        if data is None:
            data = {k: torch.from_numpy(v).to(dev) for k, v in
                    self.data.items()}
            data["y"] = data["y"].long()
        gen = torch.Generator(dev).manual_seed(int(seed))

        n = self.n_train
        steps = 0
        for _ in range(self.local_epochs):
            perm = self.rng.permutation(n)
            for s in range(0, n - self.batch_size + 1, self.batch_size):
                idx = torch.from_numpy(perm[s: s + self.batch_size]).to(dev)
                batch = {k: v[idx] for k, v in data.items()}
                if self.use_dp:
                    g, _aux = dp_mean_gradient(
                        self.loss_fn, params, batch, self.dp_cfg,
                        dp_path=self.dp_path, generator=gen)
                else:
                    g = grad(lambda p: torch.mean(vmap(
                        self.loss_fn, in_dims=(None, 0))(p, batch)))(params)
                params, opt_state = self.opt.update(g, opt_state, params)
                steps += 1

        self.opt_state = opt_state
        if self.use_dp and steps > 0:
            self.accountant.step(self.q, self.dp_cfg.noise_multiplier, steps)
        duration = self.clock.round_duration()
        self.update_count += 1
        info = {
            "duration": duration,
            "dp_steps": steps,
            "epsilon": self.accountant.epsilon(1e-5) if self.use_dp else 0.0,
        }
        if self.personal_keys:
            # the trained personal subtrees stay here; the upload carries
            # the received global values for those keys
            self._personal = {k: params[k] for k in self.personal_keys}
            upload = dict(params)
            for k in self.personal_keys:
                upload[k] = global_params[k]
            return upload, info
        return params, info

    def evaluate(self, params, accuracy_fn) -> float:
        if self.personal_keys and self._personal is not None:
            params = dict(params)
            params.update(self._personal)
        return float(accuracy_fn(params, self.test_data))
