"""Wires the paper testbed on the port (port of ``repro/core/testbed.py``):
synthetic CREMA-D + heterogeneous clients (HW_T1..T5) + a registry
workload + DP-SGD + the server loops.

Layers the Session keys on, as in the reference: :func:`build_partitions`
(pure numpy corpus, partitions and splits — bitwise the reference's;
keyed by :func:`partition_key`), :func:`build_clients`,
:func:`build_testbed`.  :func:`run_experiment` keeps the reference's
signature and is, as there, a shim over :class:`repro_torch.api.Session`.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from repro_torch.core.client import Client
from repro_torch.core.dp import DPConfig, validate_dp_path
from repro_torch.core.faults import FaultModel
from repro_torch.core.heterogeneity import PROFILES, TIERS
from repro_torch.core.screening import ScreeningConfig
from repro_torch.data.partition import dirichlet_partition, iid_partition
from repro_torch.data.synthetic_ser import (
    SERDataConfig, generate, train_test_split)
from repro_torch.device import resolve_device
from repro_torch.models import ser_cnn
from repro_torch.optim.optimizers import Adam


@dataclass(frozen=True)
class TestbedConfig:
    __test__ = False               # keep pytest from collecting this class

    num_clients: int = 5           # >5 cycles the hardware tiers T1..T5
    batch_size: int = 128          # paper: B = 128
    local_epochs: int = 1          # paper: E = 1
    lr: float = 1e-3               # paper: Adam 1e-3
    clip_norm: float = 1.0         # paper: C = 1
    sigma: float = 1.0             # paper sweeps {0.5, 1, 1.5, 2}
    use_dp: bool = True
    dp_path: str = "jnp"           # "jnp" | "pallas" (fused dp_clip kernels)
    personalized: bool = False     # per-client local output head (beyond-paper)
    partition: str = "iid"         # iid (paper) | dirichlet (beyond-paper)
    dirichlet_alpha: float = 0.5
    seed: int = 0
    data: SERDataConfig = SERDataConfig()
    model: ser_cnn.SERConfig = ser_cnn.SERConfig()
    workload: str = "ser_cnn"      # repro_torch.api.workloads entry
    faults: Optional[FaultModel] = None  # deterministic fault injection
                                   # (core.faults; None = fault-free run)
    screening: Optional[ScreeningConfig] = None  # update screening /
                                   # quarantine (core.screening; None =
                                   # every delivered upload merges)


def partition_key(cfg: TestbedConfig) -> tuple:
    """The fields :func:`build_partitions` depends on: sweeps that touch
    anything else reuse the generated partitions."""
    return (cfg.data, cfg.partition, cfg.dirichlet_alpha,
            cfg.num_clients, cfg.seed)


def build_partitions(cfg: TestbedConfig):
    """Generate the corpus, partition it and train/test-split each share.
    Returns ``(splits, pooled_test)`` (numpy, speaker column dropped)."""
    raw = generate(cfg.data)
    if cfg.partition == "dirichlet":
        parts = dirichlet_partition(raw, cfg.num_clients,
                                    alpha=cfg.dirichlet_alpha, seed=cfg.seed)
    else:
        parts = iid_partition(raw, cfg.num_clients, seed=cfg.seed)
    splits, test_pool = [], []
    for cid, part in enumerate(parts):
        tr, te = train_test_split(part, test_frac=0.2, seed=cfg.seed + cid)
        tr = {k: v for k, v in tr.items() if k != "speaker"}
        te = {k: v for k, v in te.items() if k != "speaker"}
        splits.append((tr, te))
        test_pool.append(te)
    pooled_test = {
        k: np.concatenate([t[k] for t in test_pool]) for k in test_pool[0]
    }
    return splits, pooled_test


def build_clients(cfg: TestbedConfig, splits) -> list:
    """Wrap partitions in Client objects (tier cycling for >5 clients)."""
    from repro_torch.api.workloads import get_workload
    validate_dp_path(cfg.dp_path)
    wl = get_workload(cfg.workload)
    loss = wl.shared_loss(cfg.model)
    opt = Adam(lr=cfg.lr)
    dp_cfg = DPConfig(
        clip_norm=cfg.clip_norm,
        noise_multiplier=cfg.sigma if cfg.use_dp else 0.0,
        granularity="per_example",
    )
    clients = []
    for cid, (tr, te) in enumerate(splits):
        tier = TIERS[cid % len(TIERS)]
        clients.append(Client(
            cid=cid, tier=tier, profile=PROFILES[tier], data=tr,
            test_data=te, loss_fn=loss, dp_cfg=dp_cfg, opt=opt,
            batch_size=cfg.batch_size, local_epochs=cfg.local_epochs,
            seed=cfg.seed, use_dp=cfg.use_dp, dp_path=cfg.dp_path,
            personal_keys=("out",) if cfg.personalized else ()))
    return clients


def build_testbed(cfg: TestbedConfig, device=None):
    """Returns (clients, global_params, accuracy_fn, pooled_test); the
    params are the workload's init from ``cfg.seed`` on ``device``."""
    from repro_torch.api.workloads import get_workload
    dev = resolve_device(device)
    wl = get_workload(cfg.workload)
    splits, pooled_test = build_partitions(cfg)
    clients = build_clients(cfg, splits)
    acc_fn = wl.shared_accuracy(cfg.model)
    params = wl.init(cfg.seed, cfg.model, dev)
    return clients, params, acc_fn, pooled_test


def run_experiment(
    strategy_name: str,
    cfg: TestbedConfig = TestbedConfig(),
    rounds: int = 60,
    max_updates: int = 300,
    alpha: float = 0.4,
    staleness_aware: bool = True,
    target_acc: Optional[float] = None,
    eval_every: int = 1,
    engine: str = "cohort",
    engine_cfg=None,
    mesh=None,
    device=None,
    **strategy_kw,
):
    """One full FL run; returns (params, RunLog).

    The reference's signature plus ``device`` (default: the card), and
    like the reference a shim over the declarative API: the arguments
    become an :class:`repro_torch.api.ExperimentSpec` run by a fresh
    one-run :class:`repro_torch.api.Session`.  ``engine`` is "cohort"
    (the batched engine) or "legacy" (the per-client loop); ``engine_cfg``
    may pick any of the reference's client-axis executors, ``"fl_step"``
    with its ``fl_cfg``.  ``mesh`` (cohort engine only, a
    :func:`repro_torch.launch.mesh.make_host_mesh` mesh, every rank of the
    process group calling this) partitions the cohort client axis over
    the mesh's data axis."""
    from repro_torch.api import ExperimentSpec, Session
    spec = ExperimentSpec.from_legacy(
        strategy_name, cfg, rounds=rounds, max_updates=max_updates,
        alpha=alpha, staleness_aware=staleness_aware, target_acc=target_acc,
        eval_every=eval_every, engine=engine, engine_cfg=engine_cfg,
        mesh=mesh, **strategy_kw)
    return Session(device=device).run(spec)
