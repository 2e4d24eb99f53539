"""Run bookkeeping (port of ``repro/core/runlog.py``): everything the
paper's figures/tables need, plus the engine's cohort statistics.

``ENGINE_STATS_KEYS`` is key-for-key the reference's schema
(runlog.py:42).  The fault and screening counter names come from
:mod:`repro_torch.core.faults` and :mod:`repro_torch.core.screening`,
next to the code that increments them; the tiered-store counters are
defined here (``engine.statestore`` fills them; zero when all-resident).
The ``pallas_interpret`` slot holds the port's kernel-dispatch record
(:func:`repro_torch.kernels.common.kernel_info`).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from repro_torch.core.fairness import fairness_report
from repro_torch.core.faults import FAULT_STATS_KEYS
from repro_torch.core.screening import SCREEN_STATS_KEYS

STORE_STATS_KEYS = (
    "store_fetches",
    "store_hot_hits",
    "store_prefetch_hits",
    "store_stall_waits",
    "store_evictions",
    "store_spill_bytes",
    "store_sync_reads",
)

ENGINE_STATS_KEYS = (
    "data_path",                 # "arena" | "host"
    "dp_path",                   # "jnp" | "pallas"
    "pallas_interpret",          # kernel_info() dict, or None off-pallas
    "cohorts",                   # cohorts merged this run
    "h2d_bytes_total",           # host->device staging traffic (bytes)
    "h2d_bytes_per_cohort",      # h2d_bytes_total / cohorts
    "pipeline_depth",            # EngineConfig.pipeline_depth
    "host_syncs_at_eval",        # sanctioned _host_fetch blocking points
    "host_syncs_between_evals",  # serial path: one per blocking submit;
                                 # 0 on the pipelined path
    "blocking_submits",          # serial path's per-cohort submits
    "drain_waits",               # pipelined backpressure waits
) + FAULT_STATS_KEYS + SCREEN_STATS_KEYS + STORE_STATS_KEYS


def validate_engine_stats(stats: dict, context: str = "engine_stats"):
    """Assert ``stats`` carries exactly :data:`ENGINE_STATS_KEYS`."""
    if not isinstance(stats, dict):
        raise TypeError(f"{context} must be a dict: {stats!r}")
    got = set(stats)
    want = set(ENGINE_STATS_KEYS)
    missing, extra = sorted(want - got), sorted(got - want)
    if missing or extra:
        raise ValueError(
            f"{context} keys drifted from RunLog.ENGINE_STATS_KEYS — "
            f"missing: {missing or 'none'}, unexpected: {extra or 'none'}")
    return stats


@dataclass
class RunLog:
    strategy: str
    # time series (one entry per eval)
    times: list = field(default_factory=list)
    global_acc: list = field(default_factory=list)
    server_version: list = field(default_factory=list)
    # per client tier
    update_counts: dict = field(default_factory=dict)
    influence: dict = field(default_factory=dict)   # sum of applied merge weights
    staleness: dict = field(default_factory=dict)
    eps_trajectory: dict = field(default_factory=dict)
    local_acc: dict = field(default_factory=dict)
    resources: dict = field(default_factory=dict)
    dropouts: dict = field(default_factory=dict)
    cohort_sizes: list = field(default_factory=list)
    engine_stats: dict = field(default_factory=dict)
    fault_events: list = field(default_factory=list)

    def time_to_accuracy(self, target: float) -> Optional[float]:
        for t, a in zip(self.times, self.global_acc):
            if a >= target:
                return t
        return None

    def fairness(self) -> dict:
        final_acc = {k: (v[-1] if v else 0.0) for k, v in self.local_acc.items()}
        final_eps = {k: (v[-1] if v else 0.0) for k, v in self.eps_trajectory.items()}
        rep = fairness_report(self.update_counts, final_acc, final_eps)
        total_w = sum(self.influence.values())
        if total_w > 0:
            rep["influence_pct"] = {
                k: 100.0 * v / total_w for k, v in self.influence.items()}
        return rep


def eval_all(clients, params, accuracy_fn, log: RunLog):
    """Append every client's local-test accuracy to the log."""
    for c in clients:
        log.local_acc.setdefault(c.tier, []).append(c.evaluate(params, accuracy_fn))


def finish_log(log: RunLog, clients, injector=None, screener=None):
    """End-of-run bookkeeping shared by both backends: resource samples,
    dropouts, and the fault then screening events in order."""
    for c in clients:
        log.resources[c.tier] = c.clock.resource_sample()
        log.dropouts[c.tier] = c.clock.dropouts
    if injector is not None or screener is not None:
        ev = list(injector.events) if injector is not None else []
        if screener is not None:
            ev += list(screener.events)
        log.fault_events = ev
