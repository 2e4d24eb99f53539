"""Run bookkeeping (port of ``repro/core/runlog.py``): everything the
paper's figures/tables need, plus the engine's cohort statistics.

``ENGINE_STATS_KEYS`` is key-for-key the reference's schema
(runlog.py:42).  The fault, screening and tiered-store counter names are
copied constants here (the reference takes them from
``repro.core.faults``, ``repro.core.screening`` and its own store tuple);
in this slice of the port those features do not exist yet and their
counters are always zero.  The ``pallas_interpret`` slot holds the port's
kernel-dispatch record (:func:`repro_torch.kernels.common.kernel_info`).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from repro_torch.core.fairness import fairness_report

FAULT_STATS_KEYS = (
    "fault_failures",
    "fault_upload_losses",
    "fault_retries",
    "fault_lost_updates",
    "fault_duplicates_dropped",
    "fault_late_deliveries",
    "fault_churn_leaves",
    "fault_corruptions",
    "degraded_cohorts",
    "deadline_drops",
)

SCREEN_STATS_KEYS = (
    "screen_rejections",
    "screen_nonfinite",
    "screen_norm_rejects",
    "screen_quarantined",
    "screen_quarantine_drops",
    "screen_verdict_syncs",
)

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
    "data_path",                 # "arena" (the only data path of the port)
    "dp_path",                   # "jnp" | "pallas"
    "pallas_interpret",          # kernel_info() dict, or None off-pallas
    "cohorts",                   # cohorts merged this run
    "h2d_bytes_total",           # host->device staging traffic (bytes)
    "h2d_bytes_per_cohort",      # h2d_bytes_total / cohorts
    "pipeline_depth",            # EngineConfig.pipeline_depth (1)
    "host_syncs_at_eval",        # sanctioned _host_fetch blocking points
    "host_syncs_between_evals",  # serial path: one per blocking submit
    "blocking_submits",          # serial path's per-cohort submits
    "drain_waits",               # pipelined backpressure waits (0)
) + FAULT_STATS_KEYS + SCREEN_STATS_KEYS + STORE_STATS_KEYS


def zero_feature_stats() -> dict:
    """The fault/screen/store counters of a run without those features."""
    return {k: 0 for k in FAULT_STATS_KEYS + SCREEN_STATS_KEYS
            + STORE_STATS_KEYS}


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
