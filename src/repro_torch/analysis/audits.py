"""Program audits for the cohort engine (port of
``repro/analysis/audits.py``).

Each checker machine-verifies an invariant that was once a hand-won
debugging session, on what the port's run leaves behind (the port has
no compiled executable to inspect):

* :func:`audit_sharding` — a cohort that stays whole on every rank keeps
  results right while every rank redoes the whole cohort's work.  The
  audit takes the cohort step's record of this rank's rows (a tree of
  :class:`~repro_torch.engine.mesh_backend.Shard`, the step's
  ``partition``) and fails if a leaf carrying the client axis is whole
  on a rank of a multi-rank data axis.
* :func:`audit_donation` — the port writes its client-state arenas in
  place (``index_copy_``) where the reference donates them.  The audit
  compares storages before and after a step: ``expect=True`` fails when
  a step reallocated an arena (which silently doubles its memory),
  ``expect=False`` when an output aliases an input.
* :func:`audit_collectives` — the sharded cohort step legitimately
  gathers its members (all-gathers ARE expected); what must not drift is
  the *budget*.  The audit reads :func:`repro_torch.launch.collectives.
  stats` and fails on forbidden kinds or counts above a per-kind budget.
* :func:`audit_engine_stats` — bench provenance (which DP path, which
  kernel ran, did the pipeline sync) must not drift silently.  The audit
  pins a recorded ``RunLog.engine_stats`` to the frozen schema in
  :data:`repro_torch.core.runlog.ENGINE_STATS_KEYS` and its ledgers'
  conservation laws.

All audits raise :class:`AuditFailure` with an actionable message
(the reference's wording, so that tests match the same phrases).
"""
from __future__ import annotations

from repro_torch.analysis.hlo import analyze, donation_aliases
from repro_torch.core.runlog import ENGINE_STATS_KEYS, validate_engine_stats


class AuditFailure(AssertionError):
    """A program invariant did not hold."""


# ---------------------------------------------------------------------------
# sharding
# ---------------------------------------------------------------------------

def _shard_view(leaf):
    """``(global shape, this rank's shape)`` of a :class:`Shard` leaf; a
    plain tensor is whole on this rank."""
    if hasattr(leaf, "local") and hasattr(leaf, "shape"):
        return tuple(leaf.shape), tuple(leaf.local.shape)
    return tuple(leaf.shape), tuple(leaf.shape)


def audit_sharding(partition, *, client_dim, min_partition=2,
                   label="cohort_step"):
    """Fail if any leaf carrying the stacked-client axis is whole on this
    rank instead of partitioned.

    ``partition`` is the cohort step's ``partition`` after a cohort (a
    tree of :class:`~repro_torch.engine.mesh_backend.Shard`: each leaf's
    global ``shape`` and this rank's ``local`` rows); a plain tensor leaf
    counts as whole.  A leaf participates when its leading dim equals
    ``client_dim`` (the padded cohort size); such a leaf must hold at
    most ``client_dim // min_partition`` rows on this rank
    (``min_partition``: the data-axis product).  Returns the number of
    leaves audited."""
    from repro_torch.pytree import tree_leaves
    audited = 0
    leaves = tree_leaves(partition) if partition is not None else []
    for i, leaf in enumerate(leaves):
        shape, local = _shard_view(leaf)
        if not shape or shape[0] != client_dim:
            continue
        audited += 1
        if local[0] * min_partition > shape[0]:
            raise AuditFailure(
                f"{label}: leaf {i} shape={shape} carries the client axis "
                f"(dim0={client_dim}) but this rank holds {local} — "
                f"replicated/under-partitioned (expected <= "
                f"{shape[0] // min_partition} rows per rank). Pad the "
                "cohort to a multiple of the data-axis product, or the "
                "step trains the whole cohort on every rank.")
    if audited == 0:
        raise AuditFailure(
            f"{label}: no leaf has leading dim {client_dim} — the audit "
            "checked nothing (wrong client_dim, or no partition recorded?)")
    return audited


# ---------------------------------------------------------------------------
# donation (in-place arenas)
# ---------------------------------------------------------------------------

def audit_donation(inputs, outputs, *, expect: bool, min_aliases=None,
                   label="cohort_step"):
    """Verify which outputs share storage with which inputs.

    ``inputs`` and ``outputs`` are trees of tensors, e.g. a runner's
    arenas before and after a cohort (hold the "before" tensors: a freed
    storage's identity may be reused).  ``expect=True``: at least
    ``min_aliases`` input leaves (default: every one) must be aliased by
    an output — an arena a step reallocated instead of writing in place
    is the silent memory-doubling regression.  ``expect=False``: no
    output may alias an input.  Returns the number of aliases."""
    from repro_torch.pytree import tree_leaves
    aliases = donation_aliases(inputs, outputs)
    n_in = len(tree_leaves(inputs))
    kept = {i for _, i in aliases}
    need = n_in if min_aliases is None else int(min_aliases)
    if expect and len(kept) < need:
        lost = sorted(set(range(n_in)) - kept)
        raise AuditFailure(
            f"{label}: in-place write expected, but only {len(kept)} of "
            f"{n_in} input leaves kept their storage — aliases "
            f"materialized for {len(kept)} (expected >= {need}); leaves "
            f"{lost[:8]} were reallocated, so the arena's memory is "
            "held twice while the old storage lives.")
    if not expect and aliases:
        raise AuditFailure(
            f"{label}: donation expected OFF but {len(aliases)} output/"
            f"input aliases present: {aliases[:4]} — an output that "
            "shares an input's storage is overwritten by the next write "
            "to that input.")
    return len(aliases)


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

def audit_collectives(stats, *, forbid=(), max_counts=None,
                      label="cohort_step"):
    """Budget-check a run's collectives.

    ``stats`` is :func:`repro_torch.launch.collectives.stats` after the
    run; kinds carry the reference's names (``all-gather``,
    ``all-reduce``, ``reduce-scatter``; the port's ``broadcast`` and
    ``barrier`` keep theirs).  ``forbid`` names kinds that must not
    appear at all; ``max_counts`` maps kind -> max calls.  Returns the
    counts."""
    counts = analyze(stats)["collective_counts"]
    for kind in forbid:
        if counts.get(kind, 0) > 0:
            raise AuditFailure(
                f"{label}: forbidden collective {kind!r} appears "
                f"{counts[kind]}x (counts: {dict(counts)}). An unexpected "
                f"{kind} on the client axis usually means a cohort's rows "
                "are being moved that should stay on their rank.")
    for kind, budget in (max_counts or {}).items():
        if counts.get(kind, 0) > budget:
            raise AuditFailure(
                f"{label}: {kind} count {counts[kind]} exceeds budget "
                f"{budget} (counts: {dict(counts)}) — the run's "
                "collective footprint drifted; re-derive the budget or "
                "fix the regression.")
    return dict(counts)


# ---------------------------------------------------------------------------
# engine-stats provenance
# ---------------------------------------------------------------------------

def audit_engine_stats(stats: dict, *, label="engine_stats"):
    """Pin a recorded ``RunLog.engine_stats`` dict to the frozen schema
    (:data:`repro_torch.core.runlog.ENGINE_STATS_KEYS`) and the
    cross-field invariants the bench contract relies on."""
    try:
        validate_engine_stats(stats, context=label)
    except (TypeError, ValueError) as e:
        raise AuditFailure(str(e)) from e
    if stats["pipeline_depth"] > 1 and stats["host_syncs_between_evals"]:
        raise AuditFailure(
            f"{label}: pipelined run (depth="
            f"{stats['pipeline_depth']}) recorded "
            f"{stats['host_syncs_between_evals']} host syncs between "
            "evals — the submit/drain overlap is broken (a device value "
            "is being fetched outside _host_fetch's eval boundary).")
    info = stats["pallas_interpret"]
    if stats["dp_path"] == "pallas":
        if info is None:
            raise AuditFailure(
                f"{label}: dp_path='pallas' but no interpret provenance "
                "was recorded — kernel_info() must be captured so a run "
                "that took the plain route on the card is visible.")
        if info["backend"] == "cuda" and info["kernel"] == "plain":
            raise AuditFailure(
                f"{label}: a CUDA run of dp_path='pallas' recorded the "
                f"plain route ({info}) — the hand-written kernel did not "
                "run.")
        if (info["backend"] == "cuda" and stats["cohorts"] > 0
                and info["launches"] <= 0):
            raise AuditFailure(
                f"{label}: {stats['cohorts']} cohorts ran on the card with "
                f"dp_path='pallas' but the kernel recorded "
                f"{info['launches']} launches ({info}).")
    # fault-ledger conservation (repro_torch.core.faults): every lost
    # upload either re-entered the heap as a retry or exhausted its budget
    # and became a lost update
    if stats["fault_upload_losses"] != (
            stats["fault_retries"] + stats["fault_lost_updates"]):
        raise AuditFailure(
            f"{label}: fault ledger imbalance — fault_upload_losses="
            f"{stats['fault_upload_losses']} must equal fault_retries="
            f"{stats['fault_retries']} + fault_lost_updates="
            f"{stats['fault_lost_updates']}.")
    # screening-ledger conservation (repro_torch.core.screening): every
    # rejection is exactly one of nonfinite / norm-reject
    if stats["screen_rejections"] != (
            stats["screen_nonfinite"] + stats["screen_norm_rejects"]):
        raise AuditFailure(
            f"{label}: screening ledger imbalance — screen_rejections="
            f"{stats['screen_rejections']} must equal screen_nonfinite="
            f"{stats['screen_nonfinite']} + screen_norm_rejects="
            f"{stats['screen_norm_rejects']}.")
    # store-ledger conservation (repro_torch.engine.statestore): every
    # slot acquisition is exactly one of hot-hit / prefetch-hit / stall
    # (all-resident runs report 0 == 0)
    if stats["store_fetches"] != (
            stats["store_hot_hits"] + stats["store_prefetch_hits"]
            + stats["store_stall_waits"]):
        raise AuditFailure(
            f"{label}: store ledger imbalance — store_fetches="
            f"{stats['store_fetches']} must equal store_hot_hits="
            f"{stats['store_hot_hits']} + store_prefetch_hits="
            f"{stats['store_prefetch_hits']} + store_stall_waits="
            f"{stats['store_stall_waits']}.")
    return stats


__all__ = ["AuditFailure", "audit_sharding", "audit_donation",
           "audit_collectives", "audit_engine_stats", "ENGINE_STATS_KEYS"]
