"""Update screening and quarantine for corrupt-update defence (port of
``repro/core/screening.py``).

* :class:`ScreeningConfig` — a frozen, spec-serializable screening policy
  on ``TestbedConfig.screening`` (``None`` disables screening).
* per-member verdict inputs — the cohort step always computes a
  ``(finite, update_norm)`` pair per member over the float32 update delta
  (``engine/cohort_step.py::_screen_members``); thresholds compare on the
  HOST, so one built step serves screening on and off and every threshold.
  :func:`screen_update` and :func:`corrupt_update` run those in-step
  functions on one update for the legacy loops.
* :class:`ScreeningState` — the deterministic host-side runtime (copied
  from the reference): verdicts, per-client strikes, quarantine after
  ``quarantine_after`` strikes, re-admission after ``readmit_delay_s``
  virtual seconds.  A rejected member keeps its cohort slot and merges
  with coefficient exactly 0.0.

Screening draws no randomness: verdicts are functions of the update
payloads and the delivery times, and both backends call
:meth:`ScreeningState.screen` in the same ``(time, cid)`` order.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.pytree import tree_leaves

# The screening counters appended to repro_torch.core.runlog.ENGINE_STATS_KEYS
# (all zero when screening is off, so the stats schema stays
# unconditional).  Ledger law, checked by
# chip_smoke.py [robust] and tests/test_torch_screening.py:
#
#     screen_rejections == screen_nonfinite + screen_norm_rejects
#
# Quarantine drops are counted separately (a suspended client's delivery
# is dropped BEFORE its verdict is consulted, so it is not a rejection).
SCREEN_STATS_KEYS = (
    "screen_rejections",        # in-step verdict rejections (sum of next two)
    "screen_nonfinite",         # rejected: NaN/Inf anywhere in the update
    "screen_norm_rejects",      # rejected: update norm above max_update_norm
    "screen_quarantined",       # suspension events (quarantine_after strikes)
    "screen_quarantine_drops",  # deliveries dropped while suspended
    "screen_verdict_syncs",     # sanctioned device->host verdict fetches
)


def zero_screen_stats() -> dict:
    """The screening counters of a screening-off run."""
    return {k: 0 for k in SCREEN_STATS_KEYS}


@dataclass(frozen=True)
class ScreeningConfig:
    """Spec-serializable update-screening policy (see module docstring).

    All fields are JSON scalars; validation happens at construction so a
    bad policy never reaches a run.  The finite check is unconditional
    once screening is on; ``max_update_norm=None`` disables only the
    norm threshold, ``quarantine_after=0`` disables quarantine."""

    max_update_norm: Optional[float] = None  # L2 reject threshold on the
                                             # float32 update delta; None
                                             # = finite-check only
    quarantine_after: int = 0                # strikes before suspension;
                                             # 0 = quarantine off
    readmit_delay_s: float = 600.0           # virtual-time suspension length

    def __post_init__(self):
        if self.max_update_norm is not None and not self.max_update_norm > 0:
            raise ValueError(
                f"ScreeningConfig.max_update_norm must be > 0 or None: "
                f"{self.max_update_norm!r}")
        if (self.quarantine_after < 0
                or self.quarantine_after != int(self.quarantine_after)):
            raise ValueError(
                f"ScreeningConfig.quarantine_after must be an int >= 0: "
                f"{self.quarantine_after!r}")
        if self.quarantine_after > 0 and not self.readmit_delay_s > 0:
            raise ValueError(
                f"ScreeningConfig.readmit_delay_s must be > 0 when "
                f"quarantine is on: {self.readmit_delay_s!r}")


def screen_update(params_ref, params_k) -> tuple:
    """The cohort step's per-member screen pass (``_screen_members``) for
    ONE update: the ``(finite, norm)`` verdict inputs over the float32
    delta ``params_k - params_ref``, so both backends share one
    implementation."""
    from repro_torch.engine.cohort_step import _screen_members, stack_trees
    finite, norm = _screen_members(stack_trees([params_ref]),
                                   stack_trees([params_k]))
    return bool(finite[0]), float(norm[0])


def corrupt_update(params_ref, params_k, scale: float):
    """The cohort step's transit corruption (``_corrupt_members``) for ONE
    update: the delivered payload becomes ``p0 + scale * (p - p0)`` in
    float32.  The client keeps its honestly trained params; only the
    upload is corrupted.  ``scale == 1.0`` is the clean sentinel and
    returns ``params_k`` itself."""
    if scale == 1.0:
        return params_k
    from repro_torch.engine.cohort_step import (
        _corrupt_members, stack_trees, unstack_tree)
    dev = tree_leaves(params_k)[0].device
    s = torch.tensor([scale], dtype=torch.float32, device=dev)
    return unstack_tree(_corrupt_members(stack_trees([params_ref]),
                                         stack_trees([params_k]), s), 0)


class ScreeningState:
    """Deterministic host-side screening runtime shared by both
    execution backends.  The loops call exactly one entry point per
    delivered update — :meth:`screen` — in ``(time, cid)`` delivery
    order; the state owns the strike/suspension bookkeeping, the
    counters behind :data:`SCREEN_STATS_KEYS` (minus the runner-owned
    ``screen_verdict_syncs``) and an ordered ``events`` ledger appended
    to ``RunLog.fault_events``.  Serializes via :meth:`state_dict` so a
    checkpointed run resumes mid-quarantine bit-identically."""

    def __init__(self, cfg: ScreeningConfig, num_clients: int):
        self.cfg = cfg
        self._strikes = [0] * num_clients
        self._suspended_until = [None] * num_clients
        self.counters = {k: 0 for k in SCREEN_STATS_KEYS
                         if k != "screen_verdict_syncs"}
        self.events = []    # ordered (kind, cid, t) tuples

    def _record(self, kind: str, counter: Optional[str], cid: int, t: float):
        if counter is not None:
            self.counters[counter] += 1
        self.events.append((kind, cid, float(t)))

    def screen(self, cid: int, t: float, finite, norm) -> bool:
        """Resolve one delivered update at virtual time ``t``; returns
        True when the update may merge.  Order: quarantine gate first
        (a suspended client's delivery drops WITHOUT consulting the
        verdict), then the finite/norm verdict, then strike/quarantine
        bookkeeping on a rejection."""
        su = self._suspended_until[cid]
        if su is not None:
            if t < su:
                self._record("quarantine_drop", "screen_quarantine_drops",
                             cid, t)
                return False
            self._suspended_until[cid] = None
            self._record("readmit", None, cid, t)
        finite, norm = bool(finite), float(norm)
        ok = finite and (self.cfg.max_update_norm is None
                         or norm <= float(self.cfg.max_update_norm))
        if ok:
            return True
        self.counters["screen_rejections"] += 1
        self._record("screen_nonfinite" if not finite else "screen_norm",
                     "screen_nonfinite" if not finite else
                     "screen_norm_rejects", cid, t)
        if self.cfg.quarantine_after > 0:
            self._strikes[cid] += 1
            if self._strikes[cid] >= self.cfg.quarantine_after:
                self._strikes[cid] = 0
                self._suspended_until[cid] = t + float(self.cfg.readmit_delay_s)
                self._record("quarantine", "screen_quarantined", cid, t)
        return False

    def stats(self) -> dict:
        return dict(self.counters)

    # -- checkpoint serialization -------------------------------------------
    def state_dict(self) -> dict:
        """JSON-able snapshot of strikes, suspensions, counters and the
        event ledger — restoring it resumes quarantine bookkeeping
        exactly where the checkpoint left it."""
        return {
            "strikes": list(self._strikes),
            "suspended_until": [None if s is None else float(s)
                                for s in self._suspended_until],
            "counters": dict(self.counters),
            "events": [list(e) for e in self.events],
        }

    def load_state_dict(self, state: dict):
        self._strikes = [int(s) for s in state["strikes"]]
        self._suspended_until = [None if s is None else float(s)
                                 for s in state["suspended_until"]]
        self.counters = {k: 0 for k in SCREEN_STATS_KEYS
                         if k != "screen_verdict_syncs"}
        self.counters.update(state["counters"])
        self.events = [(str(k), int(cid), float(t))
                       for k, cid, t in state["events"]]


__all__ = ["SCREEN_STATS_KEYS", "zero_screen_stats", "ScreeningConfig",
           "ScreeningState", "screen_update", "corrupt_update"]
