"""Deterministic fault injection for the FL testbed (port of
``repro/core/faults.py``; pure numpy, copied so the port never imports
the reference, and held to it draw for draw by
``tests/test_torch_faults.py``).  See RESILIENCE.md.

* :class:`FaultModel` — a frozen, spec-serializable description of the
  failure distribution, carried on ``TestbedConfig.faults`` and
  registered in the :mod:`repro_torch.api.spec` codec.
* :class:`FaultInjector` — the seeded runtime that draws fault outcomes.
  Every fault is an event in virtual time (a re-entry into the event
  heap, a zero-weight mask slot in the cohort merge), so the cohort step
  is the same program with or without faults.

Determinism contract
--------------------
Every client owns an independent ``np.random.Generator`` seeded from
``(model.seed, cid)``; draws happen in a FIXED per-delivery order
(failure -> upload loss/retry -> late -> duplicate -> corruption, then a
leave draw at each re-dispatch).  Both execution backends (the legacy
per-client loop and the cohort engine at ``staleness_window=0``) call the
injector at the same logical points, so the same seed and FaultModel
replay the same ``RunLog.fault_events`` on both.

Fault semantics (one delivery attempt, at virtual time ``t``):

1. **duplicate arrival** — a ghost event scheduled by an earlier
   delivery; dropped at the server (counted, never merged).
2. **mid-round failure** (``failure_prob``, first attempt only) — the
   update is discarded (a zero-weight mask slot in its cohort); privacy
   was already charged at dispatch; the client re-dispatches.
3. **upload loss** (``upload_loss_prob``, drawn per attempt) — up to
   ``max_retries`` re-entries at ``t + retry_backoff_s``, then lost.
4. **late delivery** (``late_prob``, once per update) — arrives
   ``late_delay_s`` later (extra staleness under async merging).
5. **duplicate delivery** (``duplicate_prob``) — a second copy
   ``duplicate_delay_s`` later, deduped at the server (see 1).
6. **leave/rejoin churn** (``leave_prob``, at each re-dispatch) — the
   client's next local round starts ``rejoin_delay_s`` late.
7. **transit corruption** (``corrupt_prob``, drawn LAST and only on
   deliveries that reach the server) — the payload arrives all-NaN
   (probability ``corrupt_nan_frac``) or with its update delta scaled by
   ``corrupt_scale``; :mod:`repro_torch.core.screening` is the defence.

FedAvg rounds additionally honour ``round_deadline_s`` + ``min_quorum``
(:func:`apply_deadline`).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

# The fault counters appended to repro_torch.core.runlog.ENGINE_STATS_KEYS —
# defined here (next to the code that increments them) and imported by
# the runlog schema so the two cannot drift independently.
FAULT_STATS_KEYS = (
    "fault_failures",            # mid-round crashes (update discarded)
    "fault_upload_losses",       # upload attempts lost in transit
    "fault_retries",             # backoff re-entries into the event heap
    "fault_lost_updates",        # updates dropped after exhausting retries
    "fault_duplicates_dropped",  # duplicate arrivals deduped at the server
    "fault_late_deliveries",     # deliveries delayed past completion
    "fault_churn_leaves",        # leave/rejoin cycles at re-dispatch
    "fault_corruptions",         # delivered payloads corrupted in transit
    "degraded_cohorts",          # cohorts/rounds merged below full strength
    "deadline_drops",            # fedavg members dropped at the deadline
)


def zero_fault_stats() -> dict:
    """The fault counters of a fault-free run (every engine run reports
    them so the stats schema is unconditional)."""
    return {k: 0 for k in FAULT_STATS_KEYS}


@dataclass(frozen=True)
class FaultModel:
    """Spec-serializable failure distribution (see module docstring for
    the per-fault semantics).  All fields are JSON scalars; validation
    happens at construction so a bad model never reaches a run."""

    seed: int = 0                  # fault RNG seed (independent of the
                                   # testbed seed: the same scenario can
                                   # replay under different fault draws)
    failure_prob: float = 0.0      # P(mid-round crash) per update
    upload_loss_prob: float = 0.0  # P(upload lost) per delivery attempt
    max_retries: int = 2           # bounded retries after an upload loss
    retry_backoff_s: float = 5.0   # virtual-time backoff between retries
    duplicate_prob: float = 0.0    # P(second copy delivered) per update
    duplicate_delay_s: float = 1.0
    late_prob: float = 0.0         # P(delivery arrives late) per update
    late_delay_s: float = 30.0
    leave_prob: float = 0.0        # P(leave) drawn at each re-dispatch
    rejoin_delay_s: float = 120.0
    # transit corruption of DELIVERED payloads (drawn last, only on
    # updates that actually reach the server): with probability
    # ``corrupt_nan_frac`` the payload arrives as all-NaN, otherwise the
    # update delta is blown up by ``corrupt_scale`` (a gradient-scaling
    # attack / bit-rot model).  The screening layer
    # (repro_torch.core.screening) is the defense.
    corrupt_prob: float = 0.0      # P(payload corrupted) per delivery
    corrupt_nan_frac: float = 0.5  # NaN payload vs scale blowup split
    corrupt_scale: float = 1e6     # delta multiplier for blowup corruption
    # fedavg-only graceful degradation: stop waiting for dead/slow
    # members at the deadline, but never aggregate below the quorum
    round_deadline_s: Optional[float] = None
    min_quorum: int = 1

    def __post_init__(self):
        for name in ("failure_prob", "upload_loss_prob", "duplicate_prob",
                     "late_prob", "leave_prob", "corrupt_prob",
                     "corrupt_nan_frac"):
            v = getattr(self, name)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"FaultModel.{name} must be in [0, 1]: {v!r}")
        if self.seed < 0 or self.seed != int(self.seed):
            raise ValueError(
                f"FaultModel.seed must be a non-negative int: {self.seed!r}")
        if self.max_retries < 0 or self.max_retries != int(self.max_retries):
            raise ValueError(
                f"FaultModel.max_retries must be an int >= 0: "
                f"{self.max_retries!r}")
        for name in ("retry_backoff_s", "duplicate_delay_s", "late_delay_s",
                     "rejoin_delay_s"):
            if getattr(self, name) < 0:
                raise ValueError(
                    f"FaultModel.{name} must be >= 0: "
                    f"{getattr(self, name)!r}")
        # a zero re-entry delay would re-pop the same virtual instant
        # forever — virtual time must strictly advance per re-entry.
        # Exception: retry_backoff_s == 0 is legal when max_retries == 0
        # (a lost upload is dropped immediately, nothing ever re-enters
        # the heap, so virtual time cannot freeze).
        for prob, delay in (("duplicate_prob", "duplicate_delay_s"),
                            ("late_prob", "late_delay_s")):
            if getattr(self, prob) > 0 and getattr(self, delay) <= 0:
                raise ValueError(
                    f"FaultModel.{delay} must be > 0 when {prob} > 0 "
                    "(virtual time must advance between re-entries)")
        if (self.upload_loss_prob > 0 and self.retry_backoff_s <= 0
                and self.max_retries > 0):
            raise ValueError(
                "FaultModel.retry_backoff_s must be > 0 when "
                "upload_loss_prob > 0 and max_retries > 0 "
                "(virtual time must advance between re-entries)")
        if not (0 < self.corrupt_scale < float("inf")):
            raise ValueError(
                f"FaultModel.corrupt_scale must be a finite positive "
                f"float: {self.corrupt_scale!r}")
        if self.corrupt_prob > 0 and self.corrupt_scale == 1.0:
            raise ValueError(
                "FaultModel.corrupt_scale must differ from 1.0 when "
                "corrupt_prob > 0 (1.0 is the clean-payload sentinel — "
                "the corruption would be a silent no-op)")
        if self.round_deadline_s is not None and self.round_deadline_s <= 0:
            raise ValueError(
                f"FaultModel.round_deadline_s must be > 0 or None: "
                f"{self.round_deadline_s!r}")
        if self.min_quorum < 1 or self.min_quorum != int(self.min_quorum):
            raise ValueError(
                f"FaultModel.min_quorum must be an int >= 1: "
                f"{self.min_quorum!r}")


def apply_deadline(model: FaultModel, offsets) -> tuple:
    """FedAvg partial aggregation: given each member's delivery offset
    from the round start (``None`` = update already lost to a fault),
    decide who the barrier keeps.

    The server stops waiting at ``round_deadline_s``, stretched to the
    ``min_quorum``-th smallest surviving delivery time when the plain
    deadline would collect fewer than the quorum.  Returns
    ``(keep, round_time)`` — ``keep[i]`` is True for aggregated members,
    ``round_time`` is how long the round occupied the server (the
    effective deadline when it cut anyone off, else the slowest kept
    delivery; ``None`` when no update survived, in which case the caller
    falls back to the full barrier wait).

    A quorum larger than the round's LIVE client count (``len(offsets)``
    — everyone who dispatched, survivors and casualties alike) is a
    configuration error, not a degraded round: the deadline would
    stretch unboundedly waiting for a quorum that can never assemble.
    Rejected here and at :class:`FaultInjector` construction.  A quorum
    larger than the SURVIVOR count but within the live count is the
    legitimate degraded case — the clamp below keeps every survivor."""
    if int(model.min_quorum) > len(offsets):
        raise ValueError(
            f"FaultModel.min_quorum={int(model.min_quorum)} exceeds the "
            f"round's live client count ({len(offsets)}) — the deadline "
            "would stretch unboundedly waiting for a quorum that can "
            "never assemble")
    times = sorted(o for o in offsets if o is not None)
    if not times:
        return [False] * len(offsets), None
    if model.round_deadline_s is None:
        return [o is not None for o in offsets], times[-1]
    k = min(int(model.min_quorum), len(times))
    eff = max(float(model.round_deadline_s), times[k - 1])
    keep = [o is not None and o <= eff for o in offsets]
    if any(o is not None and o > eff for o in offsets):
        return keep, eff
    return keep, times[-1]


class FaultInjector:
    """Seeded runtime fault oracle shared by both execution backends.

    The loops call exactly four entry points — :meth:`on_completion`
    (async delivery attempt), :meth:`redispatch_delay` (leave/rejoin
    churn), :meth:`fedavg_fate` (a whole barrier-round delivery
    simulated inline) and :meth:`note_deadline_drop` /
    :meth:`note_degraded` (server-side bookkeeping) — and record the
    returned outcomes; the injector owns every random draw and the
    ordered ``events`` log that ``RunLog.fault_events`` exposes.  Its
    state (per-client RNG streams, retry bookkeeping, in-flight
    duplicates, counters, events) serializes via :meth:`state_dict` so a
    checkpointed run resumes mid-fault-sequence bit-identically."""

    def __init__(self, model: FaultModel, num_clients: int):
        if int(model.min_quorum) > int(num_clients):
            raise ValueError(
                f"FaultModel.min_quorum={int(model.min_quorum)} exceeds "
                f"the testbed's live client count ({int(num_clients)}) — "
                "the round deadline would stretch unboundedly waiting for "
                "a quorum that can never assemble")
        self.model = model
        self._rngs = [np.random.default_rng((int(model.seed), 0x5EED, cid))
                      for cid in range(num_clients)]
        self._attempts = [0] * num_clients   # retries used, current update
        self._late = [False] * num_clients   # late draw used, current update
        self._dups = {}                      # (t, cid) -> pending copies
        self._corrupt = {}                   # cid -> pending delivery scale
        self.counters = zero_fault_stats()
        self.events = []                     # ordered (kind, cid, t) tuples

    # -- shared draw helpers ----------------------------------------------
    def _record(self, kind: str, counter: Optional[str], cid: int, t: float):
        if counter is not None:
            self.counters[counter] += 1
        self.events.append((kind, cid, float(t)))

    def _reset_update(self, cid: int):
        self._attempts[cid] = 0
        self._late[cid] = False

    def _draw_corruption(self, cid: int, t: float):
        """Transit-corruption draw, LAST in the per-delivery order and
        only on updates that actually reach the server.  The resulting
        payload scale (NaN = all-NaN payload, ``corrupt_scale`` = delta
        blowup, 1.0 = clean) parks in a per-client pending slot until
        the loop collects it via :meth:`take_corruption`."""
        m, rng = self.model, self._rngs[cid]
        if m.corrupt_prob <= 0:
            return
        if rng.random() >= m.corrupt_prob:
            return
        if rng.random() < m.corrupt_nan_frac:
            self._corrupt[cid] = float("nan")
            self._record("corrupt_nan", "fault_corruptions", cid, t)
        else:
            self._corrupt[cid] = float(m.corrupt_scale)
            self._record("corrupt_scale", "fault_corruptions", cid, t)

    def take_corruption(self, cid: int) -> float:
        """Collect (and clear) the pending delivery's payload scale for
        ``cid`` — 1.0 when the delivery is clean.  Called exactly once
        per delivered update by both backends."""
        return self._corrupt.pop(cid, 1.0)

    # -- async loops --------------------------------------------------------
    def on_completion(self, cid: int, t: float) -> tuple:
        """Resolve one delivery attempt popped from the event heap at
        virtual time ``t``.  Returns ``(verdict, aux)``:

        * ``("duplicate", None)`` — ghost copy of an already-merged
          update; skip it (no pending plan is consumed).
        * ``("requeue", t_new)`` — not delivered yet (upload retry or
          late arrival); push ``(t_new, cid)`` back on the heap, the
          pending plan stays pending.
        * ``("drop", reason)`` — the update is lost ("failure" |
          "retries_exhausted"): consume the pending plan as a
          zero-weight member and re-dispatch the client.
        * ``("deliver", dup_t)`` — merge now; when ``dup_t`` is not
          None, push the ghost duplicate ``(dup_t, cid)`` on the heap.
        """
        key = (float(t), cid)
        pending = self._dups.get(key, 0)
        if pending:
            if pending == 1:
                del self._dups[key]
            else:
                self._dups[key] = pending - 1
            self._record("duplicate_dropped", "fault_duplicates_dropped",
                         cid, t)
            return ("duplicate", None)
        m, rng = self.model, self._rngs[cid]
        first_attempt = self._attempts[cid] == 0 and not self._late[cid]
        if (first_attempt and m.failure_prob > 0
                and rng.random() < m.failure_prob):
            self._record("failure", "fault_failures", cid, t)
            self._reset_update(cid)
            return ("drop", "failure")
        if m.upload_loss_prob > 0 and rng.random() < m.upload_loss_prob:
            self._record("upload_loss", "fault_upload_losses", cid, t)
            if self._attempts[cid] < m.max_retries:
                self._attempts[cid] += 1
                t_new = t + m.retry_backoff_s
                self._record("retry", "fault_retries", cid, t_new)
                return ("requeue", t_new)
            self._record("lost", "fault_lost_updates", cid, t)
            self._reset_update(cid)
            return ("drop", "retries_exhausted")
        if (not self._late[cid] and m.late_prob > 0
                and rng.random() < m.late_prob):
            self._late[cid] = True
            t_new = t + m.late_delay_s
            self._record("late", "fault_late_deliveries", cid, t_new)
            return ("requeue", t_new)
        dup_t = None
        if m.duplicate_prob > 0 and rng.random() < m.duplicate_prob:
            dup_t = t + m.duplicate_delay_s
            dk = (float(dup_t), cid)
            self._dups[dk] = self._dups.get(dk, 0) + 1
            self._record("duplicate_scheduled", None, cid, dup_t)
        self._draw_corruption(cid, t)
        self._reset_update(cid)
        return ("deliver", dup_t)

    def redispatch_delay(self, cid: int, t: float) -> float:
        """Leave/rejoin churn, drawn once per RE-dispatch (the initial
        t=0 dispatch never draws): the client's next local round starts
        ``rejoin_delay_s`` late when it leaves."""
        m = self.model
        if m.leave_prob > 0 and self._rngs[cid].random() < m.leave_prob:
            self._record("leave", "fault_churn_leaves", cid, t)
            return float(m.rejoin_delay_s)
        return 0.0

    # -- fedavg barrier rounds ----------------------------------------------
    def fedavg_fate(self, cid: int, t0: float, duration: float) -> tuple:
        """Simulate one barrier-round delivery inline (same draw order
        as the async path: failure -> loss/retry loop -> late ->
        duplicate).  ``t0`` is the round's start time (event timestamps
        only).  Returns ``(delivery_offset, reason)`` — the offset from
        the round start at which the update reaches the server, or
        ``(None, reason)`` when it is lost."""
        m, rng = self.model, self._rngs[cid]
        if m.failure_prob > 0 and rng.random() < m.failure_prob:
            self._record("failure", "fault_failures", cid, t0 + duration)
            return None, "failure"
        off = float(duration)
        attempts = 0
        while m.upload_loss_prob > 0 and rng.random() < m.upload_loss_prob:
            self._record("upload_loss", "fault_upload_losses", cid, t0 + off)
            if attempts < m.max_retries:
                attempts += 1
                off += m.retry_backoff_s
                self._record("retry", "fault_retries", cid, t0 + off)
                continue
            self._record("lost", "fault_lost_updates", cid, t0 + off)
            return None, "retries_exhausted"
        if m.late_prob > 0 and rng.random() < m.late_prob:
            off += m.late_delay_s
            self._record("late", "fault_late_deliveries", cid, t0 + off)
        if m.duplicate_prob > 0 and rng.random() < m.duplicate_prob:
            # the barrier dedupes instantly — both halves recorded so the
            # scheduled/dropped ledger stays balanced across modes
            dup_t = t0 + off + m.duplicate_delay_s
            self._record("duplicate_scheduled", None, cid, dup_t)
            self._record("duplicate_dropped", "fault_duplicates_dropped",
                         cid, dup_t)
        self._draw_corruption(cid, t0 + off)
        return off, None

    # -- server-side bookkeeping --------------------------------------------
    def note_deadline_drop(self, cid: int, t: float):
        self._record("deadline_drop", "deadline_drops", cid, t)

    def note_degraded(self):
        self.counters["degraded_cohorts"] += 1

    def stats(self) -> dict:
        return dict(self.counters)

    # -- checkpoint serialization -------------------------------------------
    def state_dict(self) -> dict:
        """JSON-able snapshot of the full injector state (RNG streams
        included) — restoring it resumes the fault sequence exactly
        where the checkpoint left it."""
        return {
            "rng": [r.bit_generator.state for r in self._rngs],
            "attempts": list(self._attempts),
            "late": list(self._late),
            "dups": [[t, cid, n] for (t, cid), n in self._dups.items()],
            # NaN round-trips through JSON repr as the string "nan" —
            # store scales as repr strings so the payload kind survives
            "corrupt": [[cid, repr(s)] for cid, s in self._corrupt.items()],
            "counters": dict(self.counters),
            "events": [list(e) for e in self.events],
        }

    def load_state_dict(self, state: dict):
        for r, s in zip(self._rngs, state["rng"]):
            r.bit_generator.state = s
        self._attempts = [int(a) for a in state["attempts"]]
        self._late = [bool(b) for b in state["late"]]
        self._dups = {(float(t), int(cid)): int(n)
                      for t, cid, n in state["dups"]}
        self._corrupt = {int(cid): float(s)
                         for cid, s in state.get("corrupt", [])}
        self.counters = zero_fault_stats()
        self.counters.update(state["counters"])
        self.events = [(str(k), int(cid), float(t))
                       for k, cid, t in state["events"]]


__all__ = ["FAULT_STATS_KEYS", "zero_fault_stats", "FaultModel",
           "FaultInjector", "apply_deadline"]
