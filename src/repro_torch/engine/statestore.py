"""Tiered client-state store: a bounded hot device arena plus a host cold
store (port of ``repro/engine/statestore.py``; STORE.md).

The all-resident arena stacks every client's params and optimizer state
on the device, which a population of 100,000 full-width clients (about
3.8 MB each with Adam's moments) cannot fit.  The store splits client
state into two tiers:

* **hot set** — the runner's device arena, bounded to
  ``StoreConfig.hot_slots`` rows (+1 pad row).  A staged cohort gathers
  its members from hot slots exactly as the all-resident path does;
  dataset rows are addressed through their own slot map
  (:class:`DataArena`).
* **cold store** — one optimizer-state row per evicted client, held in
  pinned host memory on the card (plain host tensors on the CPU).
  Params never spill: a client's dispatch-time params are a reference to
  the globals tree it pulled (``pending_params``), so re-residency
  re-stages them as the same deferred broadcast write the all-resident
  path uses.
* **lookahead prefetcher** — the engine loops peek the virtual clock's
  event heap (O(k log N)) and stage upcoming members' slots ahead of
  their cohort; the runner copies their cold rows to the card on a side
  stream.

Residency policy: LRU over a monotonic touch tick, with the cohort (and
prefetch batch) being staged pinned via a keep-set; free slots assign in
ascending order.  Every decision is a pure function of the acquire /
prefetch call sequence, copied decision for decision from the reference,
so a tiered run is bit-identical to the all-resident one, its ``store_*``
counters equal the reference's, and checkpoint resume replays residency
exactly (``state_meta`` / ``load_state_meta``).  All methods here are
host bookkeeping: the device work (slot writes, opt-row loads, spills)
goes through the owning :class:`repro_torch.engine.engine.CohortRunner`,
and spills route through its ``_host_fetch_array`` funnel as counted
``store_sync_reads``.  No loop here walks the population: each walks a
cohort, a prefetch batch or the resident set.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from repro_torch.core.runlog import STORE_STATS_KEYS
from repro_torch.pytree import tree_leaves


def zero_store_stats() -> dict:
    """All-resident runs report every store counter as 0."""
    return {k: 0 for k in STORE_STATS_KEYS}


def _tree_nbytes(tree) -> int:
    return int(sum(l.numel() * l.element_size() for l in tree_leaves(tree)))


@dataclass(frozen=True)
class StoreConfig:
    """``hot_slots=None`` (the default) is the all-resident arena; a
    positive ``hot_slots`` bounds the device arena to that many client
    rows.  ``lookahead`` is how many upcoming event-heap completions the
    prefetcher stages ahead of their cohort (0: every miss is a counted
    demand stall)."""

    hot_slots: Optional[int] = None
    lookahead: int = 8

    def __post_init__(self):
        if self.hot_slots is not None and (
                self.hot_slots != int(self.hot_slots) or self.hot_slots < 1):
            raise ValueError(
                f"StoreConfig.hot_slots must be None (all-resident) or an "
                f"integer >= 1: {self.hot_slots!r}")
        if self.lookahead != int(self.lookahead) or self.lookahead < 0:
            raise ValueError(
                f"StoreConfig.lookahead must be an integer >= 0: "
                f"{self.lookahead!r}")


@dataclass
class DataArena:
    """The once-uploaded device dataset arena, keyed separately from
    client state: rows are deduped by dataset identity (``id(c.data)``)
    and addressed through ``slot_of_cid``, so a population sharing one
    dataset uploads one row however many clients reference it, and a
    Session sweep over client-state config reuses it across runners."""

    leaves: dict              # data key -> (n_slots, n_max, ...) tensor
    slot_of_cid: np.ndarray   # (N,) int32: cid -> data slot
    pad_slot: int             # the zero row after the distinct datasets
    n_slots: int              # pad_slot + 1
    n_max: int                # longest client dataset (short rows zero-pad)
    nbytes: int               # host bytes uploaded

    @classmethod
    def build(cls, clients, device) -> "DataArena":
        """Upload every distinct dataset once (slot = order of first
        encounter: the slot-per-cid layout when no clients share data),
        zero-padding short datasets; labels go up as int64."""
        reps, rep_slot = [], {}
        slot_of_cid = np.empty((len(clients),), np.int32)
        for c in clients:
            s = rep_slot.get(id(c.data))
            if s is None:
                s = len(reps)
                rep_slot[id(c.data)] = s
                reps.append(c.data)
            slot_of_cid[c.cid] = s
        pad_slot = len(reps)
        n_slots = pad_slot + 1
        n_max = max(c.n_train for c in clients)
        leaves, nbytes = {}, 0
        for k, v0 in clients[0].data.items():
            buf = np.zeros((n_slots, n_max) + v0.shape[1:], v0.dtype)
            for s, data in enumerate(reps):
                buf[s, : data[k].shape[0]] = data[k]
            nbytes += buf.nbytes
            t = torch.from_numpy(buf).to(device)
            leaves[k] = t.long() if k == "y" else t
        return cls(leaves=leaves, slot_of_cid=slot_of_cid, pad_slot=pad_slot,
                   n_slots=n_slots, n_max=n_max, nbytes=int(nbytes))

    def rows_of(self, cid: int) -> dict:
        """Client ``cid``'s dataset row (the legacy loop's view)."""
        s = int(self.slot_of_cid[cid])
        return {k: v[s] for k, v in self.leaves.items()}


@dataclass
class TieredStateStore:
    """Residency manager for the bounded hot arena (module docstring).

    Owns the cid<->slot maps, the LRU clock, the dirty set and the cold
    rows; the runner owns the device tensors."""

    cfg: StoreConfig
    n_clients: int
    runner: object

    def __post_init__(self):
        self.hot_slots = int(self.cfg.hot_slots)
        self.lookahead = int(self.cfg.lookahead)
        self.slot_of = {}         # cid -> hot slot (resident clients)
        self.cid_of = {}          # hot slot -> cid
        # free slots pop() in ascending order: deterministic assignment
        self.free = list(range(self.hot_slots - 1, -1, -1))
        self.seq = {}             # cid -> last-touch tick (LRU order)
        self.tick = 0
        self.dirty = set()        # resident cids whose hot opt row trained
        self.prefetched = set()   # resident via prefetch, not yet acquired
        self.cold = {}            # cid -> host opt-row tree
        self.pending_params = {}  # cid -> dispatch-time globals (by ref)
        self.fetches = 0
        self.hot_hits = 0
        self.prefetch_hits = 0
        self.stall_waits = 0
        self.evictions = 0
        self.spill_bytes = 0
        self.sync_reads = 0

    # -- dispatch/train bookkeeping ---------------------------------------
    def note_dispatch(self, cid: int, params_tree):
        """Remember which params tree the client pulled (a reference); the
        deferred broadcast write happens at acquire / prefetch time,
        against whatever slot the client then holds."""
        self.pending_params[cid] = params_tree

    def note_trained(self, cids):
        """A submitted cohort's members are dirty: their hot opt rows now
        differ from any cold copy, so eviction must spill them (dropped
        and screened members trained too)."""
        self.dirty.update(cids)

    # -- residency ---------------------------------------------------------
    def acquire_cohort(self, cids) -> list:
        """The hot slot of every member of the cohort being staged,
        faulting in misses (counted ``store_stall_waits``) and classifying
        hits by whether the prefetcher staged them.  The whole cohort is
        pinned while slots are grabbed."""
        keep = set(cids)
        loads, slots = [], []
        for cid in cids:
            self.tick += 1
            self.fetches += 1
            slot = self.slot_of.get(cid)
            if slot is not None:
                if cid in self.prefetched:
                    self.prefetched.discard(cid)
                    self.prefetch_hits += 1
                    # the prefetch already queued this cid's params write
                else:
                    self.hot_hits += 1
                    self.runner._queue_write(slot, self.pending_params[cid])
            else:
                self.stall_waits += 1
                slot = self._grab_slot(keep)
                self._assign(cid, slot)
                self.runner._queue_write(slot, self.pending_params[cid])
                loads.append((cid, slot))
            self.seq[cid] = self.tick
            slots.append(slot)
        self._load_slots(loads)
        return slots

    def prefetch_cids(self, cids):
        """Stage upcoming members' slots ahead of their cohort.  Callers
        pass only cids whose current dispatch is still pending.  A soft
        grab that finds every resident row pinned stops prefetching
        instead of deadlocking."""
        targets = [c for c in cids
                   if c not in self.slot_of and c in self.pending_params]
        if not targets:
            return
        keep = set(cids) | self.prefetched
        loads = []
        for cid in targets:
            slot = self._grab_slot(keep, soft=True)
            if slot is None:
                break
            self.tick += 1
            self._assign(cid, slot)
            self.seq[cid] = self.tick
            self.prefetched.add(cid)
            keep.add(cid)
            self.runner._queue_write(slot, self.pending_params[cid])
            loads.append((cid, slot))
        self._load_slots(loads)

    def _assign(self, cid: int, slot: int):
        self.slot_of[cid] = slot
        self.cid_of[slot] = cid

    def _grab_slot(self, keep, soft: bool = False):
        """One free (ascending) or LRU-evicted hot slot; ``keep`` pins the
        cohort/prefetch batch being staged.  The victim is the strict
        minimum of the touch ticks (unique by construction)."""
        if self.free:
            return self.free.pop()
        victim, vseq = None, None
        for cid in self.slot_of:
            if cid in keep:
                continue
            sq = self.seq[cid]
            if vseq is None or sq < vseq:
                victim, vseq = cid, sq
        if victim is None:
            if soft:
                return None
            raise RuntimeError(
                f"TieredStateStore deadlock: all {self.hot_slots} hot slots "
                f"are pinned by the cohort being staged ({len(keep)} "
                "members) — raise StoreConfig.hot_slots above "
                "EngineConfig.max_cohort")
        return self._evict(victim)

    def _evict(self, cid: int) -> int:
        """Surrender ``cid``'s hot slot.  Dirty rows spill device->host
        through the runner; clean rows free at once (their cold copy, or
        the value-independent fresh ``opt.init``, reproduces them)."""
        slot = self.slot_of.pop(cid)
        del self.cid_of[slot]
        self.seq.pop(cid, None)
        self.prefetched.discard(cid)
        self.runner._cancel_writes(slot)
        self.evictions += 1
        if cid in self.dirty:
            self.dirty.discard(cid)
            row = self.runner.spill_opt_slot(slot)
            self.cold[cid] = row
            self.spill_bytes += _tree_nbytes(row)
        return slot

    def _load_slots(self, loads):
        """Materialize freshly assigned slots' optimizer rows: cold rows
        go up as one stacked copy; never-spilled rows re-init on the
        device (bitwise the all-resident arena's untrained state)."""
        if not loads:
            return
        cold_pairs = [(c, s) for c, s in loads if c in self.cold]
        fresh_pairs = [(c, s) for c, s in loads if c not in self.cold]
        if fresh_pairs:
            self.runner.init_opt_rows(
                self.pending_params[fresh_pairs[0][0]],
                [s for _, s in fresh_pairs])
        if cold_pairs:
            self.runner.load_opt_rows(
                [self.cold[c] for c, _ in cold_pairs],
                [s for _, s in cold_pairs])

    # -- stats / checkpoint state -----------------------------------------
    def stats(self) -> dict:
        return {
            "store_fetches": int(self.fetches),
            "store_hot_hits": int(self.hot_hits),
            "store_prefetch_hits": int(self.prefetch_hits),
            "store_stall_waits": int(self.stall_waits),
            "store_evictions": int(self.evictions),
            "store_spill_bytes": int(self.spill_bytes),
            "store_sync_reads": int(self.sync_reads),
        }

    def state_meta(self) -> dict:
        """Residency, LRU and counter state as a JSON-able dict (the cold
        rows and pending params trees travel as checkpoint arrays)."""
        return {
            "slot_of": {str(c): int(s) for c, s in self.slot_of.items()},
            "free": [int(s) for s in self.free],
            "seq": {str(c): int(t) for c, t in self.seq.items()},
            "tick": int(self.tick),
            "dirty": sorted(int(c) for c in self.dirty),
            "prefetched": sorted(int(c) for c in self.prefetched),
            "counters": self.stats(),
        }

    def load_state_meta(self, meta: dict):
        self.slot_of = {int(c): int(s) for c, s in meta["slot_of"].items()}
        self.cid_of = {s: c for c, s in self.slot_of.items()}
        self.free = [int(s) for s in meta["free"]]
        self.seq = {int(c): int(t) for c, t in meta["seq"].items()}
        self.tick = int(meta["tick"])
        self.dirty = set(int(c) for c in meta["dirty"])
        self.prefetched = set(int(c) for c in meta["prefetched"])
        c = meta["counters"]
        self.fetches = int(c["store_fetches"])
        self.hot_hits = int(c["store_hot_hits"])
        self.prefetch_hits = int(c["store_prefetch_hits"])
        self.stall_waits = int(c["store_stall_waits"])
        self.evictions = int(c["store_evictions"])
        self.spill_bytes = int(c["store_spill_bytes"])
        self.sync_reads = int(c["store_sync_reads"])


__all__ = ["DataArena", "StoreConfig", "TieredStateStore",
           "zero_store_stats", "STORE_STATS_KEYS"]
