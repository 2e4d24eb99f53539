"""Crash-resilient engine runs: snapshot / restore for the cohort loops
(port of ``repro/engine/resilience.py``; RESILIENCE.md).

The engine loops call :func:`save_fedavg` / :func:`save_async` at
loop-consistent points — the end of a barrier round, the end of one
event-loop body after re-dispatch — and :func:`restore_fedavg` /
:func:`restore_async` on ``resume_from``.  A snapshot captures every
input the remaining iterations read:

* the server globals and the run's numpy dispatch-seed stream (its
  ``bit_generator.state``, in the JSON meta) in place of the reference's
  JAX key chain.  DP noise depends only on (dispatch seed, local step),
  so no ``torch.Generator`` state is saved;
* the client-state arena (params + optimizer state, with the queued
  dispatch writes flushed first — a bitwise no-op);
* on tiered runs (``StoreConfig.hot_slots``) the whole
  :class:`~repro_torch.engine.statestore.TieredStateStore` state:
  residency maps, LRU ticks, dirty/prefetched sets, the cold rows and
  the pending dispatch-params trees (deduped by identity, so clients
  that pulled one globals version restore sharing one tree);
* every pending :class:`~repro_torch.engine.cohort.LocalRoundPlan`
  (its batch plan when drawn, dispatch seed, duration, epsilon, pulled
  version) and the event heap, ghost duplicate entries included;
* per-client host state: the numpy RNG streams (batch permutations and
  the virtual clock), dropout counters, update counts, accountant
  moments, personal subtrees;
* the RunLog so far, the ``FaultInjector`` and ``ScreeningState`` state
  and the runner's counters (the ``dp_clip`` launches of the run so far
  included, so a resumed run reports the uninterrupted run's stats).

Restoring replays the rest of the run bit-identically.  Not captured: the
dataset arena and the cohort step (pure functions of the config), the
epsilon-schedule memo, and the pipelined driver's in-flight window,
which refills within ``pipeline_depth`` cohorts: on the resume of a
pipelined run only that window, never a logged value, differs, and
``drain_waits`` is approximate.  A snapshot reads the device state to
the host; like the reference it counts no host sync.

Storage is the durable flat-npz store of :mod:`repro_torch.checkpoint`
(atomic publish, ``keep_last`` retention, escaped tree-path keys).

On a mesh every rank builds the snapshot (the state is the same on
every rank), rank 0 of the process group writes it (one writer, however
many model ranks each data coordinate has), and all ranks of the group
wait at a barrier before going on, so each rank restores from the same
file.  A resume at another data-axis size works: the arenas' rows beyond
the pad row, which the mesh's rounding adds, carry nothing, and are cut
or added on restore.
"""
from __future__ import annotations

import heapq
import os
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from repro_torch.checkpoint import checkpoint as _ckpt
from repro_torch.checkpoint.checkpoint import _escape, _path_key, to_numpy
from repro_torch.engine.cohort import LocalRoundPlan
from repro_torch.launch.mesh import is_writer
from repro_torch.pytree import tree_flatten_with_path, tree_unflatten_like

_RUNNER_COUNTERS = ("cohorts_run", "h2d_bytes_total", "host_syncs_at_eval",
                    "host_syncs_between_evals", "blocking_submits",
                    "drain_waits", "screen_verdict_syncs")
_RUNLOG_FIELDS = ("times", "global_acc", "server_version", "update_counts",
                  "influence", "staleness", "eps_trajectory", "local_acc",
                  "cohort_sizes")


class SimulatedCrash(RuntimeError):
    """Raised by :class:`CheckpointPolicy` after ``crash_after_saves``
    snapshots: a deterministic abort at a published checkpoint."""


@dataclass
class CheckpointPolicy:
    """When and where the engine loops snapshot.

    ``every`` counts the loop's progress unit — barrier rounds for
    FedAvg, merged updates for async.  ``keep_last`` bounds on-disk
    retention.  ``crash_after_saves=N`` raises :class:`SimulatedCrash`
    right after the N-th successful save of this policy object."""

    directory: str
    every: int = 10
    keep_last: int = 3
    crash_after_saves: Optional[int] = None
    saves: int = field(default=0, init=False)
    _next: int = field(default=0, init=False, repr=False)

    def __post_init__(self):
        if self.every < 1 or self.every != int(self.every):
            raise ValueError(
                f"CheckpointPolicy.every must be an int >= 1: {self.every!r}")
        if self.keep_last < 1:
            raise ValueError(
                f"CheckpointPolicy.keep_last must be >= 1: {self.keep_last!r}")
        self._next = self.every

    def due(self, step: int) -> bool:
        return step >= self._next

    def mark(self, step: int):
        """Advance the cadence past ``step`` (after a save, and on resume
        so the first snapshot after it lands on the next multiple)."""
        self._next = (int(step) // self.every + 1) * self.every

    def _publish(self, step: int, tree: dict, meta: dict,
                 on_ranks: bool = False) -> str:
        """Write the snapshot (``on_ranks``, a mesh over a process group:
        rank 0 of the group writes and every rank waits for it)."""
        if not on_ranks or is_writer():
            path = _ckpt.save(self.directory, step, tree, meta,
                              keep_last=self.keep_last)
        if on_ranks:
            from repro_torch.launch.collectives import barrier
            barrier(torch.distributed.group.WORLD)
            path = os.path.join(self.directory, f"step_{int(step):08d}.npz")
        self.mark(step)
        self.saves += 1
        if (self.crash_after_saves is not None
                and self.saves >= self.crash_after_saves):
            raise SimulatedCrash(
                f"simulated crash after checkpoint #{self.saves} "
                f"(step {step}, {path})")
        return path


# ---------------------------------------------------------------------------
# flat-tree helpers (the store's escaped keys)
# ---------------------------------------------------------------------------

def _add_tree(flat: dict, prefix: str, tree):
    """Flatten ``tree`` into ``flat`` under ``prefix``."""
    for path, leaf in tree_flatten_with_path(tree):
        key = f"{prefix}/{_path_key(path)}" if path else prefix
        if key in flat:
            raise ValueError(f"snapshot key collision: {key!r}")
        flat[key] = to_numpy(leaf)


def _fetch(flat: dict, key: str):
    """Read one snapshot array back.  The snapshot hands the store an
    already-flat dict, which escapes each joined key once more as one
    path component; reads apply the same escape."""
    return flat[_escape(key)]


def _get_tree(flat: dict, prefix: str, template, device=None,
              pin: bool = False):
    """Rebuild a tree shaped like ``template`` from snapshot arrays: each
    leaf on ``device`` (the template leaf's when None) with the template
    leaf's dtype; ``pin`` puts host leaves in pinned memory."""
    out = []
    for path, leaf in tree_flatten_with_path(template):
        key = f"{prefix}/{_path_key(path)}" if path else prefix
        t = torch.from_numpy(np.array(_fetch(flat, key)))
        dev = leaf.device if device is None else torch.device(device)
        t = t.to(device=dev, dtype=leaf.dtype)
        if pin and dev.type == "cpu":
            t = t.pin_memory()
        out.append(t)
    return tree_unflatten_like(template, out)


# ---------------------------------------------------------------------------
# snapshot assembly (shared by the FedAvg / async save paths)
# ---------------------------------------------------------------------------

def _require_arena(runner):
    if not runner.use_arena:
        raise ValueError(
            "checkpoint/resume requires the device-arena data path "
            "(EngineConfig.device_arena=True with pytree-rule shardings) — "
            "the host path keeps per-client optimizer trees outside the "
            "snapshot's reach")


def _snapshot_common(runner, clients, log, injector, global_params, rng,
                     pending: dict):
    """Build the (arrays, meta) pair every loop kind shares."""
    from repro_torch.kernels.dp_clip import dp_clip
    _require_arena(runner)
    runner._flush_writes()      # queued dispatch writes land in the arena
    flat = {}
    _add_tree(flat, "globals", global_params)
    if runner._arena_params is not None:
        _add_tree(flat, "arena_params", runner._arena_params)
        _add_tree(flat, "arena_opt", runner._arena_opt)
    cmeta = {}
    for c in clients:
        cmeta[str(c.cid)] = {
            "rng": c.rng.bit_generator.state,
            "clock_rng": c.clock.rng.bit_generator.state,
            "clock_dropouts": int(c.clock.dropouts),
            "update_count": int(c.update_count),
            "model_version": int(c.model_version),
            "acct_steps": int(c.accountant.steps),
            "has_personal": c._personal is not None,
        }
        flat[f"acct_mu/{c.cid}"] = np.asarray(c.accountant._mu)
        if c._personal is not None:
            _add_tree(flat, f"personal/{c.cid}", c._personal)
    pmeta = {}
    for cid, p in pending.items():
        pmeta[str(cid)] = {
            "n_steps": int(p.n_steps),
            "duration": float(p.duration),
            "epsilon": float(p.epsilon),
            "model_version": int(p.model_version),
            "has_personal": p.personal_snapshot is not None,
            # a plan not staged yet has no indices: the saved client RNG
            # stream still owes those draws, and resume makes them
            "materialized": p.batch_idx is not None,
        }
        if p.batch_idx is not None:
            flat[f"plan_batch_idx/{cid}"] = np.asarray(p.batch_idx)
        flat[f"plan_key/{cid}"] = np.asarray(p.key, np.int64)
        if p.personal_snapshot is not None:
            _add_tree(flat, f"plan_personal/{cid}", p.personal_snapshot)
    counters = {k: int(getattr(runner, k)) for k in _RUNNER_COUNTERS}
    counters["kernel_launches"] = int(dp_clip.launches() - runner._launches0)
    meta = {
        "strategy": log.strategy,
        "num_clients": len(clients),
        "has_arena": runner._arena_params is not None,
        "dispatch_rng": rng.bit_generator.state,
        "clients": cmeta,
        "pending": pmeta,
        "runlog": {f: getattr(log, f) for f in _RUNLOG_FIELDS},
        "fault_events": [list(e) for e in log.fault_events],
        "injector": injector.state_dict() if injector is not None else None,
        "screening": (runner.screening.state_dict()
                      if runner.screening is not None else None),
        "runner": counters,
        "store": {"hot_slots": runner.cfg.store.hot_slots,
                  "lookahead": int(runner.cfg.store.lookahead)},
    }
    if runner.store is not None:
        store = runner.store
        ss = store.state_meta()
        # pending dispatch params are globals-tree references: dedupe by
        # identity so the restored store shares one tree per pulled
        # version, as the live one does
        pp_map, tree_ids = {}, {}
        for cid in pending:
            tree = store.pending_params[cid]
            idx = tree_ids.get(id(tree))
            if idx is None:
                idx = len(tree_ids)
                tree_ids[id(tree)] = idx
                _add_tree(flat, f"store_params/{idx}", tree)
            pp_map[str(cid)] = idx
        ss["pp_map"] = pp_map
        ss["n_param_trees"] = len(tree_ids)
        for cid in sorted(store.cold):
            _add_tree(flat, f"store_cold/{cid}", store.cold[cid])
        meta["store_state"] = ss
        meta["store_cold"] = sorted(int(c) for c in store.cold)
    return flat, meta


def _fit_rows(tree, rows: int):
    """Arena leaves cut or extended (repeating the last row) to ``rows``:
    a snapshot from a mesh of another data-axis size rounds the arena to
    another multiple; rows past the pad row are never gathered."""
    from repro_torch.pytree import tree_map

    def fit(l):
        n = l.shape[0]
        if n >= rows:
            return l[:rows].contiguous()
        return torch.cat([l, l[-1:].expand((rows - n,) + tuple(l.shape[1:]))])

    return tree_map(fit, tree)


def _restore_common(flat, meta, runner, clients, log, injector,
                    global_params, rng):
    """Inverse of :func:`_snapshot_common`; returns the globals and sets
    ``rng`` to the saved dispatch-seed stream."""
    from repro_torch.kernels.dp_clip import dp_clip
    _require_arena(runner)
    if meta["strategy"] != log.strategy:
        raise ValueError(
            f"checkpoint was taken under strategy {meta['strategy']!r}, "
            f"cannot resume a {log.strategy!r} run from it")
    if meta["num_clients"] != len(clients):
        raise ValueError(
            f"checkpoint has {meta['num_clients']} clients, the resuming "
            f"testbed has {len(clients)}")
    cur_store = {"hot_slots": runner.cfg.store.hot_slots,
                 "lookahead": int(runner.cfg.store.lookahead)}
    saved_store = meta["store"]
    if saved_store != cur_store:
        raise ValueError(
            f"StoreConfig mismatch: the checkpoint was taken with "
            f"{saved_store}, the resuming run has {cur_store} — hot-slot "
            "count and lookahead fix the arena shapes and the "
            "prefetch/eviction schedule, so resuming across them cannot "
            "replay bit-identically; rerun with the original StoreConfig")
    if (injector is None) != (meta["injector"] is None):
        raise ValueError(
            "fault configuration mismatch: the checkpointed run and the "
            "resuming run must both carry the same FaultModel (or neither)")
    saved_screening = meta.get("screening")
    if (runner.screening is None) != (saved_screening is None):
        raise ValueError(
            "screening configuration mismatch: the checkpointed run and "
            "the resuming run must both carry a ScreeningConfig (or "
            "neither) — quarantine strike/suspension state cannot be "
            "invented or discarded mid-run")
    globals_ = _get_tree(flat, "globals", global_params)
    rng.bit_generator.state = meta["dispatch_rng"]
    if meta["has_arena"]:
        runner._ensure_state_arenas(globals_)
        rows = runner.arena_slots
        runner._arena_params = _fit_rows(_get_tree(
            flat, "arena_params", runner._arena_params), rows)
        runner._arena_opt = _fit_rows(
            _get_tree(flat, "arena_opt", runner._arena_opt), rows)
    if runner.store is not None:
        ss = meta["store_state"]
        runner.store.load_state_meta(ss)
        # cold rows share the arena-opt tree structure (not its shapes):
        # host tensors, pinned on the card
        row_tmpl = runner.clients[0].opt.init(globals_)
        pin = runner.device.type == "cuda"
        runner.store.cold = {
            int(c): _get_tree(flat, f"store_cold/{c}", row_tmpl,
                              device="cpu", pin=pin)
            for c in meta["store_cold"]}
        ptrees = [_get_tree(flat, f"store_params/{i}", globals_)
                  for i in range(int(ss["n_param_trees"]))]
        runner.store.pending_params = {
            int(c): ptrees[i] for c, i in ss["pp_map"].items()}
    for c in clients:
        cm = meta["clients"][str(c.cid)]
        c.rng.bit_generator.state = cm["rng"]
        c.clock.rng.bit_generator.state = cm["clock_rng"]
        c.clock.dropouts = int(cm["clock_dropouts"])
        c.update_count = int(cm["update_count"])
        c.model_version = int(cm["model_version"])
        c.accountant.steps = int(cm["acct_steps"])
        c.accountant._mu = np.array(
            _fetch(flat, f"acct_mu/{c.cid}"), np.float64)
        if cm["has_personal"]:
            tmpl = {k: globals_[k] for k in c.personal_keys}
            c._personal = _get_tree(flat, f"personal/{c.cid}", tmpl)
        else:
            c._personal = None
    for f in _RUNLOG_FIELDS:
        setattr(log, f, meta["runlog"][f])
    log.fault_events = [(str(k), int(cid), float(t))
                        for k, cid, t in meta["fault_events"]]
    if injector is not None:
        injector.load_state_dict(meta["injector"])
    if runner.screening is not None:
        runner.screening.load_state_dict(saved_screening)
    for k in _RUNNER_COUNTERS:
        setattr(runner, k, int(meta["runner"].get(k, 0)))
    runner._launches0 = dp_clip.launches() - int(
        meta["runner"].get("kernel_launches", 0))
    return globals_


def _restore_pending(flat, meta, clients, globals_) -> dict:
    pending = {}
    for cid_s, pm in meta["pending"].items():
        cid = int(cid_s)
        snapshot = None
        if pm["has_personal"]:
            tmpl = {k: globals_[k] for k in clients[cid].personal_keys}
            snapshot = _get_tree(flat, f"plan_personal/{cid}", tmpl)
        pending[cid] = LocalRoundPlan(
            cid=cid, params0=None, opt_state=None,
            batch_idx=(np.asarray(
                _fetch(flat, f"plan_batch_idx/{cid}"), np.int32)
                if pm["materialized"] else None),
            key=int(_fetch(flat, f"plan_key/{cid}")),
            n_steps=int(pm["n_steps"]), duration=float(pm["duration"]),
            epsilon=float(pm["epsilon"]),
            model_version=int(pm["model_version"]),
            personal_snapshot=snapshot)
    return pending


# ---------------------------------------------------------------------------
# loop-facing entry points
# ---------------------------------------------------------------------------

def _on_ranks(runner) -> bool:
    return runner.mesh is not None and runner.mesh.group is not None


def save_async(policy: CheckpointPolicy, runner, clients, log, injector,
               global_params, rng, heap, pending, t_virtual: float,
               server_version: int, total_updates: int) -> str:
    """Snapshot an async run at the end of one event-loop body (after
    re-dispatch: ``pending``/``heap`` describe the next events)."""
    flat, meta = _snapshot_common(
        runner, clients, log, injector, global_params, rng, pending)
    meta.update(kind="async", t_virtual=float(t_virtual),
                engine_version=int(server_version),
                heap=[[float(t), int(cid)] for t, cid in heap])
    return policy._publish(int(total_updates), flat, meta, _on_ranks(runner))


def restore_async(directory: str, runner, clients, log, injector,
                  global_params, heap, pending, rng) -> tuple:
    """Rebuild async loop state in place (``heap``, ``pending`` and the
    dispatch-seed stream ``rng``); returns ``(global_params, t_virtual,
    server_version)``."""
    flat, meta = _ckpt.load_flat(directory)
    if meta.get("kind") != "async":
        raise ValueError(
            f"checkpoint in {directory!r} is kind={meta.get('kind')!r}, "
            "expected an async-engine snapshot")
    globals_ = _restore_common(
        flat, meta, runner, clients, log, injector, global_params, rng)
    pending.update(_restore_pending(flat, meta, clients, globals_))
    heap[:] = [(float(t), int(cid)) for t, cid in meta["heap"]]
    heapq.heapify(heap)     # saved in heap order already
    return globals_, float(meta["t_virtual"]), int(meta["engine_version"])


def save_fedavg(policy: CheckpointPolicy, runner, clients, log, injector,
                global_params, rng, t_virtual: float, rnd: int) -> str:
    """Snapshot a FedAvg run at the end of barrier round ``rnd`` (its
    merge, logging and eval are already in ``log``)."""
    flat, meta = _snapshot_common(
        runner, clients, log, injector, global_params, rng, pending={})
    meta.update(kind="fedavg", t_virtual=float(t_virtual), round=int(rnd))
    return policy._publish(int(rnd), flat, meta, _on_ranks(runner))


def restore_fedavg(directory: str, runner, clients, log, injector,
                   global_params, rng) -> tuple:
    """Returns ``(global_params, t_virtual, completed_round)``."""
    flat, meta = _ckpt.load_flat(directory)
    if meta.get("kind") != "fedavg":
        raise ValueError(
            f"checkpoint in {directory!r} is kind={meta.get('kind')!r}, "
            "expected a fedavg-engine snapshot")
    globals_ = _restore_common(
        flat, meta, runner, clients, log, injector, global_params, rng)
    return globals_, float(meta["t_virtual"]), int(meta["round"])


__all__ = ["SimulatedCrash", "CheckpointPolicy",
           "save_async", "restore_async", "save_fedavg", "restore_fedavg"]
