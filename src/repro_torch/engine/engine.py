"""Cohort-batched async execution engine (port of
``repro/engine/engine.py``): serial, all-resident.

The event loop is the reference's: dispatch plans each client's local
round on the host (clock draw, accountant step, version pull), cohorts
pop off the virtual-clock heap within ``staleness_window`` of the
earliest completion, each cohort runs as one cohort step
(:mod:`repro_torch.engine.cohort_step`) over device-resident arenas, and
FedAvg/FedAsync weights fold into one weights-vector merge, while
FedBuff, AdaptiveAsync, the robust strategies and personalized clients
go member by member through ``aggregation.apply_update`` /
``strategy.aggregate`` — the switch the legacy loop uses.  RunLog
bookkeeping is host-deterministic and equals the reference's.

Faults and screening (RESILIENCE.md): a ``FaultInjector`` resolves every
popped completion (or FedAvg delivery) on the host; a lost update stays
in its cohort as a zero-weight member, and each delivered member's
transit-corruption scale rides into the step's runtime (K,) scale
vector.  Screening compares the step's per-member (finite, norm) outputs
with the thresholds on the host, after one counted fetch per cohort
(``screen_verdict_syncs``).  Neither changes the built step.

Randomness: dispatch seeds come from ``np.random.default_rng(seed)`` in
the order the reference splits its PRNG key — N at startup, then one per
re-dispatch (async) or one per client per round (FedAvg).  Each seed
seeds that member's device ``torch.Generator`` for its DP noise.

Not in this slice (rejected by :class:`EngineConfig` with the ROADMAP
item that brings them): the pipelined scheduler, the tiered store, mesh
execution and the other client-axis executors, the host data path; and
checkpoint/resume (rejected by the loops).
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass, replace
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core import accountant as _accountant
from repro_torch.core.aggregation import (
    AdaptiveAsync, FedAsync, FedAvg, apply_update)
from repro_torch.core.client import SEED_HIGH
from repro_torch.core.faults import (
    FaultInjector, apply_deadline, zero_fault_stats)
from repro_torch.core.runlog import (
    RunLog, eval_all, finish_log, validate_engine_stats, zero_store_stats)
from repro_torch.core.screening import ScreeningState, zero_screen_stats
from repro_torch.engine.cohort import (
    LocalRoundPlan, fedavg_weights, fold_cohort_weights, plan_batches,
    pop_cohort, steps_per_round)
from repro_torch.engine.cohort_step import (
    cached_cohort_step, take_rows, unstack_tree)
from repro_torch.engine.statestore import StoreConfig
from repro_torch.kernels.common import kernel_info
from repro_torch.pytree import tree_leaves, tree_map

# the ROADMAP.md queue 1 items that bring what the port still rejects
_ROADMAP_ITEMS = {9: "pipelined scheduler", 11: "tiered client-state store",
                  12: "checkpoint/resume",
                  14: "production round and multi-GPU",
                  16: "benchmarks: the host data path"}


def not_ported(what: str, item: int) -> ValueError:
    return ValueError(f"{what} is not ported yet (ROADMAP.md queue 1 item "
                      f"{item}, '{_ROADMAP_ITEMS[item]}')")


@dataclass(frozen=True)
class EngineConfig:
    """The reference's fields and defaults; non-default values of the
    features the port does not have yet raise, naming the ROADMAP.md
    item."""

    staleness_window: float = 0.0  # virtual seconds of completions per cohort
    max_cohort: int = 2            # cap on popped cohort size
    fused_merge: bool = True       # fold FedAvg/FedAsync into the weights vector
    delta: float = 1e-5            # accountant delta
    client_axis: str = "unroll"
    pow2_cohorts: bool = True      # bucket cohort sizes (K in {1, 2, 4, ...})
    mesh: Optional[object] = None
    fl_cfg: Optional[object] = None
    device_arena: bool = True
    pipeline_depth: int = 1
    store: StoreConfig = StoreConfig()

    def __post_init__(self):
        later = (
            ("pipeline_depth", self.pipeline_depth != 1, 9),
            ("store", self.store.hot_slots is not None, 11),
            ("mesh", self.mesh is not None, 14),
            ("client_axis", self.client_axis != "unroll", 14),
            ("fl_cfg", self.fl_cfg is not None, 14),
            ("device_arena", not self.device_arena, 16),
        )
        for name, bad, item in later:
            if bad:
                raise not_ported(
                    f"EngineConfig.{name}={getattr(self, name)!r}", item)
        if self.max_cohort < 1:
            raise ValueError(f"max_cohort must be >= 1: {self.max_cohort}")


def _resolve_cfg(engine_cfg, mesh, checkpoint, resume_from) -> EngineConfig:
    """The loops' keyword features the port does not have yet raise here,
    naming their ROADMAP.md item."""
    if checkpoint is not None or resume_from is not None:
        raise not_ported("checkpoint/resume", 12)
    cfg = engine_cfg or EngineConfig()
    if mesh is not None and cfg.mesh is None:
        cfg = replace(cfg, mesh=mesh)     # raises, naming item 14
    return cfg


def _host_fetch(runner, value) -> float:
    """The funnel for the loops' device->host scalar reads."""
    out = float(value)
    runner.note_host_sync()
    return out


def _host_fetch_array(runner, value):
    """The :func:`_host_fetch` sibling for the one array read, a cohort's
    screen verdicts (bucketed as ``screen_verdict_syncs``)."""
    out = tuple(v.cpu().numpy() for v in value)
    runner.note_host_sync()
    return out


def build_data_arena(clients, device) -> dict:
    """Every client's train split uploaded once as (n, n_max, ...) per
    key, slot = cid, short datasets zero-padded, labels int64.  The
    engine gathers its cohorts' minibatches from it and the legacy loop
    indexes a client's row."""
    n = len(clients)
    n_max = max(c.n_train for c in clients)
    arena = {}
    for k, v0 in clients[0].data.items():
        buf = np.zeros((n, n_max) + v0.shape[1:], v0.dtype)
        for c in clients:
            buf[c.cid, : c.n_train] = c.data[k]
        t = torch.from_numpy(buf).to(device)
        arena[k] = t.long() if k == "y" else t
    return arena


class CohortRunner:
    """Owns the cohort step, the device arenas and the host plan glue."""

    def __init__(self, clients, cfg: EngineConfig, device, data_arena=None):
        c0 = clients[0]
        for c in clients:
            if (c.dp_cfg != c0.dp_cfg or c.use_dp != c0.use_dp
                    or c.dp_path != c0.dp_path or c.opt != c0.opt
                    or c.batch_size != c0.batch_size
                    or not (c.loss_fn is c0.loss_fn
                            or c.loss_fn == c0.loss_fn)):
                raise ValueError(
                    "cohort engine requires homogeneous client training "
                    "configs (heterogeneity lives in the virtual clocks)")
        self.clients = clients
        self.cfg = cfg
        self.device = torch.device(device)
        self.s_max = max(
            steps_per_round(c.n_train, c.batch_size, c.local_epochs)
            for c in clients)
        add_noise = bool(c0.use_dp and c0.dp_cfg.noise_multiplier > 0)
        self.dp_path = c0.dp_path if c0.use_dp else "jnp"
        self.cohort_step, self.merge_cohort = cached_cohort_step(
            c0.loss_fn, c0.dp_cfg, c0.opt, use_dp=c0.use_dp,
            dp_path=self.dp_path, add_noise=add_noise)
        # runtime noise scale sigma*C/B: float64 on the host, rounded once
        # to float32 (reference engine.py:360), then one device element
        self._noise_std = torch.tensor(
            [np.float32(c0.dp_cfg.noise_multiplier * c0.dp_cfg.clip_norm
                        / c0.batch_size if c0.use_dp else 0.0)],
            dtype=torch.float32, device=self.device)
        self._eps_sched = {}
        # the dataset arena (build_data_arena); a Session hands one arena
        # to every runner over the same partitions, so a sigma sweep
        # uploads the corpus once.  The port never pads a cohort (there
        # is no mesh to divide), so the reference's spare pad slot is not
        # kept.
        self.arena_slots = len(clients)
        self._arena_data = (data_arena if data_arena is not None
                            else build_data_arena(clients, self.device))
        self.reset_for_run()

    def reset_for_run(self):
        """Drop per-run state (client-state arenas, queued writes, fault and
        screening oracles, counters); the dataset arena, the step and the
        epsilon schedules survive (the Session reuses a runner across
        runs)."""
        from repro_torch.kernels.dp_clip import dp_clip
        self._arena_params = None
        self._arena_opt = None
        self._writeq = []
        self.cohorts_run = 0
        self.h2d_bytes_total = 0
        self._in_eval = False
        self.host_syncs_at_eval = 0
        self.host_syncs_between_evals = 0
        self.blocking_submits = 0
        self.fault_injector = None
        self.screening = None
        self._in_screen = False
        self.screen_verdict_syncs = 0
        self._last_screen = None
        self._launches0 = dp_clip.launches()

    # -- host-sync accounting ---------------------------------------------
    def note_host_sync(self):
        if self._in_screen:
            self.screen_verdict_syncs += 1
        elif self._in_eval:
            self.host_syncs_at_eval += 1
        else:
            self.host_syncs_between_evals += 1

    def eval_boundary(self, inside: bool):
        self._in_eval = inside

    # -- device-resident arenas -------------------------------------------
    def _ensure_state_arenas(self, params):
        if self._arena_params is not None:
            return
        a = self.arena_slots
        self._arena_params = tree_map(
            lambda l: l.detach().unsqueeze(0).repeat(
                (a,) + (1,) * l.dim()).contiguous(), params)
        self._arena_opt = self.clients[0].opt.init(
            self._arena_params, stack_shape=(a,))

    def _queue_write(self, slot: int, params_tree):
        """Deferred 'slot trains from this params tree': consecutive
        dispatches sharing one globals object collapse into one write."""
        self._ensure_state_arenas(params_tree)
        self._writeq.append((slot, params_tree))

    def _flush_writes(self):
        q, self._writeq = self._writeq, []
        i = 0
        while i < len(q):
            tree = q[i][1]
            slots = [q[i][0]]
            j = i + 1
            while j < len(q) and q[j][1] is tree:
                slots.append(q[j][0])
                j += 1
            idx = torch.as_tensor(slots, dtype=torch.int64,
                                  device=self.device)
            tree_map(lambda a, l: a.index_copy_(
                0, idx, l.unsqueeze(0).expand((len(slots),) + l.shape)),
                self._arena_params, tree)
            i = j

    def stats(self) -> dict:
        from repro_torch.kernels.dp_clip import dp_clip
        out = {
            "data_path": "arena",
            "dp_path": self.dp_path,
            "pallas_interpret": (
                kernel_info(self.device, dp_clip,
                            dp_clip.launches() - self._launches0)
                if self.dp_path == "pallas" else None),
            "cohorts": self.cohorts_run,
            "h2d_bytes_total": int(self.h2d_bytes_total),
            "h2d_bytes_per_cohort": (
                self.h2d_bytes_total / self.cohorts_run
                if self.cohorts_run else 0.0),
            "pipeline_depth": int(self.cfg.pipeline_depth),
            "host_syncs_at_eval": self.host_syncs_at_eval,
            "host_syncs_between_evals": self.host_syncs_between_evals,
            "blocking_submits": self.blocking_submits,
            "drain_waits": 0,
        }
        inj = self.fault_injector
        out.update(inj.stats() if inj is not None else zero_fault_stats())
        scr = zero_screen_stats()
        if self.screening is not None:
            scr.update(self.screening.counters)
        scr["screen_verdict_syncs"] = self.screen_verdict_syncs
        out.update(scr)
        out.update(zero_store_stats())
        return out

    # -- dispatch ----------------------------------------------------------
    def dispatch(self, c, global_params, seed: int, server_version: int
                 ) -> LocalRoundPlan:
        """Plan one local round: the reference's host bookkeeping (personal
        overlay, accountant step, clock draw, version pull); training is
        deferred to the cohort step and the batch plan to staging."""
        params0 = global_params
        personal_snapshot = None
        if c.personal_keys:
            if c._personal is None:  # first round: adopt global init
                c._personal = {k: global_params[k] for k in c.personal_keys}
            params0 = dict(global_params)
            params0.update(c._personal)
            personal_snapshot = {k: global_params[k] for k in c.personal_keys}
        self._queue_write(c.cid, params0)
        steps = steps_per_round(c.n_train, c.batch_size, c.local_epochs)
        if c.use_dp and steps > 0:
            c.accountant.step(c.q, c.dp_cfg.noise_multiplier, steps)
        duration = c.clock.round_duration()
        c.update_count += 1
        c.model_version = server_version
        return LocalRoundPlan(
            cid=c.cid, params0=None, opt_state=None, batch_idx=None,
            key=int(seed), n_steps=steps, duration=duration,
            epsilon=self._client_epsilon(c, steps) if c.use_dp else 0.0,
            model_version=server_version,
            personal_snapshot=personal_snapshot)

    def _client_epsilon(self, c, steps: int) -> float:
        """Per-round table lookup on the shared EpsilonSchedule
        (bit-identical to ``c.accountant.epsilon``)."""
        sched = self._eps_sched.get(c.cid)
        if sched is None:
            sched = _accountant.cached_epsilon_schedule(
                c.q, c.dp_cfg.noise_multiplier, steps, self.cfg.delta,
                orders=c.accountant.orders)
            self._eps_sched[c.cid] = sched
        return sched.epsilon_after_rounds(c.update_count)

    # -- cohort step -------------------------------------------------------
    def _pad_idx(self, idx, batch_size: int):
        """Pad one member's (S, B) plan to (s_max, B) with masked tail rows
        (repeat the first row; all-zeros when S == 0)."""
        if idx.shape[0] >= self.s_max:
            return idx
        pad_row = idx[:1] if idx.shape[0] else np.zeros(
            (1, batch_size), np.int32)
        return np.concatenate(
            [idx, np.broadcast_to(
                pad_row, (self.s_max - idx.shape[0],) + pad_row.shape[1:])])

    def run_cohort(self, plans):
        """Stage the cohort's index plans, run the cohort step; returns the
        stacked (K, ...) uploads and keeps the screen outputs for
        :meth:`take_screen_handle`."""
        for p in plans:   # deferred permutation draws, in plan order
            if p.batch_idx is None:
                c = self.clients[p.cid]
                p.batch_idx = plan_batches(
                    c.rng, c.n_train, c.batch_size, c.local_epochs)
        self._flush_writes()
        k = len(plans)
        slots = np.array([p.cid for p in plans], np.int32)
        slots_d = torch.from_numpy(slots).to(self.device).long()
        if self.s_max == 0:  # degenerate: no client has a full batch
            self._last_screen = None
            return take_rows(self._arena_params, slots_d)
        batch_size = self.clients[0].batch_size
        batch_idx = np.zeros((k, self.s_max, batch_size), np.int32)
        for i, p in enumerate(plans):
            batch_idx[i] = self._pad_idx(p.batch_idx, batch_size)
        n_steps = np.array([p.n_steps for p in plans], np.int32)
        scales = np.array([p.corrupt_scale for p in plans], np.float32)
        self.cohorts_run += 1
        self.h2d_bytes_total += (batch_idx.nbytes + slots.nbytes
                                 + n_steps.nbytes + scales.nbytes)
        gens = [torch.Generator(self.device).manual_seed(p.key)
                for p in plans]
        # the serial driver consumes every cohort before planning the next
        self.blocking_submits += 1
        self.note_host_sync()
        upload, self._arena_opt, self._last_screen = self.cohort_step(
            self._arena_params, self._arena_opt, self._arena_data, slots_d,
            slots_d, torch.from_numpy(batch_idx).to(self.device).long(),
            gens, n_steps, self._noise_std,
            torch.from_numpy(scales).to(self.device))
        return upload

    def take_screen_handle(self):
        """Return and clear the last cohort's device screen outputs."""
        screen, self._last_screen = self._last_screen, None
        return screen

    def fetch_screen(self, handle, k: int):
        """One device->host fetch of a cohort's (finite, norm) pair,
        counted as ``screen_verdict_syncs``.  A degenerate cohort never
        trained: every member is finite with a zero-delta norm."""
        if handle is None:
            return np.ones((k,), bool), np.zeros((k,), np.float32)
        self._in_screen = True
        try:
            fin, nrm = _host_fetch_array(self, handle)
        finally:
            self._in_screen = False
        return fin[:k], nrm[:k]

    def upload(self, plan: LocalRoundPlan, new_params):
        """A member's trained params as uploaded: personal subtrees stay on
        the client, the upload carries the received globals there."""
        c = self.clients[plan.cid]
        if not c.personal_keys:
            return new_params
        c._personal = {k: new_params[k] for k in c.personal_keys}
        up = dict(new_params)
        up.update(plan.personal_snapshot)
        return up


def _coeffs_f32(coeffs, device):
    """Merge coefficients rounded to the merge dtype (float32) on the host
    (reference engine.py:905), then one upload."""
    return torch.from_numpy(np.asarray(coeffs, dtype=np.float32)).to(device)


def _fused_ok(strategy, clients, plans, cfg: EngineConfig) -> bool:
    """The weights-vector merge is exact only for plain FedAvg and
    FedAsync; FedBuff keeps buffer state across cohorts, AdaptiveAsync
    reads each member's epsilon, the robust strategies are not weighted
    sums, and personalized clients upload overlaid trees."""
    if not cfg.fused_merge:
        return False
    if type(strategy) not in (FedAvg, FedAsync):
        return False
    return not any(clients[p.cid].personal_keys for p in plans)


def _oracles(runner, clients, faults, screening):
    injector = (FaultInjector(faults, len(clients))
                if faults is not None else None)
    screener = (ScreeningState(screening, len(clients))
                if screening is not None else None)
    runner.fault_injector = injector
    runner.screening = screener
    return injector, screener


def run_fedavg_engine(
    clients: list,
    global_params,
    accuracy_fn: Callable,
    test_data: dict,
    rounds: int = 60,
    seed: int = 0,
    eval_every: int = 1,
    target_acc: Optional[float] = None,
    engine_cfg: Optional[EngineConfig] = None,
    mesh=None,
    runner: Optional[CohortRunner] = None,
    faults=None,
    checkpoint=None,
    resume_from: Optional[str] = None,
    strategy=None,
    screening=None,
    data_arena=None,
) -> tuple:
    """Synchronous FedAvg (Eq. 9): each round is one full-population
    barrier, run as ceil(N / max_cohort) cohort chunks whose dataset-size
    weighted partial sums accumulate into the new globals.

    ``faults``: lost members keep their cohort slot with weight 0, the
    barrier honours ``round_deadline_s``/``min_quorum`` with survivor-
    renormalized weights, and churn stretches a member's round.
    ``strategy`` picks the aggregator (robust ones go through
    ``aggregate``); ``screening`` rejects delivered uploads from the
    step's verdict outputs.  ``runner`` injects a prebuilt, reset
    runner (the Session's); its config and data arena win over
    ``engine_cfg`` and ``data_arena`` (:func:`build_data_arena`'s
    layout; built from the clients when None)."""
    cfg = _resolve_cfg(engine_cfg if runner is None else runner.cfg, mesh,
                       checkpoint, resume_from)
    if runner is None:
        runner = CohortRunner(clients, cfg,
                              tree_leaves(global_params)[0].device,
                              data_arena=data_arena)
    if strategy is None:
        strategy = FedAvg()
    if strategy.is_async:
        raise ValueError(
            f"run_fedavg_engine requires a synchronous strategy, got "
            f"{strategy.name!r} — use run_async_engine")
    injector, screener = _oracles(runner, clients, faults, screening)
    log = RunLog(strategy=strategy.name)
    rng = np.random.default_rng(seed)
    t_virtual = 0.0
    for c in clients:
        log.update_counts[c.tier] = 0
        log.staleness.setdefault(c.tier, [])
        log.eps_trajectory.setdefault(c.tier, [])

    for rnd in range(1, rounds + 1):
        seeds = rng.integers(0, SEED_HIGH, size=len(clients))
        plans = []
        for c, s in zip(clients, seeds):
            p = runner.dispatch(c, global_params, s, rnd - 1)
            if injector is not None and rnd > 1:
                # leave/rejoin churn stretches the member's barrier round
                p.duration += injector.redispatch_delay(c.cid, t_virtual)
            plans.append(p)
        t_round0 = t_virtual
        t_deliver = [t_round0 + p.duration for p in plans]
        if injector is not None:
            # fates resolve before the step so each delivered member's
            # corruption scale rides into the step's runtime scale vector
            offsets = [injector.fedavg_fate(p.cid, t_virtual, p.duration)[0]
                       for p in plans]
            keep, round_time = apply_deadline(injector.model, offsets)
            for i, (p, off, kept) in enumerate(zip(plans, offsets, keep)):
                p.dropped = not kept
                t_deliver[i] = None if off is None else t_round0 + off
                if off is not None:
                    p.corrupt_scale = injector.take_corruption(p.cid)
                    if not kept:
                        injector.note_deadline_drop(p.cid, t_round0 + off)
            if any(p.dropped for p in plans):
                injector.note_degraded()
            t_virtual += (round_time if round_time is not None
                          else max(p.duration for p in plans))
        else:
            t_virtual += max(p.duration for p in plans)
        chunks = [plans[i:i + cfg.max_cohort]
                  for i in range(0, len(plans), cfg.max_cohort)]
        stacked_chunks, screen_handles = [], []
        for ch in chunks:
            stacked_chunks.append(runner.run_cohort(ch))
            screen_handles.append(runner.take_screen_handle())
        log.cohort_sizes.extend(len(ch) for ch in chunks)
        if screener is not None:
            i0 = 0
            for ch, handle in zip(chunks, screen_handles):
                fin, nrm = runner.fetch_screen(handle, len(ch))
                for j, p in enumerate(ch):
                    if not p.dropped and not screener.screen(
                            p.cid, t_deliver[i0 + j], fin[j], nrm[j]):
                        p.dropped = True
                i0 += len(ch)

        if _fused_ok(strategy, clients, plans, cfg):
            # Eq. 9 over the surviving members; a dropped member keeps its
            # slot with coefficient exactly 0
            if any(not p.dropped for p in plans):
                _, kept_coeffs = fedavg_weights(
                    [clients[p.cid].n_train for p in plans if not p.dropped])
                it = iter(kept_coeffs)
                coeffs = [0.0 if p.dropped else next(it) for p in plans]
                merged = tree_map(torch.zeros_like, global_params)
                off = 0
                for ch, st in zip(chunks, stacked_chunks):
                    merged = runner.merge_cohort(
                        merged, st,
                        _coeffs_f32(coeffs[off:off + len(ch)], runner.device),
                        1.0)
                    off += len(ch)
                global_params = merged
        else:
            updates = []
            for ch, st in zip(chunks, stacked_chunks):
                updates.extend(
                    (runner.upload(p, unstack_tree(st, i)),
                     clients[p.cid].n_train)
                    for i, p in enumerate(ch) if not p.dropped)
            if updates:
                global_params = strategy.aggregate(global_params, updates)

        for p in plans:
            if p.dropped:
                continue
            c = clients[p.cid]
            log.update_counts[c.tier] += 1
            log.staleness[c.tier].append(0)  # barrier => no staleness
            log.eps_trajectory[c.tier].append(p.epsilon)

        if rnd % eval_every == 0 or rnd == rounds:
            runner.eval_boundary(True)
            acc = _host_fetch(runner, accuracy_fn(global_params, test_data))
            log.times.append(t_virtual)
            log.global_acc.append(acc)
            log.server_version.append(rnd)
            eval_all(clients, global_params, accuracy_fn, log)
            runner.eval_boundary(False)
            if target_acc is not None and acc >= target_acc:
                break

    finish_log(log, clients, injector, screener)
    log.engine_stats = validate_engine_stats(runner.stats())
    return global_params, log


def run_async_engine(
    clients: list,
    global_params,
    accuracy_fn: Callable,
    test_data: dict,
    strategy,                      # FedAsync / FedBuff / AdaptiveAsync
    max_updates: int = 300,
    max_time: Optional[float] = None,
    seed: int = 0,
    eval_every: int = 5,
    target_acc: Optional[float] = None,
    engine_cfg: Optional[EngineConfig] = None,
    mesh=None,
    runner: Optional[CohortRunner] = None,
    faults=None,
    checkpoint=None,
    resume_from: Optional[str] = None,
    screening=None,
    data_arena=None,
) -> tuple:
    """Event-driven async FL (Eq. 10-11) over cohorts popped from the
    virtual-clock heap.  ``staleness_window=0`` reproduces the legacy loop
    update-for-update; a positive window batches near-simultaneous
    completions into one cohort step.

    ``faults``: every popped completion is a delivery attempt the
    injector resolves (duplicates deduped, retried/late uploads re-enter
    the heap, lost updates stay in the cohort with weight 0).
    ``screening`` turns rejected and quarantined deliveries into
    zero-weight members too."""
    cfg = _resolve_cfg(engine_cfg if runner is None else runner.cfg, mesh,
                       checkpoint, resume_from)
    if runner is None:
        runner = CohortRunner(clients, cfg,
                              tree_leaves(global_params)[0].device,
                              data_arena=data_arena)
    if not strategy.is_async:
        raise ValueError(
            f"run_async_engine requires an asynchronous strategy, got "
            f"{strategy.name!r} — use run_fedavg_engine")
    injector, screener = _oracles(runner, clients, faults, screening)
    log = RunLog(strategy=strategy.name)
    rng = np.random.default_rng(seed)
    for c in clients:
        log.update_counts[c.tier] = 0
        log.influence.setdefault(c.tier, 0.0)
        log.staleness.setdefault(c.tier, [])
        log.eps_trajectory.setdefault(c.tier, [])

    # every client starts training version 0 at t=0
    heap, pending = [], {}
    server_version = 0
    t_virtual = 0.0
    seeds = rng.integers(0, SEED_HIGH, size=len(clients))
    for c, s in zip(clients, seeds):
        plan = runner.dispatch(c, global_params, s, server_version)
        pending[c.cid] = plan
        heap.append((plan.duration, c.cid))
    heapq.heapify(heap)

    done = False
    while heap and not done:
        events = pop_cohort(heap, cfg.staleness_window, cfg.max_cohort,
                            bucket_pow2=cfg.pow2_cohorts)
        plans = []
        if injector is None:
            for t, cid in events:
                p = pending.pop(cid)
                p.t_complete = t
                plans.append(p)
        else:
            for t, cid in events:
                verdict, aux = injector.on_completion(cid, t)
                if verdict == "duplicate":
                    continue
                if verdict == "requeue":
                    heapq.heappush(heap, (aux, cid))
                    continue
                p = pending.pop(cid)
                p.t_complete = t
                if verdict == "drop":
                    p.dropped = True
                else:
                    p.corrupt_scale = injector.take_corruption(cid)
                    if aux is not None:     # deliver + a scheduled dup copy
                        heapq.heappush(heap, (aux, cid))
                plans.append(p)
            if not plans:                   # the whole pop was ghosts/retries
                continue
        t_virtual = plans[-1].t_complete
        new_stacked = runner.run_cohort(plans)
        screen_handle = runner.take_screen_handle()
        log.cohort_sizes.append(len(plans))
        n_dropped = sum(1 for p in plans if p.dropped)
        if n_dropped:
            injector.note_degraded()
        if screener is not None:
            fin, nrm = runner.fetch_screen(screen_handle, len(plans))
            for j, p in enumerate(plans):
                if not p.dropped and not screener.screen(
                        p.cid, p.t_complete, fin[j], nrm[j]):
                    p.dropped = True
            n_dropped = sum(1 for p in plans if p.dropped)

        taus, weights = [], []
        if _fused_ok(strategy, clients, plans, cfg):
            # staleness weights alpha/(1+tau_i) folded into one reduction;
            # member i's tau counts the earlier delivered merges of this
            # cohort, a dropped member merges with coefficient exactly 0
            n_del = 0
            for p in plans:
                if p.dropped:
                    taus.append(0)
                    weights.append(0.0)
                else:
                    tau = (server_version + n_del) - p.model_version
                    taus.append(tau)
                    weights.append(strategy.mixing_weight(tau))
                    n_del += 1
            g_coeff, coeffs = fold_cohort_weights(weights)
            global_params = runner.merge_cohort(
                global_params, new_stacked,
                _coeffs_f32(coeffs, runner.device), g_coeff)
            server_version += n_del
        else:
            # member by member, in the cohort's order
            for i, p in enumerate(plans):
                if p.dropped:
                    taus.append(0)
                    weights.append(0.0)
                    continue
                up = runner.upload(p, unstack_tree(new_stacked, i))
                tau = server_version - p.model_version
                global_params, inc, w = apply_update(
                    strategy, global_params, up, tau, eps_spent=p.epsilon)
                server_version += inc
                taus.append(tau)
                weights.append(w)

        for p, tau, w in zip(plans, taus, weights):
            if p.dropped:
                continue
            c = clients[p.cid]
            log.staleness[c.tier].append(tau)
            log.update_counts[c.tier] += 1
            log.eps_trajectory[c.tier].append(p.epsilon)
            log.influence[c.tier] += float(w)

        total_updates = sum(log.update_counts.values())
        crossed = any((total_updates - j) % eval_every == 0
                      for j in range(len(plans) - n_dropped))
        if crossed:
            runner.eval_boundary(True)
            acc = _host_fetch(runner, accuracy_fn(global_params, test_data))
            log.times.append(t_virtual)
            log.global_acc.append(acc)
            log.server_version.append(server_version)
            eval_all(clients, global_params, accuracy_fn, log)
            runner.eval_boundary(False)
            if target_acc is not None and acc >= target_acc:
                done = True
        if total_updates >= max_updates or (max_time and t_virtual >= max_time):
            done = True

        if not done:
            for p in plans:
                c = clients[p.cid]
                # a client that exhausted its privacy budget stops training
                # (dropped members re-dispatch: their budget was spent)
                if (isinstance(strategy, AdaptiveAsync)
                        and p.epsilon >= strategy.eps_target):
                    continue
                plan = runner.dispatch(c, global_params,
                                       rng.integers(0, SEED_HIGH),
                                       server_version)
                pending[c.cid] = plan
                t_next = p.t_complete + plan.duration
                if injector is not None:
                    t_next += injector.redispatch_delay(c.cid, p.t_complete)
                heapq.heappush(heap, (t_next, c.cid))

    finish_log(log, clients, injector, screener)
    log.engine_stats = validate_engine_stats(runner.stats())
    return global_params, log
