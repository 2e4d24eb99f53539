"""Cohort-batched async execution engine (port of
``repro/engine/engine.py``): serial, all-resident.

The event loop is the reference's: dispatch plans each client's local
round on the host (clock draw, accountant step, version pull), cohorts
pop off the virtual-clock heap within ``staleness_window`` of the
earliest completion, each cohort runs as one cohort step
(:mod:`repro_torch.engine.cohort_step`) over device-resident arenas, and
the FedAvg/FedAsync weights fold into one weights-vector merge.  RunLog
bookkeeping is host-deterministic and equals the reference's.

Randomness: dispatch seeds come from ``np.random.default_rng(seed)`` in
the order the reference splits its PRNG key — N at startup, then one per
re-dispatch (async) or one per client per round (FedAvg).  Each seed
seeds that member's device ``torch.Generator`` for its DP noise.

Not in this slice (rejected by :class:`EngineConfig` with the ROADMAP
item that brings them): the pipelined scheduler, the tiered store, mesh
execution and the other client-axis executors, the host data path,
faults, screening and checkpointing.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core import accountant as _accountant
from repro_torch.core.aggregation import FedAsync, FedAvg
from repro_torch.core.runlog import (
    RunLog, eval_all, validate_engine_stats, zero_feature_stats)
from repro_torch.engine.cohort import (
    LocalRoundPlan, fedavg_weights, fold_cohort_weights, plan_batches,
    pop_cohort, steps_per_round)
from repro_torch.engine.cohort_step import make_cohort_step, take_rows
from repro_torch.kernels.common import kernel_info
from repro_torch.pytree import tree_leaves, tree_map

_SEED_HIGH = 2 ** 62


@dataclass(frozen=True)
class EngineConfig:
    """The reference's fields; non-default values of the features this
    slice does not have raise, naming the ROADMAP.md item."""

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
    store: Optional[object] = None

    def __post_init__(self):
        later = {
            "pipeline_depth": (self.pipeline_depth != 1,
                               "queue 1 'pipelined scheduler'"),
            "store": (self.store is not None,
                      "queue 1 'tiered client-state store'"),
            "mesh": (self.mesh is not None,
                     "queue 1 'production round and multi-GPU'"),
            "client_axis": (self.client_axis != "unroll",
                            "queue 1 'production round and multi-GPU'"),
            "fl_cfg": (self.fl_cfg is not None,
                       "queue 1 'production round and multi-GPU'"),
            "device_arena": (not self.device_arena,
                             "queue 1 'benchmarks' (host data path)"),
        }
        for name, (bad, item) in later.items():
            if bad:
                raise ValueError(
                    f"EngineConfig.{name}={getattr(self, name)!r} is not "
                    f"ported yet (ROADMAP.md {item}); this slice runs the "
                    "serial all-resident arena engine")
        if self.max_cohort < 1:
            raise ValueError(f"max_cohort must be >= 1: {self.max_cohort}")


def _host_fetch(runner, value) -> float:
    """The funnel for the loops' device->host scalar reads."""
    out = float(value)
    runner.note_host_sync()
    return out


class CohortRunner:
    """Owns the cohort step, the device arenas and the host plan glue."""

    def __init__(self, clients, cfg: EngineConfig, device):
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
        self.cohort_step, self.merge_cohort = make_cohort_step(
            c0.loss_fn, c0.dp_cfg, c0.opt, use_dp=c0.use_dp,
            dp_path=self.dp_path, add_noise=add_noise)
        # runtime noise scale sigma*C/B: float64 on the host, rounded once
        # to float32 (reference engine.py:360), then one device element
        self._noise_std = torch.tensor(
            [np.float32(c0.dp_cfg.noise_multiplier * c0.dp_cfg.clip_norm
                        / c0.batch_size if c0.use_dp else 0.0)],
            dtype=torch.float32, device=self.device)
        self._arena_params = None
        self._arena_opt = None
        self._writeq = []
        self._eps_sched = {}
        self._build_data_arena()
        self.reset_for_run()

    def reset_for_run(self):
        """Drop per-run state (client-state arenas, queued writes,
        counters); the dataset arena and the step survive."""
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
        self._launches0 = dp_clip.launches()

    # -- host-sync accounting ---------------------------------------------
    def note_host_sync(self):
        if self._in_eval:
            self.host_syncs_at_eval += 1
        else:
            self.host_syncs_between_evals += 1

    def eval_boundary(self, inside: bool):
        self._in_eval = inside

    # -- device-resident arenas -------------------------------------------
    def _build_data_arena(self):
        """Upload every client's dataset once: (n, n_max, ...) per key,
        slot = cid, short datasets zero-padded; labels become int64 here,
        once, for indexing.  (The port never pads a cohort — there is no
        mesh to divide — so the reference's spare pad slot is not kept.)"""
        n = len(self.clients)
        n_max = max(c.n_train for c in self.clients)
        self.arena_slots = n
        self._arena_data = {}
        for k, v0 in self.clients[0].data.items():
            buf = np.zeros((n, n_max) + v0.shape[1:], v0.dtype)
            for c in self.clients:
                buf[c.cid, : c.n_train] = c.data[k]
            t = torch.from_numpy(buf).to(self.device)
            self._arena_data[k] = t.long() if k == "y" else t

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
        out.update(zero_feature_stats())
        return out

    # -- dispatch ----------------------------------------------------------
    def dispatch(self, c, global_params, seed: int, server_version: int
                 ) -> LocalRoundPlan:
        """Plan one local round: the reference's host bookkeeping (accountant
        step, clock draw, version pull); training is deferred to the
        cohort step and the batch plan to staging."""
        self._queue_write(c.cid, global_params)
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
            model_version=server_version)

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
        stacked (K, ...) uploads."""
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
            return take_rows(self._arena_params, slots_d)
        batch_size = self.clients[0].batch_size
        batch_idx = np.zeros((k, self.s_max, batch_size), np.int32)
        for i, p in enumerate(plans):
            batch_idx[i] = self._pad_idx(p.batch_idx, batch_size)
        n_steps = np.array([p.n_steps for p in plans], np.int32)
        scales = np.ones((k,), np.float32)   # clean: no faults in this slice
        self.cohorts_run += 1
        self.h2d_bytes_total += (batch_idx.nbytes + slots.nbytes
                                 + n_steps.nbytes + scales.nbytes)
        gens = [torch.Generator(self.device).manual_seed(p.key)
                for p in plans]
        # the serial driver consumes every cohort before planning the next
        self.blocking_submits += 1
        self.note_host_sync()
        upload, self._arena_opt, _screen = self.cohort_step(
            self._arena_params, self._arena_opt, self._arena_data, slots_d,
            slots_d, torch.from_numpy(batch_idx).to(self.device).long(),
            gens, n_steps, self._noise_std,
            torch.from_numpy(scales).to(self.device))
        return upload


def _coeffs_f32(coeffs, device):
    """Merge coefficients rounded to the merge dtype (float32) on the host
    (reference engine.py:905), then one upload."""
    return torch.from_numpy(np.asarray(coeffs, dtype=np.float32)).to(device)


def _check_strategy(strategy, want_async: bool):
    if type(strategy) not in (FedAvg, FedAsync):
        raise ValueError(
            f"strategy {strategy!r} is not ported yet (ROADMAP.md queue 1, "
            "'legacy client and server loop')")
    if strategy.is_async != want_async:
        raise ValueError(
            f"{'run_async_engine' if want_async else 'run_fedavg_engine'} "
            f"cannot run strategy {strategy.name!r}")


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
    runner: Optional[CohortRunner] = None,
    strategy=None,
) -> tuple:
    """Synchronous FedAvg (Eq. 9): each round is one full-population
    barrier, run as ceil(N / max_cohort) cohort chunks whose dataset-size
    weighted partial sums accumulate into the new globals."""
    if runner is None:
        runner = CohortRunner(clients, engine_cfg or EngineConfig(),
                              tree_leaves(global_params)[0].device)
    cfg = runner.cfg
    if strategy is None:
        strategy = FedAvg()
    _check_strategy(strategy, want_async=False)
    log = RunLog(strategy=strategy.name)
    rng = np.random.default_rng(seed)
    t_virtual = 0.0
    for c in clients:
        log.update_counts[c.tier] = 0
        log.staleness.setdefault(c.tier, [])
        log.eps_trajectory.setdefault(c.tier, [])

    for rnd in range(1, rounds + 1):
        seeds = rng.integers(0, _SEED_HIGH, size=len(clients))
        plans = [runner.dispatch(c, global_params, s, rnd - 1)
                 for c, s in zip(clients, seeds)]
        t_virtual += max(p.duration for p in plans)
        chunks = [plans[i:i + cfg.max_cohort]
                  for i in range(0, len(plans), cfg.max_cohort)]
        stacked_chunks = [runner.run_cohort(ch) for ch in chunks]
        log.cohort_sizes.extend(len(ch) for ch in chunks)

        if cfg.fused_merge:
            _, coeffs = fedavg_weights([clients[p.cid].n_train for p in plans])
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
            updates = [(tree_map(lambda l: l[i], st), clients[p.cid].n_train)
                       for ch, st in zip(chunks, stacked_chunks)
                       for i, p in enumerate(ch)]
            global_params = strategy.aggregate(global_params, updates)

        for p in plans:
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

    for c in clients:
        log.resources[c.tier] = c.clock.resource_sample()
        log.dropouts[c.tier] = c.clock.dropouts
    log.engine_stats = validate_engine_stats(runner.stats())
    return global_params, log


def run_async_engine(
    clients: list,
    global_params,
    accuracy_fn: Callable,
    test_data: dict,
    strategy,
    max_updates: int = 300,
    max_time: Optional[float] = None,
    seed: int = 0,
    eval_every: int = 5,
    target_acc: Optional[float] = None,
    engine_cfg: Optional[EngineConfig] = None,
    runner: Optional[CohortRunner] = None,
) -> tuple:
    """Event-driven async FL (Eq. 10-11) over cohorts popped from the
    virtual-clock heap.  ``staleness_window=0`` reproduces the legacy loop
    update-for-update; a positive window batches near-simultaneous
    completions into one cohort step."""
    if runner is None:
        runner = CohortRunner(clients, engine_cfg or EngineConfig(),
                              tree_leaves(global_params)[0].device)
    cfg = runner.cfg
    _check_strategy(strategy, want_async=True)
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
    seeds = rng.integers(0, _SEED_HIGH, size=len(clients))
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
        for t, cid in events:
            p = pending.pop(cid)
            p.t_complete = t
            plans.append(p)
        t_virtual = plans[-1].t_complete
        new_stacked = runner.run_cohort(plans)
        log.cohort_sizes.append(len(plans))

        # staleness weights alpha/(1+tau_i); member i's tau counts the i
        # earlier merges of this cohort
        taus, weights = [], []
        for i, p in enumerate(plans):
            tau = (server_version + i) - p.model_version
            taus.append(tau)
            weights.append(strategy.mixing_weight(tau))
        if cfg.fused_merge:
            g_coeff, coeffs = fold_cohort_weights(weights)
            global_params = runner.merge_cohort(
                global_params, new_stacked,
                _coeffs_f32(coeffs, runner.device), g_coeff)
        else:
            for i, p in enumerate(plans):
                global_params, _ = strategy.merge(
                    global_params, tree_map(lambda l: l[i], new_stacked),
                    taus[i])
        server_version += len(plans)

        for p, tau, w in zip(plans, taus, weights):
            c = clients[p.cid]
            log.staleness[c.tier].append(tau)
            log.update_counts[c.tier] += 1
            log.eps_trajectory[c.tier].append(p.epsilon)
            log.influence[c.tier] += float(w)

        total_updates = sum(log.update_counts.values())
        crossed = any((total_updates - j) % eval_every == 0
                      for j in range(len(plans)))
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
                plan = runner.dispatch(c, global_params,
                                       rng.integers(0, _SEED_HIGH),
                                       server_version)
                pending[c.cid] = plan
                heapq.heappush(heap, (p.t_complete + plan.duration, c.cid))

    for c in clients:
        log.resources[c.tier] = c.clock.resource_sample()
        log.dropouts[c.tier] = c.clock.dropouts
    log.engine_stats = validate_engine_stats(runner.stats())
    return global_params, log

