"""FL server loops (port of ``repro/core/server.py``; paper Algorithm 1,
server side) over a virtual clock.

* :func:`run_fedavg` — synchronous barrier rounds; the round time is the
  MAX over clients (the straggler effect comes from the tier clocks).
* :func:`run_async`  — event-driven: a priority queue of completion events,
  each merged at once (FedAsync) or buffered (FedBuff); staleness
  tau_k = server_version - client_version.

Both are frontends over two execution paths: ``engine="cohort"`` (the
cohort engine in :mod:`repro_torch.engine`) and ``engine="legacy"``, the
per-client event loop below (one ``Client.local_train`` per update, one
DP-SGD step per minibatch), kept as the parity baseline.  With
``staleness_window=0`` the engine reproduces it update for update.

Randomness (the port's RNG scheme, ROADMAP.md): dispatch seeds come from
``np.random.default_rng(seed)`` in the order the reference splits its
PRNG key — one per client per round (FedAvg), N at startup then one per
re-dispatch (async) — exactly as the engine draws them, so a legacy
member and an engine member with the same seed draw the same noise.
"""
from __future__ import annotations

import heapq
from typing import Callable, Optional

import numpy as np

from repro_torch.core.aggregation import AdaptiveAsync, apply_update
from repro_torch.core.client import SEED_HIGH
from repro_torch.core.runlog import RunLog, eval_all, finish_log
from repro_torch.pytree import tree_leaves


def _normalize_eval_every(eval_every: int) -> int:
    """The one eval-cadence validation point (``RunBudget``), imported
    lazily: :mod:`repro_torch.api` sits above this module."""
    from repro_torch.api.spec import RunBudget
    return RunBudget(eval_every=eval_every).eval_every


def _check_legacy(engine, mesh, checkpoint, resume_from):
    if engine != "legacy":
        raise ValueError(f"unknown execution engine: {engine!r}")
    if mesh is not None:
        raise ValueError("mesh execution requires engine='cohort'")
    if checkpoint is not None or resume_from is not None:
        raise ValueError("checkpoint/resume requires engine='cohort' — the "
                         "legacy reference loop has no snapshot support")


def run_fedavg(
    clients: list,
    global_params,
    accuracy_fn: Callable,
    test_data: dict,
    rounds: int = 60,
    seed: int = 0,
    eval_every: int = 1,
    target_acc: Optional[float] = None,
    engine: str = "cohort",
    engine_cfg=None,
    mesh=None,
    faults=None,
    checkpoint=None,
    resume_from=None,
    strategy=None,
    screening=None,
    data_arena=None,
) -> tuple:
    """Synchronous FedAvg (Eq. 9).  Returns (final_params, RunLog).

    ``faults`` (a :class:`repro_torch.core.faults.FaultModel`) injects the
    same deterministic fault sequence on either path; ``strategy`` picks
    the synchronous aggregator (default FedAvg; ``TrimmedMeanFedAvg`` is
    the robust one); ``screening`` rejects nonfinite/oversized uploads
    identically on both paths.  ``data_arena`` is the clients' device
    datasets (a ``statestore.DataArena``; built for the run when None),
    which a Session uploads once.  ``checkpoint``/``resume_from``
    (cohort engine only) snapshot and resume the run — see
    :mod:`repro_torch.engine.resilience`; ``engine_cfg`` may pick any
    client-axis executor (``"fl_step"`` with its ``fl_cfg``); ``mesh`` (a
    ``launch.mesh`` mesh) partitions the cohort engine's client axis over
    the mesh's data axis — cohort-engine only."""
    eval_every = _normalize_eval_every(eval_every)
    if engine == "cohort":
        from repro_torch.engine.engine import run_fedavg_engine
        return run_fedavg_engine(
            clients, global_params, accuracy_fn, test_data, rounds=rounds,
            seed=seed, eval_every=eval_every, target_acc=target_acc,
            engine_cfg=engine_cfg, mesh=mesh, faults=faults,
            checkpoint=checkpoint, resume_from=resume_from,
            strategy=strategy, screening=screening, data_arena=data_arena)
    _check_legacy(engine, mesh, checkpoint, resume_from)
    return _run_fedavg_legacy(
        clients, global_params, accuracy_fn, test_data, rounds=rounds,
        seed=seed, eval_every=eval_every, target_acc=target_acc,
        faults=faults, strategy=strategy, screening=screening,
        data_arena=data_arena)


def run_async(
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
    engine: str = "cohort",
    engine_cfg=None,
    mesh=None,
    faults=None,
    checkpoint=None,
    resume_from=None,
    screening=None,
    data_arena=None,
) -> tuple:
    """Event-driven asynchronous FL (Eq. 10-11): every client trains
    continuously, pulling the fresh globals as soon as its update merged,
    so fast tiers complete many rounds while slow tiers finish one.
    ``mesh`` partitions the cohort engine's client axis over the mesh's
    data axis — cohort-engine only."""
    eval_every = _normalize_eval_every(eval_every)
    if engine == "cohort":
        from repro_torch.engine.engine import run_async_engine
        return run_async_engine(
            clients, global_params, accuracy_fn, test_data, strategy,
            max_updates=max_updates, max_time=max_time, seed=seed,
            eval_every=eval_every, target_acc=target_acc,
            engine_cfg=engine_cfg, mesh=mesh, faults=faults,
            checkpoint=checkpoint, resume_from=resume_from,
            screening=screening, data_arena=data_arena)
    _check_legacy(engine, mesh, checkpoint, resume_from)
    return _run_async_legacy(
        clients, global_params, accuracy_fn, test_data, strategy,
        max_updates=max_updates, max_time=max_time, seed=seed,
        eval_every=eval_every, target_acc=target_acc, faults=faults,
        screening=screening, data_arena=data_arena)


# ---------------------------------------------------------------------------
# Legacy per-client reference path (parity baseline for the cohort engine)
# ---------------------------------------------------------------------------

def _client_rows(clients, global_params, data_arena):
    """Each client's device dataset: its row of the data arena, uploaded
    for this run when no arena is given."""
    if data_arena is None:
        from repro_torch.engine.statestore import DataArena
        data_arena = DataArena.build(
            clients, tree_leaves(global_params)[0].device)
    return {c.cid: data_arena.rows_of(c.cid) for c in clients}


def _run_fedavg_legacy(
    clients, global_params, accuracy_fn, test_data,
    rounds=60, seed=0, eval_every=1, target_acc=None, faults=None,
    strategy=None, screening=None, data_arena=None,
) -> tuple:
    from repro_torch.core import screening as _scr
    from repro_torch.core.aggregation import FedAvg
    from repro_torch.core.faults import FaultInjector, apply_deadline
    rows = _client_rows(clients, global_params, data_arena)
    strat = strategy if strategy is not None else FedAvg()
    injector = (FaultInjector(faults, len(clients))
                if faults is not None else None)
    screener = (_scr.ScreeningState(screening, len(clients))
                if screening is not None else None)
    log = RunLog(strategy=strat.name)
    rng = np.random.default_rng(seed)
    t_virtual = 0.0
    for c in clients:
        log.update_counts[c.tier] = 0
        log.staleness.setdefault(c.tier, [])
        log.eps_trajectory.setdefault(c.tier, [])

    for rnd in range(1, rounds + 1):
        payloads, durations, infos = [], [], []
        # the round's dispatch globals: the corruption/screening reference
        g_round = global_params
        seeds = rng.integers(0, SEED_HIGH, size=len(clients))
        for c, s in zip(clients, seeds):
            params_k, info = c.local_train(global_params, s, rows[c.cid])
            if injector is not None and rnd > 1:
                # leave/rejoin churn stretches the member's round
                info["duration"] += injector.redispatch_delay(
                    c.cid, t_virtual)
            payloads.append(params_k)
            durations.append(info["duration"])
            infos.append(info)
        t_round0 = t_virtual
        offsets = list(durations)
        if injector is not None:
            offsets = [injector.fedavg_fate(c.cid, t_virtual, d)[0]
                       for c, d in zip(clients, durations)]
            keep, round_time = apply_deadline(injector.model, offsets)
            for i, (c, off, kept) in enumerate(zip(clients, offsets, keep)):
                if off is not None:
                    # transit corruption hits every delivered payload (a
                    # deadline-dropped one too: it just never merges)
                    payloads[i] = _scr.corrupt_update(
                        g_round, payloads[i],
                        injector.take_corruption(c.cid))
                    if not kept:
                        injector.note_deadline_drop(c.cid, t_round0 + off)
            if not all(keep):
                injector.note_degraded()
            t_virtual += (round_time if round_time is not None
                          else max(durations))
        else:
            keep = [True] * len(clients)
            # straggler effect: the barrier waits for the slowest client
            t_virtual += max(durations)
        if screener is not None:
            keep = list(keep)
            for i, (c, off) in enumerate(zip(clients, offsets)):
                if not keep[i] or off is None:
                    continue
                fin, nrm = _scr.screen_update(g_round, payloads[i])
                if not screener.screen(c.cid, t_round0 + off, fin, nrm):
                    keep[i] = False
        for c, info, kept in zip(clients, infos, keep):
            if not kept:
                continue
            log.update_counts[c.tier] += 1
            log.staleness[c.tier].append(0)  # barrier => no staleness
            log.eps_trajectory[c.tier].append(info["epsilon"])
        updates = [(p, c.n_train)
                   for c, p, kept in zip(clients, payloads, keep) if kept]
        if updates:
            global_params = strat.aggregate(global_params, updates)

        if rnd % eval_every == 0 or rnd == rounds:
            acc = float(accuracy_fn(global_params, test_data))
            log.times.append(t_virtual)
            log.global_acc.append(acc)
            log.server_version.append(rnd)
            eval_all(clients, global_params, accuracy_fn, log)
            if target_acc is not None and acc >= target_acc:
                break

    finish_log(log, clients, injector, screener)
    return global_params, log


def _run_async_legacy(
    clients, global_params, accuracy_fn, test_data, strategy,
    max_updates=300, max_time=None, seed=0, eval_every=5, target_acc=None,
    faults=None, screening=None, data_arena=None,
) -> tuple:
    from repro_torch.core import screening as _scr
    from repro_torch.core.faults import FaultInjector
    rows = _client_rows(clients, global_params, data_arena)
    injector = (FaultInjector(faults, len(clients))
                if faults is not None else None)
    screener = (_scr.ScreeningState(screening, len(clients))
                if screening is not None else None)
    log = RunLog(strategy=strategy.name)
    rng = np.random.default_rng(seed)
    for c in clients:
        log.update_counts[c.tier] = 0
        log.influence.setdefault(c.tier, 0.0)
        log.staleness.setdefault(c.tier, [])
        log.eps_trajectory.setdefault(c.tier, [])

    # every client starts training version 0 at t=0; pending entries keep
    # the dispatch-time globals: corruption and screening measure the
    # upload against the snapshot the client pulled
    heap = []
    pending = {}
    seeds = rng.integers(0, SEED_HIGH, size=len(clients))
    for c, s in zip(clients, seeds):
        params_k, info = c.local_train(global_params, s, rows[c.cid])
        c.model_version = 0
        pending[c.cid] = (params_k, info, global_params)
        heapq.heappush(heap, (info["duration"], c.cid))

    server_version = 0
    t_virtual = 0.0
    done = False
    while heap and not done:
        t, cid = heapq.heappop(heap)
        c = clients[cid]
        dropped = False
        if injector is not None:
            # the delivery attempt resolves exactly as in the engine: ghosts
            # are deduped, retried/late uploads re-enter the heap, lost
            # updates consume the pending round without merging
            verdict, aux = injector.on_completion(cid, t)
            if verdict == "duplicate":
                continue
            if verdict == "requeue":
                heapq.heappush(heap, (aux, cid))
                continue
            if verdict == "drop":
                dropped = True
                injector.note_degraded()
            elif aux is not None:           # deliver + a scheduled dup copy
                heapq.heappush(heap, (aux, cid))
        t_virtual = t
        params_k, info, g_ref = pending.pop(cid)
        if not dropped and injector is not None:
            params_k = _scr.corrupt_update(
                g_ref, params_k, injector.take_corruption(cid))
        if not dropped and screener is not None:
            fin, nrm = _scr.screen_update(g_ref, params_k)
            if not screener.screen(cid, t, fin, nrm):
                dropped = True  # zero-influence reject, as in the engine
        if not dropped:
            tau = server_version - c.model_version
            log.staleness[c.tier].append(tau)
            log.update_counts[c.tier] += 1
            log.eps_trajectory[c.tier].append(info["epsilon"])
            global_params, inc, w = apply_update(
                strategy, global_params, params_k, tau,
                eps_spent=info["epsilon"])
            server_version += inc
            log.influence[c.tier] += float(w)

        total_updates = sum(log.update_counts.values())
        if not dropped and total_updates % eval_every == 0:
            acc = float(accuracy_fn(global_params, test_data))
            log.times.append(t_virtual)
            log.global_acc.append(acc)
            log.server_version.append(server_version)
            eval_all(clients, global_params, accuracy_fn, log)
            if target_acc is not None and acc >= target_acc:
                done = True

        if total_updates >= max_updates or (max_time and t_virtual >= max_time):
            done = True

        # a client that exhausted its privacy budget stops training
        budget_exhausted = (
            isinstance(strategy, AdaptiveAsync)
            and info["epsilon"] >= strategy.eps_target)
        if not done and not budget_exhausted:
            # the client pulls the fresh globals and trains again
            new_params_k, new_info = c.local_train(
                global_params, rng.integers(0, SEED_HIGH), rows[cid])
            c.model_version = server_version
            pending[cid] = (new_params_k, new_info, global_params)
            t_next = t_virtual + new_info["duration"]
            if injector is not None:
                t_next += injector.redispatch_delay(cid, t_virtual)
            heapq.heappush(heap, (t_next, cid))

    finish_log(log, clients, injector, screener)
    return global_params, log
