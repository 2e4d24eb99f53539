"""The Session: long-lived execution state behind declarative experiments
(port of ``repro/api/session.py``).

A :class:`Session` owns the testbed and engine state as keyed layers and,
between consecutive :class:`ExperimentSpec` s, rebuilds only what the spec
diff invalidates:

    what changed             what is rebuilt          what stays warm
    ---------------------    ----------------------   -------------------
    nothing (re-run)         client state reset       everything
    strategy / run budget    client state reset       testbed, runner +
                                                      device arenas, step
    testbed.sigma (DP)       clients (cheap), runner  partitions, the
                                                      device data arena,
                                                      the cached step (the
                                                      noise scale is a
                                                      runtime tensor)
    testbed.data/partition   everything below the     the cached step
                             step cache

``session.sweep(spec, axes={...})`` runs the cartesian grid of a spec over
dotted-path axes (the LAST axis varies fastest) under a step-build budget
(:func:`repro_torch.analysis.guard.compile_guard`) and returns a
:class:`SweepResult` with a comparison table.  Runs inside one session
equal fresh-process runs bit for bit: every client resets to its
construction-time RNG/clock/accountant chain and the runner drops its
per-run arenas between runs.

The session runs on one device, the card unless ``Session(device="cpu")``.
"""
from __future__ import annotations

import itertools
import time
from collections import Counter
from dataclasses import dataclass, field
from typing import Optional

from repro_torch.api.spec import ExperimentSpec, StrategySpec, replace_path
from repro_torch.core.testbed import (
    TestbedConfig, build_clients, build_partitions, partition_key)
from repro_torch.device import resolve_device


def _axis_label(value) -> object:
    """Human-readable cell for a sweep-axis value."""
    if isinstance(value, StrategySpec):
        kw = ", ".join(f"{k}={v}" for k, v in value.params)
        return f"{value.name}({kw})" if kw else value.name
    if hasattr(value, "__dataclass_fields__"):
        return type(value).__name__
    return value


@dataclass
class SweepResult:
    """Outcome of :meth:`Session.sweep`: parallel lists over the grid
    points (``specs[i]`` produced ``logs[i]`` in ``wall_s[i]`` seconds;
    ``points[i]`` maps each axis path to the value it took)."""

    base: ExperimentSpec
    axes: dict
    points: list = field(default_factory=list)
    specs: list = field(default_factory=list)
    logs: list = field(default_factory=list)
    wall_s: list = field(default_factory=list)

    def __len__(self):
        return len(self.logs)

    def __iter__(self):
        return iter(zip(self.specs, self.logs))

    def table(self) -> list:
        """One row per scenario: the axis values plus the summary metrics
        the paper's figures are built from (efficiency: final acc /
        time-to-target; fairness: Jain + participation skew; privacy:
        max-eps + disparity)."""
        rows = []
        for point, spec, log, wall in zip(
                self.points, self.specs, self.logs, self.wall_s):
            fr = log.fairness()
            eps_final = [v[-1] for v in log.eps_trajectory.values() if v]
            target = spec.run.target_acc
            row = {
                "strategy": spec.strategy.name,
                "sigma": spec.testbed.sigma,
                "final_acc": (round(log.global_acc[-1], 4)
                              if log.global_acc else None),
                "time_to_target_s": (log.time_to_accuracy(target)
                                     if target is not None else None),
                "updates": sum(log.update_counts.values()),
                "jain_participation": round(fr["jain_participation"], 4),
                "accuracy_gap": round(fr["accuracy_gap"], 4),
                "privacy_disparity": round(fr["privacy_disparity"], 2),
                "max_eps": (round(max(eps_final), 3) if eps_final else 0.0),
                "wall_s": round(wall, 3),
            }
            # axis columns LAST so they win any name collision: a
            # StrategySpec axis point must show "fedasync(alpha=0.2)",
            # not be clobbered down to the bare name shared by every row
            row.update({p: _axis_label(v) for p, v in point.items()})
            rows.append(row)
        return rows


class Session:
    """Owns testbed + engine state across runs (see module docstring).

    One live testbed and one live cohort runner at a time; dataset
    partitions are kept per distinct data config, and the uploaded device
    :class:`~repro_torch.engine.statestore.DataArena` per
    ``(partition_key, mesh)`` (it is immutable, so a sweep whose axes
    only touch client-state config hands the same device tensors to every
    rebuilt runner and legacy run).  The step cache itself is process-global
    (:mod:`repro_torch.engine.cohort_step`)."""

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self._partitions = {}          # partition_key -> (splits, pooled)
        self._data_arenas = {}         # (partition_key, mesh) -> DataArena
        self._testbed_cfg: Optional[TestbedConfig] = None
        self._clients = None
        self._params0 = None
        self._acc_fn = None
        self._pooled = None
        self._runner = None
        self._runner_key = None
        self.events = Counter()        # cache telemetry (tests/bench)

    # -- cache layers ------------------------------------------------------
    def _materialize(self, tb: TestbedConfig):
        """Clients + initial params + eval closures for ``tb``, reusing
        cached partitions / the live testbed where the config allows.  The
        initial params come from the workload's CPU generator seeded with
        ``tb.seed``, as in ``build_testbed``."""
        if self._testbed_cfg == tb:
            for c in self._clients:
                c.reset()
            self.events["testbed_reuses"] += 1
            return
        pk = partition_key(tb)
        cached = self._partitions.get(pk)
        if cached is None:
            cached = build_partitions(tb)
            self._partitions[pk] = cached
            self.events["partition_builds"] += 1
        else:
            self.events["partition_reuses"] += 1
        splits, pooled = cached
        from repro_torch.api.workloads import get_workload
        wl = get_workload(tb.workload)
        self._clients = build_clients(tb, splits)
        self._params0 = wl.init(tb.seed, tb.model, self.device)
        self._acc_fn = wl.shared_accuracy(tb.model)
        self._pooled = pooled
        self._testbed_cfg = tb
        self._runner = None            # built over the OLD clients
        self._runner_key = None
        self.events["testbed_builds"] += 1

    def _data_arena(self, tb: TestbedConfig, mesh=None):
        """The device data arena (a ``statestore.DataArena``) of ``tb``'s
        partitions, uploaded once per ``(partition_key, mesh)`` (the
        reference's key; the port's arena is replicated on every rank of
        a mesh) and shared by every runner and legacy run."""
        from repro_torch.engine.statestore import DataArena
        key = (partition_key(tb), mesh)
        arena = self._data_arenas.get(key)
        if arena is None:
            arena = DataArena.build(self._clients, self.device)
            self._data_arenas[key] = arena
            self.events["data_arena_builds"] += 1
        else:
            self.events["data_arena_reuses"] += 1
        return arena

    def _get_runner(self, tb: TestbedConfig, engine_cfg):
        from repro_torch.engine.engine import CohortRunner
        key = (tb, engine_cfg)
        if self._runner_key == key:
            self._runner.reset_for_run()
            self.events["runner_reuses"] += 1
        else:
            # the host-fed path reads the clients' numpy splits instead
            arena = (self._data_arena(tb, engine_cfg.mesh)
                     if engine_cfg.device_arena else None)
            self._runner = CohortRunner(self._clients, engine_cfg,
                                        self.device, data_arena=arena)
            self._runner_key = key
            self.events["runner_builds"] += 1
        return self._runner

    # -- execution ---------------------------------------------------------
    def run(self, spec: ExperimentSpec, *,
            checkpoint_every: Optional[int] = None,
            checkpoint_dir: Optional[str] = None,
            keep_last: int = 3,
            crash_after_saves: Optional[int] = None,
            resume_from: Optional[str] = None) -> tuple:
        """Execute one spec; returns ``(final_params, RunLog)``.
        ``spec.testbed.faults`` and ``.screening`` flow to either backend's
        loop.  ``checkpoint_every=N`` with ``checkpoint_dir`` snapshots
        the run every N rounds (FedAvg) / merged updates (async), keeping
        the newest ``keep_last`` steps; ``resume_from=<dir>`` resumes an
        aborted run from its latest checkpoint bit-identically;
        ``crash_after_saves`` raises
        :class:`repro_torch.engine.resilience.SimulatedCrash` after that
        many snapshots.  Checkpoint/resume is cohort-engine only."""
        if not isinstance(spec, ExperimentSpec):
            raise TypeError(f"Session.run takes an ExperimentSpec: {spec!r}")
        tb, b = spec.testbed, spec.run
        checkpoint = None
        if checkpoint_every is not None:
            if checkpoint_dir is None:
                raise ValueError(
                    "checkpoint_every requires checkpoint_dir (where the "
                    "step_*.npz snapshots go)")
            from repro_torch.engine.resilience import CheckpointPolicy
            checkpoint = CheckpointPolicy(
                directory=checkpoint_dir, every=checkpoint_every,
                keep_last=keep_last, crash_after_saves=crash_after_saves)
        self._materialize(tb)
        clients, params0 = self._clients, self._params0
        acc_fn, pooled = self._acc_fn, self._pooled
        self.events["runs"] += 1
        # route by the strategy's sync/async nature, not its name: the
        # robust fedavg variant is a barrier loop too
        strategy = spec.strategy.make()
        if spec.backend == "legacy":
            if checkpoint is not None or resume_from is not None:
                raise ValueError(
                    "checkpoint/resume requires backend='cohort' — the "
                    "legacy reference loop has no snapshot support")
            if spec.engine.mesh is not None:
                raise ValueError("mesh execution requires backend='cohort'")
            from repro_torch.core.server import run_async, run_fedavg
            arena = self._data_arena(tb)
            if not strategy.is_async:
                return run_fedavg(
                    clients, params0, acc_fn, pooled, rounds=b.rounds,
                    seed=tb.seed, eval_every=b.eval_every,
                    target_acc=b.target_acc, engine="legacy",
                    faults=tb.faults, strategy=strategy,
                    screening=tb.screening, data_arena=arena)
            return run_async(
                clients, params0, acc_fn, pooled, strategy,
                max_updates=b.max_updates, max_time=b.max_time, seed=tb.seed,
                eval_every=b.eval_every, target_acc=b.target_acc,
                engine="legacy", faults=tb.faults, screening=tb.screening,
                data_arena=arena)
        from repro_torch.engine.engine import (
            run_async_engine, run_fedavg_engine)
        runner = self._get_runner(tb, spec.engine)
        if not strategy.is_async:
            return run_fedavg_engine(
                clients, params0, acc_fn, pooled, rounds=b.rounds,
                seed=tb.seed, eval_every=b.eval_every,
                target_acc=b.target_acc, runner=runner, faults=tb.faults,
                checkpoint=checkpoint, resume_from=resume_from,
                strategy=strategy, screening=tb.screening)
        return run_async_engine(
            clients, params0, acc_fn, pooled, strategy,
            max_updates=b.max_updates, max_time=b.max_time, seed=tb.seed,
            eval_every=b.eval_every, target_acc=b.target_acc, runner=runner,
            faults=tb.faults, checkpoint=checkpoint, resume_from=resume_from,
            screening=tb.screening)

    def sweep(self, spec: ExperimentSpec, axes: dict) -> SweepResult:
        """Run the cartesian grid of ``spec`` with ``axes`` mapping dotted
        field paths to value lists; the LAST axis varies fastest, so put
        the expensive-to-change axis first."""
        if not axes:
            raise ValueError("sweep needs at least one axis")
        paths = list(axes)
        values = [list(axes[p]) for p in paths]
        for p, vs in zip(paths, values):
            if not vs:
                raise ValueError(f"sweep axis {p!r} has no values")
            replace_path(spec, p, vs[0])   # fail fast on bad paths/values
        result = SweepResult(base=spec, axes={p: list(v) for p, v in
                                              zip(paths, values)})
        grid = []
        for combo in itertools.product(*values):
            point = dict(zip(paths, combo))
            s = spec
            for p, v in point.items():
                s = replace_path(s, p, v)
            grid.append((point, s))
        # at most one step build per distinct build signature of the grid
        # (a sigma grid contributes one)
        from repro_torch.analysis.guard import compile_guard, sweep_max_builds
        budget = sweep_max_builds(s for _, s in grid)
        with compile_guard(budget, label="Session.sweep") as guard:
            for point, s in grid:
                t0 = time.perf_counter()
                _, log = self.run(s)
                result.points.append(point)
                result.specs.append(s)
                result.logs.append(log)
                result.wall_s.append(time.perf_counter() - t0)
        self.events["sweep_step_builds"] += guard.delta
        return result

    def stats(self) -> dict:
        """Cache telemetry: builds vs reuses per layer plus the run count."""
        return dict(self.events)
