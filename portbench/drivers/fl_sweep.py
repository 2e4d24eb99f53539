"""Driver of the ``fl_sweep`` traffic kind: the paper's privacy sweep
through ``repro_torch.api.Session`` (one Session, its points run with
``Session.run``, as ``Session.sweep`` runs them), the sigma grid repeated
back to back until the window's seconds have passed; the window closes
when the point in progress has finished.

Work: member local DP-SGD steps (one client's B-example step), counted
from each point's RunLog (members merged x the clients' local steps).

Check: one completed point, drawn from the seed, replayed by the plain
reference that the configuration names (``portbench/reference/
<reference>.py``, ``ser_fl.py`` for the SER CNN) from the same seeds.
Compared (the cell's limits file names them): the RunLog bookkeeping (cohorts, staleness, update counts,
eval times and versions, the accountant's epsilon within float64
rounding: mismatches, limit 0) and the final params (worst leaf: the
norm of the difference over the norm of the reference's change from the
initial params, or the median leaf's change where that is larger).  The
accuracies at the evals are read and printed, not compared: a clip on
the boundary flips one of a client's ~235 test clips under sound runs
and the control alike (PERF.md).
"""
from __future__ import annotations

import time

import numpy as np

from portbench.harness.runner import Work
from portbench.harness.runner import log as log_line

RATE = "member_steps_per_s"
# the accountant's epsilon is host float64 arithmetic, done otherwise by
# the reference: an entry further than this (relative) is a mismatch
EPS_RTOL = 1e-12


def small_seed(seed: int) -> int:
    """The run's seed folded into the 31-bit range every seeded part of
    the testbed accepts (the clock and RNG seeds multiply it)."""
    return int(seed) % (2 ** 31 - 1)


def specs(cell, seed: int):
    """The sweep's specs, one per sigma of the grid, in grid order."""
    from repro_torch.api import ExperimentSpec
    from repro_torch.api.spec import replace_path
    from repro_torch.core.testbed import TestbedConfig
    from repro_torch.data.synthetic_ser import SERDataConfig
    from repro_torch.engine.engine import EngineConfig
    from repro_torch.models.ser_cnn import SERConfig

    cfg, tr = cell.config, cell.traffic
    s = small_seed(seed)
    st = cfg["setting"]
    tb = TestbedConfig(
        num_clients=tr["num_clients"], batch_size=st["batch_size"],
        local_epochs=st["local_epochs"], lr=st["lr"],
        clip_norm=st["clip_norm"], sigma=tr["sigmas"][0],
        dp_path=st["dp_path"], partition=st["partition"], seed=s,
        data=SERDataConfig(n_total=tr["n_total"], seed=s, **cfg["data"]),
        model=SERConfig(**cfg["model"]))
    eng = EngineConfig(**tr["engine"])
    base = ExperimentSpec.from_legacy(
        tr["strategy"], tb, max_updates=tr["max_updates"],
        eval_every=tr["eval_every"], engine_cfg=eng, alpha=tr["alpha"],
        staleness_aware=tr["staleness_aware"])
    return [replace_path(base, "testbed.sigma", float(v))
            for v in tr["sigmas"]]


def setup(cell, seed, device):
    """The Session, its corpus and arenas, and every shape the window
    runs: one warm-up run of one cohort (the cohorts are all of the
    bucket ``max_cohort`` at this population) builds the cohort step,
    compiles the Triton kernels and runs an eval."""
    from repro_torch.api import Session
    from repro_torch.api.spec import replace_path
    sess = Session(device=device)
    grid = specs(cell, seed)
    warm = replace_path(grid[0], "run.max_updates",
                        cell.traffic["engine"]["max_cohort"])
    warm = replace_path(warm, "run.eval_every",
                        cell.traffic["engine"]["max_cohort"])
    sess.run(warm)
    return {"session": sess, "grid": grid, "points": [], "device": device}


def _member_steps(sess, log) -> int:
    """Members merged x local steps: every client of the testbed takes
    the same step count (checked)."""
    from repro_torch.engine.cohort import steps_per_round
    steps = {steps_per_round(c.n_train, c.batch_size, c.local_epochs)
             for c in sess._clients}
    if len(steps) != 1:
        raise RuntimeError(f"clients differ in local steps: {steps}")
    return steps.pop() * sum(log.cohort_sizes)


def marked(tracer):
    """Phase marks around the cohort runner's staging, submission and
    evals, from outside the program (its methods wrapped for the
    window); undone by calling the returned function."""
    from repro_torch.engine.engine import CohortRunner
    real = {n: getattr(CohortRunner, n)
            for n in ("stage_cohort", "submit_cohort", "eval_boundary")}
    evals = []

    def wrap(name):
        def call(self, *a, **kw):
            with tracer.phase(name):
                return real[name](self, *a, **kw)
        return call

    def boundary(self, inside):
        if inside:
            evals.append(time.perf_counter_ns())
        else:
            tracer.phases.append(("eval", evals.pop(),
                                  time.perf_counter_ns()))
        return real["eval_boundary"](self, inside)

    CohortRunner.stage_cohort = wrap("stage_cohort")
    CohortRunner.submit_cohort = wrap("submit_cohort")
    CohortRunner.eval_boundary = boundary

    def undo():
        for n, f in real.items():
            setattr(CohortRunner, n, f)
    return undo


def window(state, seconds, tracer):
    sess, grid = state["session"], state["grid"]
    undo = marked(tracer)
    try:
        return _window(state, sess, grid, seconds, tracer)
    finally:
        undo()


def _window(state, sess, grid, seconds, tracer):
    t0 = time.perf_counter()
    steps, i = [], 0
    cohorts = []
    while time.perf_counter() - t0 < seconds:
        spec = grid[i % len(grid)]
        t = time.perf_counter()
        with tracer.phase(f"point sigma={spec.testbed.sigma}"):
            params, log = sess.run(spec)
        log_line(f"point {i} sigma {spec.testbed.sigma}: "
                 f"{time.perf_counter() - t:.3f} s")
        steps.append(_member_steps(sess, log))
        cohorts.append(list(log.cohort_sizes))
        state["points"].append((i % len(grid), {
            a: {b: v.clone() for b, v in sub.items()}
            for a, sub in params.items()}, log))
        i += 1
        tracer.tick()
    s_max = sum(steps) // max(1, sum(map(sum, cohorts)))
    return Work(RATE, sum(steps), attempted=i, failed=0,
                counters={"point_cohorts": cohorts, "point_steps": steps,
                          "local_steps": s_max,
                          "batch_size": sess._clients[0].batch_size,
                          "max_cohort": grid[0].engine.max_cohort,
                          "model": grid[0].testbed.model})


def release(state):
    """Keep each point's grid index, params (host copies) and RunLog; drop
    the Session (clients, arenas, the cohort runner)."""
    points = [(j, {a: {b: v.detach().cpu() for b, v in sub.items()}
                   for a, sub in params.items()}, log)
              for j, params, log in state["points"]]
    state.clear()
    return {"points": points}


def _bookkeeping(log, ref) -> int:
    """Fields of the RunLog that differ from the reference's: the cohorts,
    versions, update counts, staleness, the eval times and the epsilon
    trajectory (its entries within EPS_RTOL)."""
    bad = 0
    for key in ("cohort_sizes", "server_version", "update_counts",
                "staleness"):
        bad += getattr(log, key) != ref[key]
    bad += not np.allclose(log.times, ref["times"], rtol=1e-12, atol=0)
    bad += not _eps_gap(log, ref) <= EPS_RTOL
    return int(bad)


def _eps_gap(log, ref) -> float:
    gap = 0.0
    for tier, got in log.eps_trajectory.items():
        want = ref["eps_trajectory"].get(tier, [])
        if len(got) != len(want):
            return float("inf")
        for a, b in zip(got, want):
            gap = max(gap, abs(a - b) / max(abs(b), 1e-300))
    return gap


def _acc_gap(log, ref) -> float:
    if len(log.global_acc) != len(ref["global_acc"]):
        return float("inf")
    gap = max((abs(a - b) for a, b in zip(log.global_acc,
                                          ref["global_acc"])), default=0.0)
    for tier, got in log.local_acc.items():
        want = ref["local_acc"].get(tier, [])
        if len(got) != len(want):
            return float("inf")
        gap = max([gap] + [abs(a - b) for a, b in zip(got, want)])
    return gap


def params_gap(got, ref, params0) -> float:
    """Worst leaf of |got - ref| / max(|ref - p0| of the leaf, the median
    leaf's |ref - p0|)."""
    diffs, moves = [], []
    for a in sorted(ref):
        for b in sorted(ref[a]):
            r = ref[a][b].double().cpu()
            diffs.append(float((got[a][b].double().cpu() - r).norm()))
            moves.append(float((r - params0[a][b].double().cpu()).norm()))
    med = float(np.median(moves))
    return max(d / max(m, med, 1e-30) for d, m in zip(diffs, moves))


def _reference(outputs, cell, seed, device) -> tuple:
    """The point the check draws from the seed, and the configuration's
    plain reference (its ``run_fedasync``) replayed over it from the same
    seeds; run once per outputs, for the readings and the control."""
    if "reference" not in outputs:
        ref_mod = cell.reference
        points = outputs["points"]
        rng = np.random.default_rng([int(seed), 1])
        j, got, log = points[int(rng.integers(len(points)))]
        s = small_seed(seed)
        tr = cell.traffic
        splits = ref_mod.client_splits(cell.config["data"], tr["n_total"],
                                       tr["num_clients"], s)
        sigma = float(tr["sigmas"][j])
        ref, ref_log, p0 = ref_mod.run_fedasync(cell.config, tr, s, sigma,
                                                device, splits)
        outputs["reference"] = (got, log, ref, ref_log, p0,
                                (s, sigma, splits))
    return outputs["reference"]


def _numbers(got, log, ref, ref_log, p0) -> dict:
    return {"bookkeeping_mismatches": _bookkeeping(log, ref_log),
            "params_gap": params_gap(got, ref, p0),
            "eps_rel_gap": _eps_gap(log, ref_log),
            "acc_gap": _acc_gap(log, ref_log)}


def readings(outputs, cell, seed, device) -> dict:
    """Every number the check reads (the limits file names the compared
    ones); none where no point completed."""
    if not outputs["points"]:
        return {}
    got, log, ref, ref_log, p0, _ = _reference(outputs, cell, seed, device)
    return _numbers(got, log, ref, ref_log, p0)


def control(outputs, cell, seed, device) -> dict:
    """The lower-precision control: the reference computed with TF32
    (the configuration states float32 with TF32 off) put in the
    program's place, on the point the check draws, read by the same
    comparison against the float32 reference."""
    import types

    import torch
    _, _, ref, ref_log, p0, (s, sigma, splits) = _reference(
        outputs, cell, seed, device)
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        low, low_log, _ = cell.reference.run_fedasync(
            cell.config, cell.traffic, s, sigma, device, splits)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags
    return _numbers(low, types.SimpleNamespace(**low_log), ref, ref_log, p0)
