"""Seeded REP005 violations: raw device->host reads inside engine hot
regions (the pipelined submit/drain loop must only block through the
``_host_fetch`` funnel at eval boundaries)."""
import numpy as np


def run_async_engine(runner, cohorts):
    acc = 0.0
    for cohort in cohorts:
        out = runner.step(cohort)
        acc += float(runner.fetch(out))     # float(<call>) blocks the host
        snapshot = np.asarray(out)          # so does np.asarray
        runner.record(snapshot, out.norm().item())
    return acc


def submit_cohort(runner, staged):
    runner.inflight.append(runner.step(staged))
    return runner.inflight[-1].cpu()


def stage_cohort(runner, plans):
    counts = runner.n_steps.tolist()
    return [p for p, n in zip(plans, counts) if n], runner.mask.numpy()
