"""Clean twin of rep005_bad: the hot regions read device values only
through the funnel, and a CUDA event's ``synchronize`` (a scheduling
barrier, not a transfer into Python) is sanctioned."""


def _host_fetch(runner, value):
    out = float(value)
    runner.note_host_sync()
    return out


def run_async_engine(runner, cohorts):
    acc = 0.0
    for cohort in cohorts:
        out = runner.step(cohort)
        acc += _host_fetch(runner, runner.fetch(out))
    return acc


def drain(runner, inflight):
    while len(inflight) > runner.depth:
        inflight.popleft().synchronize()


def summarize(out):
    # not a hot region: a host read here is fine
    return out.norm().item()
