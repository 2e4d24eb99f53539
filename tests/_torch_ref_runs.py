"""Reference (JAX) runs for the port's run-level parity tests
(``tests/test_torch_*.py``).

Run as a script in a subprocess: ``python tests/_torch_ref_runs.py OUT
[NAME ...]`` writes ``OUT/<name>.npz`` (initial and final params, leaves
in flat leaf order) and ``OUT/<name>.json`` (the RunLog fields, the
engine's fault/screen counters and every ``ScreeningState.screen`` call
as ``[cid, t, finite, norm]``) for the named entries of :data:`RUNS`
(all of them without names).  The tests start it with
``XLA_FLAGS=--xla_disable_hlo_passes=algsimp``: on the installed JAX,
XLA:CPU's algebraic simplifier miscompiles ``jit(vmap(grad))`` through
this tiny CNN's convolutions (wrong per-example conv-weight gradients),
and the flag has to be set before JAX starts, which only a fresh process
guarantees.  :func:`run_reference` is the tests' side of it.
"""
import contextlib
import json
import os
import pathlib
import subprocess
import sys

# tiny testbed of tests/test_dp_path_engine.py: 5 clients x 72 clips,
# 12x12 patches, B = 16, SERConfig(8, 16, 32)
DIMS = dict(time_frames=12, n_mels=12)
COMMON = dict(batch_size=16, num_clients=5, seed=3)

# faults of every kind; corrupted uploads are all-NaN or scaled by 50,
# which puts their update norms at 4.2-5.2 against clean norms of
# 0.08-0.11 on this testbed, far on either side of the screen threshold
FAULTS = dict(seed=1, failure_prob=0.1, upload_loss_prob=0.2,
              late_prob=0.1, duplicate_prob=0.1, leave_prob=0.1,
              corrupt_prob=0.3, corrupt_scale=50.0)
FEDAVG_FAULTS = dict(FAULTS, seed=2, leave_prob=0.2, round_deadline_s=300.0,
                     min_quorum=2)
SCREEN_THRESHOLD = 1.0
SCREENING = dict(max_update_norm=SCREEN_THRESHOLD, quarantine_after=2)

_ASYNC = dict(max_updates=10, eval_every=5)
_W0 = dict(staleness_window=0.0, max_cohort=2)


def _run(strategy, sigma=0.0, engine=None, run=None, backend="cohort",
         faults=None, screening=None, personalized=False):
    """One entry: ``strategy`` is ``(name, kwargs)``; ``engine`` the
    EngineConfig kwargs; ``run`` the loop's budget kwargs."""
    return dict(strategy=strategy, sigma=sigma, engine=engine or {},
                run=run or dict(_ASYNC), backend=backend, faults=faults,
                screening=screening, personalized=personalized)


RUNS = {
    # the cohort engine's parity runs (tests/test_torch_engine_parity.py)
    "async_w0": _run(("fedasync", dict(alpha=0.4)), engine=_W0),
    "async_window": _run(("fedasync", dict(alpha=0.4)),
                         engine=dict(staleness_window=1e9, max_cohort=2)),
    "fedavg": _run(("fedavg", {}), engine=dict(max_cohort=2),
                   run=dict(rounds=2, eval_every=1)),
    "async_noisy": _run(("fedasync", dict(alpha=0.4)), sigma=1.0,
                        engine=dict(staleness_window=1e9, max_cohort=2)),
    # FedAvg at sigma = 1 (the port's mesh runs, tests/test_torch_mesh.py)
    "fedavg_noisy": _run(("fedavg", {}), sigma=1.0, engine=dict(max_cohort=2),
                         run=dict(rounds=2, eval_every=1)),
    # the legacy loop and the member-by-member strategies
    # (tests/test_torch_strategies.py)
    "legacy_async": _run(("fedasync", dict(alpha=0.4)), backend="legacy"),
    "legacy_fedavg": _run(("fedavg", {}), backend="legacy",
                          run=dict(rounds=2, eval_every=1)),
    "fedbuff_legacy": _run(("fedbuff", dict(alpha=0.4, buffer_size=3)),
                           backend="legacy"),
    "fedbuff_engine": _run(("fedbuff", dict(alpha=0.4, buffer_size=3)),
                           engine=dict(staleness_window=1e9, max_cohort=2)),
    # personalized clients at sigma = 0, held to the reference: the
    # overlay of the personal heads, their upload and local_acc
    "personal_async_legacy": _run(("fedasync", dict(alpha=0.4)),
                                  backend="legacy", personalized=True),
    "personal_async_engine": _run(("fedasync", dict(alpha=0.4)), engine=_W0,
                                  personalized=True),
    "personal_fedavg_legacy": _run(("fedavg", {}), backend="legacy",
                                   personalized=True,
                                   run=dict(rounds=2, eval_every=1)),
    "personal_fedavg_engine": _run(("fedavg", {}), personalized=True,
                                   engine=dict(max_cohort=2),
                                   run=dict(rounds=2, eval_every=1)),
    # sigma = 1 so that epsilon is finite and the budget stops some
    # clients mid-run (at sigma = 0 it is infinite after the first round)
    "adaptive_personal_legacy": _run(
        ("adaptive_async", dict(alpha=0.4, eps_target=6.0)), sigma=1.0,
        backend="legacy", personalized=True, run=dict(max_updates=20)),
    "adaptive_personal_engine": _run(
        ("adaptive_async", dict(alpha=0.4, eps_target=6.0)), sigma=1.0,
        engine=_W0, personalized=True, run=dict(max_updates=20)),
    # faults + screening on both backends (tests/test_torch_faults.py)
    "robust_async_engine": _run(
        ("fedasync_normbound", dict(alpha=0.4, norm_bound=0.1)), engine=_W0,
        faults=FAULTS, screening=SCREENING),
    "robust_async_legacy": _run(
        ("fedasync_normbound", dict(alpha=0.4, norm_bound=0.1)),
        backend="legacy", faults=FAULTS, screening=SCREENING),
    "robust_fedavg_engine": _run(
        ("fedavg_trimmed", dict(trim_frac=0.34)), engine=dict(max_cohort=2),
        run=dict(rounds=3, eval_every=1), faults=FEDAVG_FAULTS,
        screening=SCREENING),
    "robust_fedavg_legacy": _run(
        ("fedavg_trimmed", dict(trim_frac=0.34)), backend="legacy",
        run=dict(rounds=3, eval_every=1), faults=FEDAVG_FAULTS,
        screening=SCREENING),
    # the engine's other run modes (tests/test_torch_pipeline.py,
    # tests/test_torch_statestore.py): the host-fed data path, and a
    # pipelined tiered run whose hot set of 2 (with lookahead 2) evicts
    # and spills
    "hostfed_async": _run(("fedasync", dict(alpha=0.4)), engine=dict(
        staleness_window=1e9, max_cohort=2, device_arena=False)),
    "hostfed_fedavg": _run(("fedavg", {}), run=dict(rounds=2, eval_every=1),
                           engine=dict(max_cohort=2, device_arena=False)),
    "tiered_async": _run(("fedasync", dict(alpha=0.4)), run=dict(
        max_updates=12, eval_every=4), engine=dict(
        staleness_window=30.0, max_cohort=2, pipeline_depth=2,
        store=dict(hot_slots=2, lookahead=2))),
    # the production local round as the engine's executor
    # (tests/test_torch_engine_axes.py): 2 microbatches, each clipped to
    # norm 0.1, no noise, K = 2 cohorts
    "fl_step_clip": _run(("fedasync", dict(alpha=0.4)), engine=dict(
        staleness_window=1e9, max_cohort=2, client_axis="fl_step",
        fl_cfg=dict(num_clients=1, n_micro=2, local_lr=0.05, dp=dict(
            clip_norm=0.1, noise_multiplier=0.0,
            granularity="per_microbatch")))),
    # the same at noise multiplier 1, held draw for draw
    # (tests/test_torch_noisy_parity.py)
    "fl_step_noisy": _run(("fedasync", dict(alpha=0.4)), sigma=1.0,
                          engine=dict(
                              staleness_window=1e9, max_cohort=2,
                              client_axis="fl_step", fl_cfg=dict(
                                  num_clients=1, n_micro=2, local_lr=0.05,
                                  dp=dict(clip_norm=0.1, noise_multiplier=1.0,
                                          granularity="per_microbatch")))),
}
LOG_FIELDS = ("times", "global_acc", "server_version", "update_counts",
              "influence", "staleness", "eps_trajectory", "local_acc",
              "cohort_sizes", "fault_events")
COUNTER_PREFIXES = ("fault_", "screen_", "degraded_cohorts", "deadline_drops",
                    "store_")
# the data-path and scheduler counters (RunLog.engine_stats)
SCHED_KEYS = ("data_path", "cohorts", "h2d_bytes_total", "pipeline_depth",
              "blocking_submits", "drain_waits", "host_syncs_at_eval",
              "host_syncs_between_evals")


def testbed_kwargs(sigma):
    return dict(COMMON, use_dp=True, sigma=sigma, dp_path="jnp")


def execute(pkg, name, init_leaves=None, dp_path="jnp", device=None,
            engine=None, **run_kw):
    """Run entry ``name`` through package ``pkg`` ("repro" or
    "repro_torch") and its server frontends.  ``init_leaves`` (the
    reference's initial leaves) replace the port's initial params;
    ``engine`` updates the entry's EngineConfig kwargs (a ``mesh``, an
    executor) and ``run_kw`` goes to the loop (``checkpoint``,
    ``resume_from``).  Returns ``(params0, final_params, RunLog,
    screen_calls)``."""
    import importlib
    mod = lambda m: importlib.import_module(f"{pkg}.{m}")  # noqa: E731
    r = RUNS[name]
    cfg = mod("core.testbed").TestbedConfig(
        data=mod("data.synthetic_ser").SERDataConfig(
            n_total=72 * COMMON["num_clients"], **DIMS),
        model=mod("models.ser_cnn").SERConfig(
            channels1=8, channels2=16, fc_dim=32, **DIMS),
        personalized=r["personalized"],
        **dict(testbed_kwargs(r["sigma"]), dp_path=dp_path))
    kw = {} if device is None else dict(device=device)
    clients, params0, acc_fn, pooled = mod("core.testbed").build_testbed(
        cfg, **kw)
    if init_leaves is not None:
        params0 = port_params(init_leaves, params0)
    faults = (None if r["faults"] is None
              else mod("core.faults").FaultModel(**r["faults"]))
    screening = (None if r["screening"] is None
                 else mod("core.screening").ScreeningConfig(**r["screening"]))
    strategy = mod("core.aggregation").make_strategy(
        r["strategy"][0], **r["strategy"][1])
    server = mod("core.server")
    ecfg = engine_config(pkg, name, **(engine or {}))
    calls = []
    state_cls = mod("core.screening").ScreeningState
    screen = state_cls.screen

    def recorded(self, cid, t, finite, norm):
        calls.append([int(cid), float(t), bool(finite), float(norm)])
        return screen(self, cid, t, finite, norm)

    state_cls.screen = recorded
    try:
        common = dict(seed=cfg.seed, engine=r["backend"], faults=faults,
                      screening=screening, **r["run"], **run_kw)
        if r["backend"] == "cohort":
            common["engine_cfg"] = ecfg
        if strategy.is_async:
            final, log = server.run_async(clients, params0, acc_fn, pooled,
                                          strategy, **common)
        else:
            final, log = server.run_fedavg(clients, params0, acc_fn, pooled,
                                           strategy=strategy, **common)
    finally:
        state_cls.screen = screen
    return params0, final, log, calls


def engine_config(pkg, name, **engine):
    """Entry ``name``'s EngineConfig in package ``pkg``, its kwargs
    updated by ``engine``."""
    import importlib
    mod = lambda m: importlib.import_module(f"{pkg}.{m}")  # noqa: E731
    eng = dict(RUNS[name]["engine"], **engine)
    if "store" in eng:
        eng["store"] = mod("engine.statestore").StoreConfig(**eng["store"])
    if "fl_cfg" in eng:
        fl = dict(eng["fl_cfg"], dp=mod("core.dp").DPConfig(
            **eng["fl_cfg"]["dp"]))
        eng["fl_cfg"] = mod("core.fl_step").FLStepConfig(**fl)
    return mod("engine.engine").EngineConfig(**eng)


def log_dict(log, calls):
    """The RunLog fields, counters and screen calls as plain JSON data."""
    out = {f: getattr(log, f) for f in LOG_FIELDS}
    out["counters"] = {k: v for k, v in (log.engine_stats or {}).items()
                       if k.startswith(COUNTER_PREFIXES)}
    out["sched"] = {k: (log.engine_stats or {}).get(k) for k in SCHED_KEYS}
    out["screen_calls"] = calls
    return json.loads(json.dumps(out))


def split_name(name):
    """``"entry@pallas"`` -> ``("entry", "pallas")``; a bare entry name
    runs the reference's ``dp_path="jnp"``."""
    entry, _, dp_path = name.partition("@")
    return entry, dp_path or "jnp"


def main(out_dir, names):
    import jax
    import numpy as np

    out = pathlib.Path(out_dir)
    for name in names or RUNS:
        entry, dp_path = split_name(name)
        params0, params, log, calls = execute("repro", entry, dp_path=dp_path)
        leaves = {}
        for tag, tree in (("init", params0), ("final", params)):
            for i, leaf in enumerate(jax.tree_util.tree_leaves(tree)):
                leaves[f"{tag}_{i}"] = np.asarray(leaf)
        np.savez(out / f"{name}.npz", **leaves)
        (out / f"{name}.json").write_text(json.dumps(log_dict(log, calls)))


def start_reference(out, names, jobs=1):
    """Start the reference runs of ``names`` (entries of :data:`RUNS`,
    each optionally suffixed ``@pallas`` for the reference's fused DP
    path) in fresh processes with the XLA flag and return at once;
    :func:`finish_reference` waits for them.  ``jobs`` > 1 splits
    ``names`` into that many contiguous groups, a process each."""
    here = pathlib.Path(__file__).resolve()
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=str(here.parents[1] / "src"),
               XLA_FLAGS="--xla_disable_hlo_passes=algsimp")
    per = -(-len(names) // max(1, jobs))
    procs = [subprocess.Popen(
        [sys.executable, str(here), str(out), *names[i:i + per]], env=env,
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
        for i in range(0, len(names), per)]
    return out, list(names), procs


def finish_reference(started):
    """Wait for :func:`start_reference`'s processes (killing them all if
    one fails or times out) and load the runs as ``{name: {"init":
    leaves, "final": leaves, "log": dict}}``."""
    import numpy as np
    out, names, procs = started
    errs = []
    try:
        for proc in procs:
            errs.append(proc.communicate(timeout=900)[1])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for proc, err in zip(procs, errs):
        assert proc.returncode == 0, err[-4000:]
    runs = {}
    for name in names:
        arrs = np.load(pathlib.Path(out) / f"{name}.npz")
        n = sum(1 for k in arrs.files if k.startswith("init_"))
        runs[name] = {
            "init": [arrs[f"init_{i}"] for i in range(n)],
            "final": [arrs[f"final_{i}"] for i in range(n)],
            "log": json.loads((pathlib.Path(out) / f"{name}.json").read_text()),
        }
    return runs


def run_reference(out, names, jobs=1):
    """The tests' side: :func:`start_reference` then
    :func:`finish_reference`."""
    return finish_reference(start_reference(out, names, jobs))


@contextlib.contextmanager
def one_torch_thread():
    """Run the port's tiny-model CPU work on one intra-op thread: the suite
    runs in several worker processes at once, where PyTorch's default of
    one thread per core makes each tiny op wait on the others' threads."""
    import torch
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(old)


def port_params(init_leaves, template):
    """The reference's initial leaves as a port param dict shaped like
    ``template`` (leaves in flat, sorted-key order)."""
    import torch
    from repro_torch.pytree import tree_paths
    params = {}
    for path, leaf in zip(tree_paths(template), init_leaves):
        params.setdefault(path[0], {})[path[1]] = torch.from_numpy(
            leaf.copy())
    return params


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2:])
