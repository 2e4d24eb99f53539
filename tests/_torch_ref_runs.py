"""Reference (JAX) engine runs for ``tests/test_torch_engine_parity.py``.

Run as a script in a subprocess: ``python tests/_torch_ref_runs.py OUT``
writes ``OUT/<name>.npz`` (initial and final params, leaves in flat leaf
order) and ``OUT/<name>.json`` (the RunLog fields) for every entry of
:data:`RUNS`.  The parity test starts it with
``XLA_FLAGS=--xla_disable_hlo_passes=algsimp``: on the installed JAX,
XLA:CPU's algebraic simplifier miscompiles ``jit(vmap(grad))`` through
this tiny CNN's convolutions (wrong per-example conv-weight gradients),
and the flag has to be set before JAX starts, which only a fresh process
guarantees.
"""
import json
import pathlib
import sys

# tiny testbed of tests/test_dp_path_engine.py: 5 clients x 72 clips,
# 12x12 patches, B = 16, SERConfig(8, 16, 32)
DIMS = dict(time_frames=12, n_mels=12)
COMMON = dict(batch_size=16, num_clients=5, seed=3)
RUNS = {
    # name: (strategy, sigma, engine kwargs, run kwargs)
    "async_w0": ("fedasync", 0.0, dict(staleness_window=0.0, max_cohort=2),
                 dict(max_updates=10, eval_every=5)),
    "async_window": ("fedasync", 0.0,
                     dict(staleness_window=1e9, max_cohort=2),
                     dict(max_updates=10, eval_every=5)),
    "fedavg": ("fedavg", 0.0, dict(max_cohort=2),
               dict(rounds=2, eval_every=1)),
    "async_noisy": ("fedasync", 1.0,
                    dict(staleness_window=1e9, max_cohort=2),
                    dict(max_updates=10, eval_every=5)),
}
LOG_FIELDS = ("times", "global_acc", "server_version", "update_counts",
              "influence", "staleness", "eps_trajectory", "local_acc",
              "cohort_sizes")


def testbed_kwargs(sigma):
    return dict(COMMON, use_dp=True, sigma=sigma, dp_path="jnp")


def main(out_dir):
    import jax
    import numpy as np
    from repro.core.aggregation import FedAsync
    from repro.core.testbed import TestbedConfig, build_testbed
    from repro.data.synthetic_ser import SERDataConfig
    from repro.engine import EngineConfig, run_async_engine, run_fedavg_engine
    from repro.models.ser_cnn import SERConfig

    out = pathlib.Path(out_dir)
    for name, (strategy, sigma, ekw, rkw) in RUNS.items():
        cfg = TestbedConfig(
            data=SERDataConfig(n_total=72 * COMMON["num_clients"], **DIMS),
            model=SERConfig(channels1=8, channels2=16, fc_dim=32, **DIMS),
            **testbed_kwargs(sigma))
        clients, params0, acc_fn, pooled = build_testbed(cfg)
        ecfg = EngineConfig(**ekw)
        if strategy == "fedavg":
            params, log = run_fedavg_engine(
                clients, params0, acc_fn, pooled, seed=cfg.seed,
                engine_cfg=ecfg, **rkw)
        else:
            params, log = run_async_engine(
                clients, params0, acc_fn, pooled, FedAsync(alpha=0.4),
                seed=cfg.seed, engine_cfg=ecfg, **rkw)
        leaves = {}
        for tag, tree in (("init", params0), ("final", params)):
            for i, leaf in enumerate(jax.tree_util.tree_leaves(tree)):
                leaves[f"{tag}_{i}"] = np.asarray(leaf)
        np.savez(out / f"{name}.npz", **leaves)
        (out / f"{name}.json").write_text(json.dumps(
            {f: getattr(log, f) for f in LOG_FIELDS}))


if __name__ == "__main__":
    main(sys.argv[1])
