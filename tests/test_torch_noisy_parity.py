"""Run-level parity of the port's cohort engine with the JAX package at
sigma = 1, draw for draw.

The reference runs once per configuration in a subprocess
(``tests/_torch_ref_runs.py``: ``async_noisy`` and ``fedavg_noisy``,
through its ``dp_path="jnp"`` and ``"pallas"``, and ``fl_step_noisy``,
the production local round as the executor).  This process rebuilds
that run's noise with ``jax.random``, following its key chain:

1. ``PRNGKey(seed)``;
2. one split per dispatch, in dispatch order (the N startup dispatches,
   then one per re-dispatch for FedAsync; N per round for FedAvg);
3. one key per local step of a member, from its dispatch key: a split
   per step in turn (the cohort step), or one ``split(key, S)`` into the
   S steps' keys (the ``"fl_step"`` executor, ``repro.core.fl_step``);
4. one split per leaf of that step's key, then ``normal`` of the leaf's
   shape (``repro.pytree.tree_gaussian_vector_like``).

The port consumes one dispatch seed per reference split, in the same
order, so replaying its seed draws maps each dispatch seed to the
reference's key.  The port's runner takes those draws through
``CohortRunner(noise_streams=...)`` as sources ``(step, leaf, shape)``.
Bookkeeping must equal the reference's exactly.  The params must end
within the sigma = 0 bound of the same entries (5.4e-4 after 10 updates
or 2 rounds) and within ``TIGHT``, which a run whose draws are scaled by
0.95 fails.  The control runs the same configuration on the port's own
``torch.Generator`` noise and must land at least 100x farther away, which
shows that the bound sees the noise.
"""
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.core.aggregation import make_strategy
from repro_torch.core.client import SEED_HIGH
from repro_torch.core.testbed import TestbedConfig, build_testbed
from repro_torch.data.synthetic_ser import SERDataConfig
from repro_torch.engine.cohort import steps_per_round
from repro_torch.engine.cohort_step import draw_noise
from repro_torch.engine.engine import (
    CohortRunner, run_async_engine, run_fedavg_engine)
from repro_torch.models.ser_cnn import SERConfig
from repro_torch.pytree import tree_leaves, tree_map

sys.path.insert(0, str(pathlib.Path(__file__).parent))
import _torch_ref_runs as R  # noqa: E402

# (entry, dp_path); the reference refuses "pallas" with "fl_step"
CASES = (("async_noisy", "jnp"), ("async_noisy", "pallas"),
         ("fedavg_noisy", "jnp"), ("fedavg_noisy", "pallas"),
         ("fl_step_noisy", "jnp"))
BOUND = 5.4e-4          # the sigma = 0 bound of these entries (ROADMAP.md)
# the injected runs end 1.8e-07 to 2.4e-07 away on the CPU; draws scaled
# by 0.95 end 6.2e-04 away
TIGHT = 1e-5
FAULT_SCALE = 0.95
CONTROL_FACTOR = 100.0
EXACT_FIELDS = ("times", "server_version", "update_counts", "staleness",
                "eps_trajectory", "cohort_sizes", "influence")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    with R.one_torch_thread():
        yield


def _ref_name(entry, dp_path):
    return entry if dp_path == "jnp" else f"{entry}@{dp_path}"


def _ref_init():
    """The reference runs' initial params, built here the way the
    subprocess builds them (initialization involves no gradient, so no
    XLA flag is needed): the port's runs start from them while the
    reference runs."""
    from repro.core import testbed as rt
    from repro.data.synthetic_ser import SERDataConfig as RefData
    from repro.models.ser_cnn import SERConfig as RefModel
    cfg = rt.TestbedConfig(
        data=RefData(n_total=72 * R.COMMON["num_clients"], **R.DIMS),
        model=RefModel(channels1=8, channels2=16, fc_dim=32, **R.DIMS),
        **R.testbed_kwargs(1.0))
    return [np.array(l) for l in
            jax.tree_util.tree_leaves(rt.build_testbed(cfg)[1])]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``{"ref": the reference runs, "init": their initial leaves, (entry,
    dp_path, injected): the port's (params, log, sources)}``; the port
    runs while the reference processes do, one process per run."""
    names = [_ref_name(e, p) for e, p in CASES]
    started = R.start_reference(tmp_path_factory.mktemp("noisy_ref"),
                                names, jobs=len(names))
    try:
        init = _ref_init()
        out = {(e, p, inj): run_port(e, p, init, inj) for e, p in CASES
               for inj in (True, False)}
        # the member-major executors on the injected stream, the seam
        # given the port's own generators, and the planted fault
        for axis in ("map", "vmap"):
            out[axis] = run_port("async_noisy", "jnp", init, True,
                                 client_axis=axis)
        out["generators"] = run_port(
            "async_noisy", "jnp", init,
            lambda seed: torch.Generator("cpu").manual_seed(int(seed)))
        out["scaled"] = run_port("async_noisy", "jnp", init, True,
                                 scale=FAULT_SCALE)
    finally:
        out_ref = R.finish_reference(started)
    out.update(ref=out_ref, init=init)
    return out


def _cfg(entry, dp_path):
    kw = dict(R.testbed_kwargs(R.RUNS[entry]["sigma"]), dp_path=dp_path)
    return TestbedConfig(
        data=SERDataConfig(n_total=72 * kw["num_clients"], **R.DIMS),
        model=SERConfig(channels1=8, channels2=16, fc_dim=32, **R.DIMS),
        **kw)


def port_seed_order(entry, n_clients, seed) -> dict:
    """Each dispatch seed the port's loop draws -> its index in dispatch
    order, by replaying the loop's draws (``engine.py``: N at startup,
    then one per re-dispatch; N per FedAvg round)."""
    r = R.RUNS[entry]
    rng = np.random.default_rng(seed)
    if r["strategy"][0] == "fedavg":
        seeds = np.concatenate([rng.integers(0, SEED_HIGH, size=n_clients)
                                for _ in range(r["run"]["rounds"])])
    else:
        seeds = np.concatenate([
            rng.integers(0, SEED_HIGH, size=n_clients),
            [rng.integers(0, SEED_HIGH)
             for _ in range(4 * r["run"]["max_updates"])]])
    order = {int(s): i for i, s in enumerate(seeds)}
    assert len(order) == len(seeds)
    return order


class ReferenceSource:
    """A member's reference draws as the noise source ``source(step, leaf,
    shape)``: the member's dispatch key split once per local step in turn
    or, given ``n_local``, once into ``n_local`` step keys; each step's
    key split once per leaf, then ``normal`` of the leaf's shape, times
    ``scale``."""

    def __init__(self, key, n_leaves, n_local=None, scale=1.0):
        self.key, self.n_leaves, self.scale = key, n_leaves, scale
        self.chained = n_local is None
        self.leaf_keys = [] if self.chained else [
            jax.random.split(k, n_leaves)
            for k in jax.random.split(key, n_local)]

    def __call__(self, step, leaf, shape):
        while self.chained and len(self.leaf_keys) <= step:
            self.key, sub = jax.random.split(self.key)
            self.leaf_keys.append(jax.random.split(sub, self.n_leaves))
        z = jax.random.normal(self.leaf_keys[step][leaf], shape, jnp.float32)
        return self.scale * np.array(z)


def reference_sources(entry, seed, n_clients, n_leaves, n_local, scale):
    """The factory ``dispatch seed -> ReferenceSource`` of one run
    (``n_local``: the ``"fl_step"`` executor's step count, else None)."""
    order = port_seed_order(entry, n_clients, seed)
    key = jax.random.PRNGKey(seed)
    keys = []
    for _ in range(len(order)):
        key, sub = jax.random.split(key)
        keys.append(sub)
    used = []

    def factory(dispatch_seed):
        i = order[int(dispatch_seed)]
        used.append(i)
        return ReferenceSource(keys[i], n_leaves, n_local, scale)

    factory.used = used
    return factory


def run_port(entry, dp_path, init, injected, scale=1.0, **engine):
    """The entry on the port (CPU, the reference's initial params), its
    noise the reference's times ``scale`` (``injected`` True), its own
    generators' (False) or from ``injected`` itself (a factory);
    ``engine`` updates the entry's EngineConfig."""
    r = R.RUNS[entry]
    cfg = _cfg(entry, dp_path)
    clients, params0, acc_fn, pooled = build_testbed(cfg, device="cpu")
    params0 = R.port_params(init, params0)
    ecfg = R.engine_config("repro_torch", entry, **engine)
    if injected is True:
        # the "fl_step" executor's S: the runner's padded step count
        n_local = max(steps_per_round(c.n_train, c.batch_size,
                                      c.local_epochs) for c in clients)
        streams = reference_sources(
            entry, cfg.seed, len(clients), len(tree_leaves(params0)),
            n_local if ecfg.client_axis == "fl_step" else None, scale)
    else:
        streams = injected or None
    runner = CohortRunner(clients, ecfg, "cpu", noise_streams=streams)
    strategy = make_strategy(r["strategy"][0], **r["strategy"][1])
    if strategy.is_async:
        final, log = run_async_engine(
            clients, params0, acc_fn, pooled, strategy, seed=cfg.seed,
            engine_cfg=ecfg, runner=runner, **r["run"])
    else:
        final, log = run_fedavg_engine(
            clients, params0, acc_fn, pooled, strategy=strategy,
            seed=cfg.seed, engine_cfg=ecfg, runner=runner, **r["run"])
    return final, log, streams


def _distance(ref_leaves, params) -> float:
    return max(float(np.abs(a - b.numpy()).max())
               for a, b in zip(ref_leaves, tree_leaves(params)))


def _log_dict(log):
    return R.log_dict(log, [])


def test_port_started_from_the_reference_init(runs):
    for name, run in runs["ref"].items():
        for a, b in zip(run["init"], runs["init"]):
            assert np.array_equal(a, b), name


@pytest.mark.parametrize("entry,dp_path", CASES)
def test_bookkeeping_exactly_equal(runs, entry, dp_path):
    _, log, streams = runs[(entry, dp_path, True)]
    got, want = _log_dict(log), runs["ref"][_ref_name(entry, dp_path)]["log"]
    for f in EXACT_FIELDS:
        assert got[f] == want[f], f
    # every trained member drew from its own dispatch's reference key
    assert len(streams.used) == len(set(streams.used)) == sum(
        log.cohort_sizes)
    if entry != "fedavg_noisy":
        assert max(log.cohort_sizes) > 1          # the window batched


@pytest.mark.parametrize("entry,dp_path", CASES)
def test_params_within_the_sigma0_bound_and_control_far(runs, entry,
                                                        dp_path):
    ref = runs["ref"][_ref_name(entry, dp_path)]
    injected, _, _ = runs[(entry, dp_path, True)]
    own, own_log, _ = runs[(entry, dp_path, False)]
    d_inj, d_own = _distance(ref["final"], injected), _distance(
        ref["final"], own)
    print(f"{entry} {dp_path}: injected {d_inj:.3e}, own noise {d_own:.3e}")
    for leaf in tree_leaves(injected):
        assert np.isfinite(leaf.numpy()).all()
    assert d_inj <= BOUND
    assert d_inj <= TIGHT
    assert d_own >= CONTROL_FACTOR * d_inj
    # the control differs only in its draws
    assert _log_dict(own_log)["update_counts"] == ref["log"]["update_counts"]


def test_scaled_draws_fail_the_tight_limit(runs):
    """A noise-scale fault of 5% (the reference's draws times 0.95) keeps
    the bookkeeping but fails TIGHT."""
    ref = runs["ref"]["async_noisy"]
    params, log, _ = runs["scaled"]
    assert _log_dict(log)["update_counts"] == ref["log"]["update_counts"]
    d = _distance(ref["final"], params)
    print(f"async_noisy jnp, draws x {FAULT_SCALE}: {d:.3e}")
    assert d > TIGHT


@pytest.mark.parametrize("axis", ["map", "vmap"])
def test_member_major_executors_draw_the_injected_stream(runs, axis):
    """``"map"`` and ``"vmap"`` (z drawn before the vmap) take the same
    reference draws through the seam and land within the limits of the
    reference's ``"unroll"`` run."""
    ref = runs["ref"]["async_noisy"]
    params, log, _ = runs[axis]
    got = _log_dict(log)
    for f in EXACT_FIELDS:
        assert got[f] == ref["log"][f], f
    d = _distance(ref["final"], params)
    print(f"async_noisy {axis}: injected {d:.3e}")
    assert d <= BOUND
    assert d <= TIGHT


def test_generator_factory_is_the_default_bit_for_bit(runs):
    """A factory handing each member the generator the runner would seed
    itself gives the default run bit for bit."""
    a, log_a, _ = runs[("async_noisy", "jnp", False)]
    b, log_b, _ = runs["generators"]
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        assert torch.equal(x, y)
    assert _log_dict(log_a) == _log_dict(log_b)


def test_draw_noise_joins_a_source_leaf_by_leaf():
    """The cohort step's draws from a callable source: leaf j of step s in
    leaf order, one call per leaf; from a generator, the flat draw."""
    calls = []

    def source(step, leaf, shape):
        calls.append((step, leaf, shape))
        n = int(np.prod(shape))
        return (np.arange(n, dtype=np.float32).reshape(shape)
                + 100 * step + 10 * leaf)

    shapes = [(2, 3), (4,)]
    z = draw_noise(source, 1, shapes, "cpu")
    assert torch.equal(z, torch.cat([torch.arange(6.0) + 100,
                                     torch.arange(4.0) + 110]))
    assert calls == [(1, 0, (2, 3)), (1, 1, (4,))]
    gen, again = (torch.Generator("cpu").manual_seed(5) for _ in range(2))
    assert torch.equal(draw_noise(gen, 0, shapes, "cpu"),
                       torch.randn(10, generator=again))
    with pytest.raises(ValueError, match="expected"):
        draw_noise(lambda step, leaf, shape: np.zeros(3), 0, shapes, "cpu")
