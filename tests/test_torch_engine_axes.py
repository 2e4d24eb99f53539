"""The cohort engine's client-axis executors on the CPU (port of the
executor tests of ``tests/test_engine_parity.py``), on the tiny testbed
of ``tests/test_torch_engine_parity.py``.

* ``"map"`` is the ``"unroll"`` program in PyTorch: bit-identical params
  and RunLog.
* ``"vmap"`` draws each member's noise from its own generator before the
  vmap, once per live step, as ``"unroll"`` does: within 1e-5 of it at
  sigma = 1 with DP on, and with DP off under a plain-SGD client
  optimizer; equal bookkeeping.  (With DP off under Adam, the group norm
  after ``conv1`` leaves ``conv1.b`` a gradient of ~1e-8 rounding noise,
  which Adam's normalised step turns into +-lr moves that any
  summation-order difference flips, so that pairing holds only at the
  run tolerance; the reference's own test avoids it by being on XLA.)
* ``"fl_step"`` runs the production local round: with DP off,
  ``n_micro = 1`` and plain-SGD clients it is the simulation's math; with
  2 microbatches clipped per microbatch and no noise it is held to the
  JAX engine's ``"fl_step"`` run (``fl_step_clip`` in
  ``tests/_torch_ref_runs.py``) within 1e-5, bookkeeping equal.
* The reference's refusals, with its messages: ``"fl_step"`` without
  ``fl_cfg``, ``"fl_step"`` with ``dp_path="pallas"``, and the runner's
  "executed mechanism" check.
"""
import dataclasses
import inspect
import json
import pathlib
import sys

import numpy as np
import pytest
import torch

from repro_torch.core.aggregation import FedAsync
from repro_torch.core.dp import DPConfig
from repro_torch.core.fl_step import FLStepConfig
from repro_torch.core.testbed import TestbedConfig, build_testbed, run_experiment
from repro_torch.data.synthetic_ser import SERDataConfig
from repro_torch.engine import cohort_step
from repro_torch.engine.engine import (
    CohortRunner, EngineConfig, run_async_engine)
from repro_torch.models.ser_cnn import SERConfig
from repro_torch.optim.optimizers import SGD, Adam
from repro_torch.pytree import tree_leaves

sys.path.insert(0, str(pathlib.Path(__file__).parent))
import _torch_ref_runs as R  # noqa: E402

LOG_FIELDS = ("times", "server_version", "update_counts", "staleness",
              "eps_trajectory", "cohort_sizes", "influence", "global_acc")
WINDOWED = dict(staleness_window=1e9, max_cohort=4)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    with R.one_torch_thread():
        yield


def _cfg(sigma, **kw):
    tb = R.testbed_kwargs(sigma)
    tb.update(kw)
    return TestbedConfig(
        data=SERDataConfig(n_total=72 * tb["num_clients"], **R.DIMS),
        model=SERConfig(channels1=8, channels2=16, fc_dim=32, **R.DIMS),
        **tb)


def _run(strategy, cfg, client_opt=None, **engine):
    """One run on the CPU; ``client_opt`` replaces every client's
    optimizer."""
    kw = (dict(rounds=2) if strategy == "fedavg"
          else dict(max_updates=8, eval_every=4, alpha=0.4))
    if client_opt is None:
        return run_experiment(strategy, cfg, device="cpu",
                              engine_cfg=EngineConfig(**engine), **kw)
    from repro_torch.core.server import run_async, run_fedavg
    clients, params, acc_fn, pooled = build_testbed(cfg, device="cpu")
    for c in clients:
        c.opt = client_opt
    run = run_fedavg if strategy == "fedavg" else run_async
    if strategy != "fedavg":
        kw["strategy"] = FedAsync(alpha=kw.pop("alpha"))
    return run(clients, params, acc_fn, pooled, seed=cfg.seed,
               engine="cohort", engine_cfg=EngineConfig(**engine), **kw)


def _max_diff(a, b):
    return max(float((x - y).abs().max())
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def _same_log(a, b, acc_atol=0.0):
    for f in LOG_FIELDS:
        if f == "global_acc":
            np.testing.assert_allclose(a.global_acc, b.global_acc,
                                       atol=acc_atol)
        else:
            assert getattr(a, f) == getattr(b, f), f


@pytest.mark.parametrize("strategy", ["fedavg", "fedasync"])
def test_map_executor_is_bit_identical_to_unroll(strategy):
    cfg = _cfg(1.0)
    p_u, log_u = _run(strategy, cfg, **WINDOWED)
    p_m, log_m = _run(strategy, cfg, client_axis="map", **WINDOWED)
    for a, b in zip(tree_leaves(p_u), tree_leaves(p_m)):
        assert torch.equal(a, b)
    _same_log(log_u, log_m)
    assert log_m.engine_stats == log_u.engine_stats


@pytest.mark.parametrize("strategy", ["fedavg", "fedasync"])
def test_vmap_executor_matches_unroll(strategy):
    """DP off, plain-SGD clients: params within 1e-5, identical
    bookkeeping, K > 1 cohorts."""
    cfg = _cfg(0.0, use_dp=False)
    opt = SGD(lr=0.05)
    p_u, log_u = _run(strategy, cfg, opt, **WINDOWED)
    p_v, log_v = _run(strategy, cfg, opt, client_axis="vmap", **WINDOWED)
    assert max(log_v.cohort_sizes) > 1
    assert _max_diff(p_u, p_v) < 1e-5
    _same_log(log_u, log_v, acc_atol=1e-6)


@pytest.mark.parametrize("strategy", ["fedavg", "fedasync"])
def test_vmap_executor_dp_matches_unroll(strategy):
    """DP on at sigma = 1 (Adam clients): the same draws, so params within
    1e-5 and the privacy/participation bookkeeping exact."""
    cfg = _cfg(1.0)
    p_u, log_u = _run(strategy, cfg, **WINDOWED)
    p_v, log_v = _run(strategy, cfg, client_axis="vmap", **WINDOWED)
    assert _max_diff(p_u, p_v) < 1e-5
    _same_log(log_u, log_v, acc_atol=1e-6)


def test_vmap_masks_members_with_fewer_steps():
    """A cohort whose members run different step counts: the vmapped
    round masks the short members' trailing steps and draws no noise for
    them, so it equals the member loop."""
    cfg = _cfg(1.0)
    clients, params, _, _ = build_testbed(cfg, device="cpu")
    c0 = clients[0]
    out = {}
    for axis in ("unroll", "vmap"):
        step, _ = cohort_step.make_cohort_step(
            c0.loss_fn, c0.dp_cfg, c0.opt, arena=False, client_axis=axis)
        k, s_max, b = 3, 3, 4
        stacked = cohort_step.stack_trees([params] * k)
        opt = c0.opt.init(stacked, stack_shape=(k,))
        rng = np.random.default_rng(0)
        batches = {key: torch.from_numpy(np.stack([
            np.stack([v[rng.integers(0, len(v), b)] for _ in range(s_max)])
            for _ in range(k)])) for key, v in c0.data.items()}
        n_steps = np.array([3, 1, 2], np.int32)
        gens = [torch.Generator().manual_seed(s) for s in (7, 8, 9)]
        out[axis] = step(stacked, opt, batches, gens, n_steps,
                         torch.tensor([0.05]), torch.ones(k),
                         torch.from_numpy(n_steps))
        out[axis + "_next"] = [float(torch.randn(1, generator=g))
                               for g in gens]
    assert _max_diff(out["unroll"][0], out["vmap"][0]) < 1e-5
    assert _max_diff(out["unroll"][1], out["vmap"][1]) < 1e-5
    assert out["unroll_next"] == out["vmap_next"]


def test_fl_step_executor_matches_simulation():
    """DP off, ``n_micro=1`` and plain-SGD clients: the production round
    is the simulation's math, so it matches ``"unroll"`` with identical
    bookkeeping."""
    fl = FLStepConfig(
        num_clients=1, n_local=1, n_micro=1, local_lr=0.05,
        dp=DPConfig(clip_norm=1e9, noise_multiplier=0.0,
                    granularity="per_microbatch"))
    cfg = _cfg(0.0, use_dp=False)
    opt = SGD(lr=fl.local_lr)
    p_u, log_u = _run("fedasync", cfg, opt)
    p_f, log_f = _run("fedasync", cfg, opt, client_axis="fl_step",
                      fl_cfg=fl)
    assert _max_diff(p_u, p_f) < 1e-5
    _same_log(log_u, log_f, acc_atol=1e-6)


@pytest.fixture(scope="module")
def ref_runs(tmp_path_factory):
    return R.run_reference(tmp_path_factory.mktemp("ref_runs"),
                           ("fl_step_clip",))


def test_fl_step_executor_with_clipping_matches_reference(ref_runs,
                                                          monkeypatch):
    """Per-microbatch clipping active (2 microbatches, norm 0.1), sigma
    0, K = 2 cohorts: the engine glue (the microbatch split, the batch-mean
    loss, the step mask) gives params within 1e-5 of the JAX engine's and
    the same bookkeeping; the clip moved the result."""
    ref = ref_runs["fl_step_clip"]
    _, params, log, _ = R.execute("repro_torch", "fl_step_clip", ref["init"],
                                  device="cpu")
    for a, b in zip(ref["final"], tree_leaves(params)):
        np.testing.assert_allclose(b.numpy(), a, rtol=0, atol=1e-5)
    got = json.loads(json.dumps({f: getattr(log, f) for f in R.LOG_FIELDS}))
    for f in LOG_FIELDS:
        if f == "global_acc":
            np.testing.assert_allclose(got[f], ref["log"][f], atol=1e-6)
        else:
            assert got[f] == ref["log"][f], f
    assert max(log.cohort_sizes) > 1
    entry = R.RUNS["fl_step_clip"]
    fl = entry["engine"]["fl_cfg"]
    monkeypatch.setitem(R.RUNS, "fl_step_noclip", dict(entry, engine=dict(
        entry["engine"], fl_cfg=dict(fl, dp=dict(fl["dp"], clip_norm=1e9)))))
    _, unclipped, _, _ = R.execute("repro_torch", "fl_step_noclip",
                                   ref["init"], device="cpu")
    assert _max_diff(params, unclipped) > 1e-3


def test_fl_step_executor_runs_dp_rounds_reproducibly():
    """A coherent per-microbatch ``fl_cfg`` under DP clients: the round
    runs, moves the params, keeps the clients' optimizer state, and a
    rerun is bit-identical."""
    cfg = _cfg(1.0)
    fl = FLStepConfig(num_clients=1, n_micro=2, dp=DPConfig(
        clip_norm=1.0, noise_multiplier=1.0, granularity="per_microbatch"))
    runs = [_run("fedasync", cfg, client_axis="fl_step", fl_cfg=fl,
                 **WINDOWED) for _ in range(2)]
    for a, b in zip(tree_leaves(runs[0][0]), tree_leaves(runs[1][0])):
        assert torch.equal(a, b)
    _same_log(runs[0][1], runs[1][1])
    p_u, log_u = _run("fedasync", cfg, **WINDOWED)
    assert _max_diff(runs[0][0], p_u) > 0
    assert runs[0][1].eps_trajectory == log_u.eps_trajectory


def test_fl_step_executor_rejects_incoherent_dp_accounting():
    """The accountant charges the clients' dp_cfg; the fl_step executor
    executes fl_cfg.dp, so the runner refuses a config whose epsilon
    would not describe the executed mechanism, with the reference's
    message."""
    from repro.core.dp import DPConfig as RDPConfig
    from repro.core.fl_step import FLStepConfig as RFLStepConfig
    from repro.core.testbed import TestbedConfig as RTestbedConfig
    from repro.core.testbed import build_testbed as r_build_testbed
    from repro.data.synthetic_ser import SERDataConfig as RSERDataConfig
    from repro.engine import CohortRunner as RCohortRunner
    from repro.engine import EngineConfig as REngineConfig
    from repro.models.ser_cnn import SERConfig as RSERConfig

    clients, _, _, _ = build_testbed(_cfg(1.0), device="cpu")
    r_clients, _, _, _ = r_build_testbed(RTestbedConfig(
        data=RSERDataConfig(n_total=360, **R.DIMS),
        model=RSERConfig(channels1=8, channels2=16, fc_dim=32, **R.DIMS),
        **R.testbed_kwargs(1.0)))
    dp0 = dict(clip_norm=1.0, noise_multiplier=0.0,
               granularity="per_microbatch")
    with pytest.raises(ValueError, match="executed mechanism") as err:
        CohortRunner(clients, EngineConfig(client_axis="fl_step", fl_cfg=(
            FLStepConfig(num_clients=1, n_micro=1, dp=DPConfig(**dp0)))),
            "cpu")
    with pytest.raises(ValueError) as r_err:
        RCohortRunner(r_clients, REngineConfig(
            client_axis="fl_step", fl_cfg=RFLStepConfig(
                num_clients=1, n_micro=1, dp=RDPConfig(**dp0))))
    assert str(err.value) == str(r_err.value)
    coherent = FLStepConfig(num_clients=1, n_micro=1, dp=DPConfig(
        clip_norm=1.0, noise_multiplier=1.0, granularity="per_microbatch"))
    CohortRunner(clients, EngineConfig(client_axis="fl_step",
                                       fl_cfg=coherent), "cpu")


@pytest.mark.parametrize("case", ["no_fl_cfg", "pallas"])
def test_make_cohort_step_refusals_match_reference(case):
    from repro.core.dp import DPConfig as RDPConfig
    from repro.core.fl_step import FLStepConfig as RFLStepConfig
    from repro.engine.cohort_step import make_cohort_step as r_make
    from repro.optim.optimizers import Adam as RAdam
    kw = (dict(client_axis="fl_step") if case == "no_fl_cfg" else
          dict(client_axis="fl_step", dp_path="pallas"))
    with pytest.raises(ValueError) as err:
        cohort_step.make_cohort_step(
            lambda p, ex: 0.0, DPConfig(), Adam(),
            fl_cfg=None if case == "no_fl_cfg" else FLStepConfig(1), **kw)
    with pytest.raises(ValueError) as r_err:
        r_make(lambda p, ex: 0.0, RDPConfig(), RAdam(),
               fl_cfg=None if case == "no_fl_cfg" else RFLStepConfig(1),
               **kw)
    assert str(err.value) == str(r_err.value)
    assert ("FLStepConfig" if case == "no_fl_cfg"
            else "dp_path='pallas'") in str(err.value)


def test_pallas_path_overrides_the_member_major_executors():
    """With ``dp_path="pallas"`` the step-major fused executor runs
    whatever the member-major axis: ``"vmap"`` equals ``"unroll"`` bit
    for bit."""
    cfg = _cfg(1.0, dp_path="pallas")
    p_u, log_u = _run("fedasync", cfg, **WINDOWED)
    p_v, log_v = _run("fedasync", cfg, client_axis="vmap", **WINDOWED)
    for a, b in zip(tree_leaves(p_u), tree_leaves(p_v)):
        assert torch.equal(a, b)
    _same_log(log_u, log_v)


def test_fl_cfg_joins_the_step_cache_key():
    """Each executor and each ``fl_cfg`` is its own cache entry; a second
    runner over the same key builds nothing."""
    cohort_step.invalidate_step_cache()
    clients, _, _, _ = build_testbed(_cfg(0.0, use_dp=False), device="cpu")
    b0 = cohort_step.step_builds()
    fls = [FLStepConfig(num_clients=1, n_micro=1, local_lr=lr)
           for lr in (0.05, 0.1)]
    for ec in (EngineConfig(client_axis="vmap"),
               EngineConfig(client_axis="fl_step", fl_cfg=fls[0]),
               EngineConfig(client_axis="fl_step", fl_cfg=fls[1]),
               EngineConfig(client_axis="fl_step", fl_cfg=fls[0])):
        CohortRunner(clients, ec, "cpu")
    assert cohort_step.step_builds() == b0 + 3
    assert cohort_step.invalidate_step_cache() == 3


def test_client_axis_validated_in_one_place():
    """EngineConfig and make_cohort_step share one executor set and
    default."""
    from repro_torch.engine.cohort_step import CLIENT_AXES
    assert EngineConfig().client_axis == "unroll"
    for fn in (cohort_step.make_cohort_step, cohort_step.cached_cohort_step):
        assert inspect.signature(fn).parameters["client_axis"].default == \
            "unroll"
    with pytest.raises(ValueError, match="client_axis"):
        EngineConfig(client_axis="bogus")
    with pytest.raises(ValueError, match="client_axis"):
        cohort_step.make_cohort_step(lambda p, ex: 0.0, DPConfig(), Adam(),
                                     client_axis="bogus")
    assert set(CLIENT_AXES) == {"unroll", "map", "vmap", "fl_step"}


def test_only_the_mesh_still_names_item_14():
    """Every executor and a mesh are accepted, a model axis above 1 too
    (``tests/test_torch_model_axis_zoo.py`` runs one on gloo ranks): the
    loop's ``mesh=`` refuses only a mesh over ranks the process group
    does not have.  A mesh over no process group (W = 1) runs every
    executor bit for bit as without one."""
    from repro_torch.launch.mesh import HostMesh, make_host_mesh
    for axis in ("map", "vmap", "fl_step"):
        assert EngineConfig(client_axis=axis).client_axis == axis
    assert dataclasses.replace(
        EngineConfig(), fl_cfg=FLStepConfig(num_clients=4)).fl_cfg
    assert EngineConfig(mesh=make_host_mesh()).mesh == make_host_mesh()
    clients, params, acc_fn, pooled = build_testbed(_cfg(0.0), device="cpu")
    with pytest.raises(ValueError, match="spans 2 of the process group's 1"):
        run_async_engine(clients, params, acc_fn, pooled, FedAsync(),
                         max_updates=1, mesh=HostMesh(1, 2, world=1))
    cfg = _cfg(1.0)
    for axis in ("unroll", "vmap"):
        p_n, log_n = _run("fedasync", cfg, client_axis=axis, **WINDOWED)
        p_m, log_m = _run("fedasync", cfg, client_axis=axis,
                          mesh=make_host_mesh(), **WINDOWED)
        for a, b in zip(tree_leaves(p_n), tree_leaves(p_m)):
            assert torch.equal(a, b)
        _same_log(log_n, log_m)
