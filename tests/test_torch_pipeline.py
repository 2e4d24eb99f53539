"""The pipelined scheduler and the host-fed data path of the PyTorch
port's cohort engine (``EngineConfig.pipeline_depth``,
``EngineConfig(device_arena=False)``).

* Pipelined runs (depth >= 2) equal the serial run bit for bit — params
  and every RunLog field — for async, windowed and FedAvg runs, and make
  no host sync between evals: ``host_syncs_between_evals == 0`` with
  ``Tensor.item``/``.cpu``/``.tolist``/``.numpy`` and the scalar
  conversions watched for calls outside the sanctioned buckets.
* ``stage_cohort`` then ``submit_cohort`` equals ``run_cohort``; the
  reference's ``pipeline_depth`` validation and messages; the caller's
  params stay readable and unchanged; a pipelined run resumes
  bit-identically.
* The host-fed path: bookkeeping and data-path counters (H2D bytes
  included) exactly equal to the JAX reference's host-fed run
  (``tests/_torch_ref_runs.py``), params within the run tolerance of
  ``tests/test_torch_engine_parity.py``, and bit-identical to the port's
  own arena path.
"""
import dataclasses
import json
import pathlib
import sys

import numpy as np
import pytest
import torch

import repro.engine as ref_engine
import repro_torch.engine.engine as engine_mod
from repro_torch.core.aggregation import FedAsync
from repro_torch.core.testbed import TestbedConfig, build_testbed
from repro_torch.data.synthetic_ser import SERDataConfig
from repro_torch.engine import (
    CheckpointPolicy, CohortRunner, EngineConfig, SimulatedCrash,
    run_async_engine, run_fedavg_engine)
from repro_torch.models.ser_cnn import SERConfig
from repro_torch.pytree import tree_leaves

sys.path.insert(0, str(pathlib.Path(__file__).parent))
import _torch_ref_runs as R  # noqa: E402

PARAMS_ATOL = 1e-2          # tests/test_torch_engine_parity.py
EXACT_FIELDS = ("times", "server_version", "update_counts", "staleness",
                "eps_trajectory", "cohort_sizes", "influence")
HOSTFED = ("hostfed_async", "hostfed_fedavg")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    with R.one_torch_thread():
        yield


@pytest.fixture(scope="module")
def ref_runs(tmp_path_factory):
    return R.run_reference(tmp_path_factory.mktemp("ref_runs"), HOSTFED)


def _cfg(sigma=0.5):
    return TestbedConfig(
        data=SERDataConfig(n_total=360, **R.DIMS),
        model=SERConfig(channels1=8, channels2=16, fc_dim=32, **R.DIMS),
        **dict(R.testbed_kwargs(sigma), dp_path="pallas"))


WINDOWED = dict(staleness_window=1e9, max_cohort=2)
MODES = {
    "async_w0": ("async", dict(staleness_window=0.0, max_cohort=2)),
    "async_window": ("async", WINDOWED),
    "fedavg": ("fedavg", dict(max_cohort=2)),
}


def _run(kind, ecfg, runner=None, sigma=0.5, **kw):
    cfg = _cfg(sigma)
    clients, params, acc_fn, pooled = build_testbed(cfg, device="cpu")
    if runner is not None:
        runner = runner(clients, ecfg)
    if kind == "fedavg":
        return run_fedavg_engine(clients, params, acc_fn, pooled, rounds=3,
                                 eval_every=2, seed=cfg.seed,
                                 engine_cfg=ecfg, runner=runner, **kw)
    return run_async_engine(clients, params, acc_fn, pooled,
                            FedAsync(alpha=0.4), max_updates=12,
                            eval_every=4, seed=cfg.seed, engine_cfg=ecfg,
                            runner=runner, **kw)


_CACHE = {}


def _cached(kind, **engine):
    key = (kind, tuple(sorted(engine.items())))
    if key not in _CACHE:
        _CACHE[key] = _run(kind, EngineConfig(**engine))
    return _CACHE[key]


def _fields(log, drop=()):
    out = {f: getattr(log, f) for f in R.LOG_FIELDS}
    out["engine_stats"] = {k: v for k, v in log.engine_stats.items()
                           if k not in drop}
    return json.loads(json.dumps(out))


def _bit_identical(a, b):
    return all(torch.equal(x, y)
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


# ---------------------------------------------------------------------------
# pipelined == serial, bit for bit
# ---------------------------------------------------------------------------

# the scheduler counters are what the two drivers report differently
_SCHED = ("pipeline_depth", "blocking_submits", "drain_waits",
          "host_syncs_between_evals")


@pytest.mark.parametrize("depth", [2, 3])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_pipelined_equals_serial_bitwise(mode, depth):
    kind, engine = MODES[mode]
    p_ser, log_ser = _cached(kind, **engine)
    p_pipe, log_pipe = _cached(kind, pipeline_depth=depth, **engine)
    assert _bit_identical(p_ser, p_pipe)
    assert _fields(log_ser, _SCHED) == _fields(log_pipe, _SCHED)
    st = log_pipe.engine_stats
    assert st["pipeline_depth"] == depth
    assert st["blocking_submits"] == 0
    assert st["host_syncs_between_evals"] == 0
    assert log_ser.engine_stats["blocking_submits"] == \
        log_ser.engine_stats["cohorts"]
    if mode == "async_window":
        assert max(log_pipe.cohort_sizes) == 2     # the window batched


def test_pipelined_drains_past_the_depth():
    """12 updates in K = 1 cohorts with evals every 4: three cohorts
    between evals, one over depth 2, so the loop waits on the oldest."""
    _, log = _cached("async", pipeline_depth=2,
                     **MODES["async_w0"][1])
    assert log.engine_stats["drain_waits"] > 0


_SYNC_METHODS = ("item", "tolist", "cpu", "numpy", "__float__", "__int__",
                 "__bool__")


def test_no_host_sync_between_evals(monkeypatch):
    """Every device->host read of a pipelined run happens inside an eval,
    a screen-verdict fetch or a store spill."""
    runners, outside = [], []

    def make_runner(clients, ecfg):
        runners.append(CohortRunner(clients, ecfg, "cpu"))
        return runners[-1]

    for name in _SYNC_METHODS:
        real = getattr(torch.Tensor, name)

        def watched(self, *a, _real=real, _name=name, **kw):
            r = runners[-1] if runners else None
            if r is not None and not (r._in_eval or r._in_screen
                                      or r._in_store):
                outside.append(_name)
            return _real(self, *a, **kw)

        monkeypatch.setattr(torch.Tensor, name, watched)
    fetches = []
    real_fetch = engine_mod._host_fetch

    def counting_fetch(runner, value):
        fetches.append(bool(runner._in_eval))
        return real_fetch(runner, value)

    monkeypatch.setattr(engine_mod, "_host_fetch", counting_fetch)
    p_pipe, log_pipe = _run("async", EngineConfig(pipeline_depth=2,
                                                  **WINDOWED),
                            runner=make_runner)
    monkeypatch.undo()
    assert fetches and all(fetches)
    assert outside == [], sorted(set(outside))
    st = log_pipe.engine_stats
    assert st["host_syncs_between_evals"] == 0
    assert st["blocking_submits"] == 0
    assert st["host_syncs_at_eval"] == len(fetches)
    p_ser, log_ser = _cached("async", **WINDOWED)
    assert _bit_identical(p_ser, p_pipe)
    assert _fields(log_ser, _SCHED) == _fields(log_pipe, _SCHED)


def test_pipelined_run_keeps_callers_params_readable_and_unchanged():
    cfg = _cfg()
    clients, params, acc_fn, pooled = build_testbed(cfg, device="cpu")
    before = [l.clone() for l in tree_leaves(params)]
    final, _ = run_async_engine(
        clients, params, acc_fn, pooled, FedAsync(alpha=0.4),
        max_updates=4, eval_every=4, seed=cfg.seed,
        engine_cfg=EngineConfig(pipeline_depth=2, **WINDOWED))
    for a, b in zip(before, tree_leaves(params)):
        assert torch.equal(a, b)
    assert not _bit_identical(params, final)


# ---------------------------------------------------------------------------
# scheduler plumbing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bad", [0, -1, 1.5])
def test_pipeline_depth_validated_like_reference(bad):
    assert EngineConfig().pipeline_depth == 1
    EngineConfig(pipeline_depth=2)
    with pytest.raises(ValueError, match="pipeline_depth") as port_err:
        EngineConfig(pipeline_depth=bad)
    with pytest.raises(ValueError) as ref_err:
        ref_engine.EngineConfig(pipeline_depth=bad)
    assert str(port_err.value) == str(ref_err.value)


@pytest.mark.parametrize("arena", [True, False], ids=["arena", "host"])
def test_stage_then_submit_equals_run_cohort(arena):
    """The split halves compose to exactly ``run_cohort``."""
    outs = []
    for split in (False, True):
        clients, params, _, _ = build_testbed(_cfg(), device="cpu")
        runner = CohortRunner(clients, EngineConfig(device_arena=arena),
                              "cpu")
        plans = [runner.dispatch(c, params, 11 + c.cid, 0)
                 for c in clients[:2]]
        if split:
            staged = runner.stage_cohort(plans)
            assert staged.k == 2 and staged.arena == arena
            assert all(p.batch_idx is not None for p in plans)
            out = runner.submit_cohort(staged)
        else:
            out = runner.run_cohort(plans)
        outs.append((out, runner.take_screen_handle()))
    assert _bit_identical(outs[0][0], outs[1][0])
    assert tree_leaves(outs[0][0])[0].shape[0] == 2
    assert _bit_identical(outs[0][1], outs[1][1])


def test_dispatch_defers_the_batch_plans_to_staging():
    clients, params, _, _ = build_testbed(_cfg(), device="cpu")
    runner = CohortRunner(clients, EngineConfig(), "cpu")
    state = clients[0].rng.bit_generator.state
    plan = runner.dispatch(clients[0], params, 5, 0)
    assert plan.batch_idx is None
    assert clients[0].rng.bit_generator.state == state
    runner.stage_cohort([plan])
    assert plan.batch_idx.shape == (plan.n_steps, clients[0].batch_size)
    assert clients[0].rng.bit_generator.state != state


def test_pipelined_resume_bit_identical(tmp_path):
    """A pipelined run resumes with only its in-flight window refilled:
    params and RunLog equal the uninterrupted run's, ``drain_waits``
    aside."""
    ecfg = EngineConfig(pipeline_depth=2, **MODES["async_w0"][1])
    plain = _cached("async", pipeline_depth=2, **MODES["async_w0"][1])
    with pytest.raises(SimulatedCrash):
        _run("async", ecfg, checkpoint=CheckpointPolicy(
            str(tmp_path), every=3, crash_after_saves=2))
    resumed = _run("async", ecfg, resume_from=str(tmp_path))
    assert _bit_identical(plain[0], resumed[0])
    drop = ("drain_waits",)
    assert _fields(plain[1], drop) == _fields(resumed[1], drop)


# ---------------------------------------------------------------------------
# the host-fed data path
# ---------------------------------------------------------------------------

def _hostfed_port(ref_runs, name):
    key = ("ref", name)
    if key not in _CACHE:
        _, params, log, _ = R.execute("repro_torch", name,
                                      ref_runs[name]["init"],
                                      dp_path="pallas", device="cpu")
        _CACHE[key] = (params, log)
    return _CACHE[key]


@pytest.mark.parametrize("name", HOSTFED)
def test_hostfed_bookkeeping_equals_reference(ref_runs, name):
    params, log = _hostfed_port(ref_runs, name)
    got = R.log_dict(log, [])
    want = ref_runs[name]["log"]
    for f in EXACT_FIELDS:
        assert got[f] == want[f], f
    assert got["sched"] == want["sched"]
    assert got["sched"]["data_path"] == "host"
    assert got["sched"]["h2d_bytes_total"] > 0


@pytest.mark.parametrize("name", HOSTFED)
def test_hostfed_params_within_run_tolerance(ref_runs, name):
    params, _ = _hostfed_port(ref_runs, name)
    for a, b in zip(ref_runs[name]["final"], tree_leaves(params)):
        assert np.isfinite(b.numpy()).all()
        np.testing.assert_allclose(a, b.numpy(), rtol=0, atol=PARAMS_ATOL)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_hostfed_equals_arena_path_bitwise(mode):
    """The same cohorts, the same kernels in the same order: only where
    the inputs were assembled differs."""
    kind, engine = MODES[mode]
    p_arena, log_arena = _cached(kind, **engine)
    p_host, log_host = _cached(kind, device_arena=False, **engine)
    assert _bit_identical(p_arena, p_host)
    drop = ("data_path", "h2d_bytes_total", "h2d_bytes_per_cohort")
    assert _fields(log_arena, drop) == _fields(log_host, drop)
    assert log_host.engine_stats["data_path"] == "host"
    assert (log_host.engine_stats["h2d_bytes_per_cohort"]
            > 10 * log_arena.engine_stats["h2d_bytes_per_cohort"])


def test_hostfed_pipelined_equals_serial():
    kind, engine = MODES["async_window"]
    p_ser, log_ser = _cached(kind, device_arena=False, **engine)
    p_pipe, log_pipe = _cached(kind, device_arena=False, pipeline_depth=2,
                               **engine)
    assert _bit_identical(p_ser, p_pipe)
    assert _fields(log_ser, _SCHED) == _fields(log_pipe, _SCHED)
    assert log_pipe.engine_stats["host_syncs_between_evals"] == 0


def test_hostfed_session_builds_no_data_arena():
    from repro_torch.api import ExperimentSpec, RunBudget, Session
    sess = Session(device="cpu")
    spec = ExperimentSpec(testbed=_cfg(),
                          run=RunBudget(max_updates=2, eval_every=2),
                          engine=EngineConfig(device_arena=False))
    _, log = sess.run(spec)
    assert log.engine_stats["data_path"] == "host"
    assert sess.stats().get("data_arena_builds", 0) == 0
    assert sess._runner.data_arena is None
    sess.run(dataclasses.replace(spec, engine=EngineConfig()))
    assert sess.stats()["data_arena_builds"] == 1
