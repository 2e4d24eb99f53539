"""Checkpoint/resume in the PyTorch port (``repro_torch.checkpoint``,
``repro_torch.engine.resilience``) against the JAX reference's.

* The durable flat-npz store keeps the reference's semantics
  (``tests/test_checkpoint_resume.py``): escaped keys, ``keep_last``
  pruning, torn ``.tmp`` files ignored, meta and dtypes round-tripped,
  and the policy's cadence.
* The on-disk format is the reference's: either package reads a store
  the other wrote, keys included.
* An aborted run resumed from its latest snapshot equals the
  uninterrupted port run bit for bit — params, every RunLog field and the
  engine's counters — on both loops, with faults and screening on.
* The refusals carry the reference's messages.
"""
import dataclasses
import os
import pathlib
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import repro.checkpoint as ref_ckpt
import repro.engine.resilience as ref_rez
from repro_torch.api import ExperimentSpec, RunBudget, Session, StrategySpec
from repro_torch.checkpoint import latest_step, load_flat, restore, save
from repro_torch.checkpoint.checkpoint import _step_files
from repro_torch.core.faults import FaultModel
from repro_torch.core.screening import ScreeningConfig
from repro_torch.core.testbed import TestbedConfig
from repro_torch.data.synthetic_ser import SERDataConfig
from repro_torch.engine import CheckpointPolicy, EngineConfig, SimulatedCrash
from repro_torch.models.ser_cnn import SERConfig
from repro_torch.optim.optimizers import Adam
from repro_torch.pytree import tree_leaves

sys.path.insert(0, str(pathlib.Path(__file__).parent))
import _torch_ref_runs as R  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    with R.one_torch_thread():
        yield


def _tiny(**kw):
    return TestbedConfig(
        data=SERDataConfig(n_total=360, **R.DIMS),
        model=SERConfig(channels1=8, channels2=16, fc_dim=32, **R.DIMS),
        **dict(R.testbed_kwargs(0.5), dp_path="pallas", **kw))


ASYNC_SPEC = ExperimentSpec(
    testbed=_tiny(faults=FaultModel(**R.FAULTS),
                  screening=ScreeningConfig(**R.SCREENING)),
    strategy=StrategySpec("fedasync", alpha=0.4),
    run=RunBudget(max_updates=12, eval_every=4),
    engine=EngineConfig(staleness_window=1e9, max_cohort=2))
FEDAVG_SPEC = ExperimentSpec(
    testbed=_tiny(faults=FaultModel(**R.FEDAVG_FAULTS),
                  screening=ScreeningConfig(**R.SCREENING)),
    strategy=StrategySpec("fedavg"), run=RunBudget(rounds=4, eval_every=2),
    engine=EngineConfig(max_cohort=2))


def _logdict(log):
    """Every RunLog field the bit-identity contract covers."""
    return dict(times=log.times, acc=log.global_acc,
                sv=log.server_version, uc=dict(log.update_counts),
                inf=log.influence, st=log.staleness,
                eps={k: list(v) for k, v in log.eps_trajectory.items()},
                la=log.local_acc, fe=list(log.fault_events),
                es=dict(log.engine_stats), cs=list(log.cohort_sizes),
                dr=dict(log.dropouts))


def _assert_identical(run_a, run_b):
    (p_a, log_a), (p_b, log_b) = run_a, run_b
    a, b = _logdict(log_a), _logdict(log_b)
    assert a == b, [k for k in a if a[k] != b[k]]
    for x, y in zip(tree_leaves(p_a), tree_leaves(p_b)):
        assert torch.equal(x, y)


def _session():
    return Session(device="cpu")


@pytest.fixture(scope="module")
def async_plain():
    return _session().run(ASYNC_SPEC)


@pytest.fixture(scope="module")
def fedavg_plain():
    return _session().run(FEDAVG_SPEC)


# ---------------------------------------------------------------------------
# the durable store
# ---------------------------------------------------------------------------

def test_store_escaped_keys_cannot_collide(tmp_path):
    d = str(tmp_path)
    tree = {"a": {"b": torch.full((3,), 1.0)}, "a/b": torch.full((3,), 2.0)}
    save(d, 0, tree)
    flat, _ = load_flat(d)
    assert sorted(flat) == ["a/b", "a\\/b"]
    got, _ = restore(d, {"a": {"b": torch.zeros(3)}, "a/b": torch.zeros(3)})
    assert torch.equal(got["a"]["b"], tree["a"]["b"])
    assert torch.equal(got["a/b"], tree["a/b"])


def test_store_keep_last_prunes_oldest(tmp_path):
    d = str(tmp_path)
    for step in (1, 2, 3, 4, 5):
        save(d, step, {"x": np.array([step])}, keep_last=3)
    assert _step_files(d) == [f"step_{s:08d}.npz" for s in (3, 4, 5)]
    assert latest_step(d) == 5
    with pytest.raises(ValueError, match="keep_last"):
        save(d, 6, {"x": np.zeros(1)}, keep_last=0)


def test_store_ignores_torn_tmp_files(tmp_path):
    d = str(tmp_path)
    save(d, 2, {"x": np.arange(4)})
    with open(os.path.join(d, "step_00000009.npz.tmp"), "wb") as f:
        f.write(b"torn")
    assert latest_step(d) == 2
    assert _step_files(d) == ["step_00000002.npz"]
    assert latest_step(str(tmp_path / "missing")) is None
    with pytest.raises(FileNotFoundError):
        load_flat(str(tmp_path / "empty_dir_that_is_missing"))


def test_store_meta_and_dtype_roundtrip(tmp_path):
    d = str(tmp_path)
    t = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
         "n": torch.tensor(7, dtype=torch.int32)}
    save(d, 4, t, meta={"kind": "unit", "t_virtual": 0.1 + 0.2})
    flat, meta = load_flat(d)
    assert meta == {"step": 4, "kind": "unit", "t_virtual": 0.1 + 0.2}
    np.testing.assert_array_equal(flat["w"], t["w"].numpy())
    got, _ = restore(d, {"w": torch.zeros((2, 3)),
                         "n": torch.tensor(0, dtype=torch.int32)})
    assert got["n"].dtype == torch.int32 and int(got["n"]) == 7
    got_np, _ = restore(d, {"w": np.zeros((2, 3), np.float64),
                            "n": np.array(0, np.int64)})
    assert got_np["w"].dtype == np.float64 and got_np["n"].dtype == np.int64


def test_checkpoint_policy_validation_and_cadence(tmp_path):
    with pytest.raises(ValueError, match="every"):
        CheckpointPolicy(directory=str(tmp_path), every=0)
    with pytest.raises(ValueError, match="keep_last"):
        CheckpointPolicy(directory=str(tmp_path), keep_last=0)
    p = CheckpointPolicy(directory=str(tmp_path), every=5)
    assert not p.due(4) and p.due(5) and p.due(7)
    p.mark(7)                      # resumed at step 7: next snapshot at 10
    assert not p.due(9) and p.due(10)


# ---------------------------------------------------------------------------
# one on-disk format for both packages
# ---------------------------------------------------------------------------

def _state_tree():
    """An optimizer state beside nested params: NamedTuple fields, sorted
    dict keys, a slash in a key and an int leaf."""
    params = {"conv1": {"w": torch.arange(6.0).reshape(2, 3),
                        "b": torch.ones(2)},
              "a/b": torch.full((2,), 3.0)}
    st = Adam().init(params)
    st = st._replace(step=torch.tensor(5, dtype=torch.int32))
    return {"params": params, "opt": st}


def test_reference_reads_the_ports_store(tmp_path):
    d = str(tmp_path)
    tree = _state_tree()
    save(d, 3, tree, meta={"kind": "x"})
    flat_r, meta_r = ref_ckpt.load_flat(d)
    flat_p, meta_p = load_flat(d)
    assert meta_r == meta_p == {"step": 3, "kind": "x"}
    assert sorted(flat_r) == sorted(flat_p)
    assert "opt/.mu/conv1/w" in flat_r and "params/a\\/b" in flat_r
    # the reference's restore against its own template types: a
    # NamedTuple of the reference's optimizer
    import jax.numpy as jnp
    from repro.optim.optimizers import Adam as RAdam
    ref_params = {"conv1": {"w": jnp.zeros((2, 3)), "b": jnp.zeros(2)},
                  "a/b": jnp.zeros(2)}
    got, _ = ref_ckpt.restore(d, {"params": ref_params,
                                  "opt": RAdam().init(ref_params)})
    np.testing.assert_array_equal(np.asarray(got["opt"].step), 5)
    np.testing.assert_array_equal(np.asarray(got["params"]["conv1"]["w"]),
                                  tree["params"]["conv1"]["w"].numpy())
    np.testing.assert_array_equal(np.asarray(got["params"]["a/b"]),
                                  tree["params"]["a/b"].numpy())


def test_port_reads_the_references_store(tmp_path):
    import jax.numpy as jnp
    from repro.optim.optimizers import Adam as RAdam
    d = str(tmp_path)
    ref_params = {"conv1": {"w": jnp.arange(6.0).reshape(2, 3),
                            "b": jnp.ones(2)},
                  "a/b": jnp.full((2,), 3.0)}
    ref_ckpt.save(d, 7, {"params": ref_params,
                         "opt": RAdam().init(ref_params)},
                  meta={"t": 0.1 + 0.2}, keep_last=2)
    flat_p, meta_p = load_flat(d)
    flat_r, _ = ref_ckpt.load_flat(d)
    assert meta_p == {"step": 7, "t": 0.1 + 0.2}
    assert sorted(flat_p) == sorted(flat_r)
    got, _ = restore(d, _state_tree())
    assert got["opt"].step.dtype == torch.int32 and int(got["opt"].step) == 0
    np.testing.assert_array_equal(got["params"]["conv1"]["w"].numpy(),
                                  np.arange(6.0).reshape(2, 3))
    assert torch.equal(got["params"]["a/b"], torch.full((2,), 3.0))


# ---------------------------------------------------------------------------
# engine abort/resume: bit-identical to the uninterrupted port run
# ---------------------------------------------------------------------------

def _crash_then_resume(spec, ckdir, every, crash_after):
    with pytest.raises(SimulatedCrash):
        _session().run(spec, checkpoint_every=every, checkpoint_dir=ckdir,
                       crash_after_saves=crash_after)
    assert latest_step(ckdir) is not None
    return _session().run(spec, checkpoint_every=every, checkpoint_dir=ckdir,
                          resume_from=ckdir)


def test_checkpointed_uninterrupted_run_matches_plain(tmp_path, async_plain):
    run = _session().run(ASYNC_SPEC, checkpoint_every=4,
                         checkpoint_dir=str(tmp_path), keep_last=2)
    _assert_identical(async_plain, run)
    assert len(_step_files(str(tmp_path))) == 2


def test_async_abort_resume_bit_identical(tmp_path, async_plain):
    resumed = _crash_then_resume(ASYNC_SPEC, str(tmp_path), every=4,
                                 crash_after=2)
    _assert_identical(async_plain, resumed)
    # the run exercised what the snapshot must carry
    log = async_plain[1]
    assert log.fault_events and log.engine_stats["screen_rejections"] > 0
    assert max(log.cohort_sizes) > 1


def test_fedavg_abort_resume_bit_identical(tmp_path, fedavg_plain):
    resumed = _crash_then_resume(FEDAVG_SPEC, str(tmp_path), every=1,
                                 crash_after=2)
    _assert_identical(fedavg_plain, resumed)
    assert fedavg_plain[1].fault_events


def test_personalized_resume_bit_identical(tmp_path):
    """Personal subtrees (clients' and pending plans') ride the snapshot."""
    spec = dataclasses.replace(
        ASYNC_SPEC, testbed=_tiny(personalized=True),
        engine=EngineConfig(staleness_window=0.0, max_cohort=2))
    plain = _session().run(spec)
    _assert_identical(plain, _crash_then_resume(spec, str(tmp_path),
                                                every=3, crash_after=1))


# ---------------------------------------------------------------------------
# refusals, with the reference's messages
# ---------------------------------------------------------------------------

def _ref_spec(spec):
    from repro.api.spec import ExperimentSpec as RSpec
    return RSpec.from_dict(spec.to_dict())


def _messages(fn_port, fn_ref):
    with pytest.raises(ValueError) as port_err:
        fn_port()
    with pytest.raises(ValueError) as ref_err:
        fn_ref()
    assert str(port_err.value) == str(ref_err.value)
    return str(port_err.value)


def test_checkpoint_every_requires_directory():
    from repro.api.session import Session as RSession
    msg = _messages(lambda: _session().run(ASYNC_SPEC, checkpoint_every=5),
                    lambda: RSession().run(_ref_spec(ASYNC_SPEC),
                                           checkpoint_every=5))
    assert "checkpoint_dir" in msg


@pytest.mark.parametrize("how", ["checkpoint", "resume"])
def test_legacy_backend_refuses_checkpoint(tmp_path, how):
    from repro.api.session import Session as RSession
    spec = dataclasses.replace(ASYNC_SPEC, backend="legacy")
    kw = (dict(checkpoint_every=5, checkpoint_dir=str(tmp_path))
          if how == "checkpoint" else dict(resume_from=str(tmp_path)))
    msg = _messages(lambda: _session().run(spec, **kw),
                    lambda: RSession().run(_ref_spec(spec), **kw))
    assert "legacy" in msg


def test_fedbuff_refuses_checkpoint(tmp_path):
    from repro.api.session import Session as RSession
    spec = dataclasses.replace(
        ASYNC_SPEC, strategy=StrategySpec("fedbuff", alpha=0.4,
                                          buffer_size=2))
    kw = dict(checkpoint_every=5, checkpoint_dir=str(tmp_path))
    msg = _messages(lambda: _session().run(spec, **kw),
                    lambda: RSession().run(_ref_spec(spec), **kw))
    assert "FedBuff" in msg


def test_resume_refuses_kind_and_fault_mismatch(tmp_path):
    """A FedAvg snapshot cannot seed an async loop, and the resuming spec
    must carry the same FaultModel-or-not; the reference's restore,
    reading the port's snapshot, refuses with the same words."""
    ckdir = str(tmp_path)
    with pytest.raises(SimulatedCrash):
        _session().run(FEDAVG_SPEC, checkpoint_every=1, checkpoint_dir=ckdir,
                       crash_after_saves=1)
    msg = _messages(
        lambda: _session().run(ASYNC_SPEC, resume_from=ckdir),
        lambda: ref_rez.restore_async(ckdir, None, None, None, None, None,
                                      [], {}))
    assert "kind" in msg
    no_faults = dataclasses.replace(
        FEDAVG_SPEC, testbed=dataclasses.replace(FEDAVG_SPEC.testbed,
                                                 faults=None))
    from repro.engine import StoreConfig as RStore
    ref_runner = SimpleNamespace(use_arena=True,
                                 cfg=SimpleNamespace(store=RStore()))
    msg = _messages(
        lambda: _session().run(no_faults, resume_from=ckdir),
        lambda: ref_rez.restore_fedavg(ckdir, ref_runner, [None] * 5,
                                       SimpleNamespace(strategy="fedavg"),
                                       None, None))
    assert "fault" in msg.lower()


def test_host_path_refuses_checkpoint(tmp_path):
    """The host-fed path keeps optimizer state on the clients: its first
    snapshot refuses, with the reference's ``_require_arena`` words."""
    spec = dataclasses.replace(
        ASYNC_SPEC, engine=EngineConfig(device_arena=False, max_cohort=2))
    msg = _messages(
        lambda: _session().run(spec, checkpoint_every=2,
                               checkpoint_dir=str(tmp_path)),
        lambda: ref_rez._require_arena(SimpleNamespace(use_arena=False)))
    assert "device-arena" in msg
    assert latest_step(str(tmp_path)) is None
