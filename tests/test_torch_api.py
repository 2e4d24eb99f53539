"""The declarative API of the PyTorch port (``repro_torch.api``):
``ExperimentSpec`` / ``Session`` against the JAX reference's.

* The codec reads the reference's ``to_dict()`` JSON unchanged: every
  ``_SPEC_TYPES`` case of ``tests/test_spec_codec_complete.py`` (an
  instance with every field off its default) decodes and re-encodes to
  an equal dict — with its mesh dropped: a spec carrying a mesh, the one
  engine feature the port does not have yet, raises, naming its
  ROADMAP.md item.  A bounded store, ``pipeline_depth`` > 1, the host
  data path, another client axis and an ``fl_cfg`` decode and run.
* Runs inside one warm ``Session`` equal fresh-process runs bit for bit
  (params and every RunLog field).
* A warm 4-point sigma sweep adds 0 to ``step_builds()``; a cold one
  builds one step (the budget ``sweep_max_builds`` gives it).
* The quickstart's config (``examples/quickstart.py``) runs through
  ``Session`` on the CPU, depth cut to one round / three updates.
"""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

import repro.api.spec as ref_spec
from repro_torch.api import ExperimentSpec, RunBudget, Session, StrategySpec
from repro_torch.api.spec import _SPEC_TYPES, decode, encode
from repro_torch.core.faults import FaultModel
from repro_torch.core.screening import ScreeningConfig
from repro_torch.core.testbed import TestbedConfig
from repro_torch.data.synthetic_ser import SERDataConfig
from repro_torch.engine import cohort_step
from repro_torch.engine.engine import EngineConfig
from repro_torch.models.ser_cnn import SERConfig
from repro_torch.pytree import tree_leaves

TESTS = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(TESTS))
import _torch_ref_runs as R  # noqa: E402
import test_spec_codec_complete as C  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    with R.one_torch_thread():
        yield

LOG_FIELDS = ("strategy", "times", "global_acc", "server_version",
              "update_counts", "influence", "staleness", "eps_trajectory",
              "local_acc", "cohort_sizes", "fault_events", "engine_stats")
UNPORTED_ENGINE = ("EngineConfig", "ExperimentSpec")   # their cases carry a mesh


def _ref_json(obj):
    return json.loads(json.dumps(ref_spec.encode(obj)))


# ---------------------------------------------------------------------------
# the codec
# ---------------------------------------------------------------------------

def test_codec_has_the_reference_types():
    assert sorted(_SPEC_TYPES) == sorted(ref_spec._SPEC_TYPES)
    for name, cls in _SPEC_TYPES.items():
        assert [f.name for f in dataclasses.fields(cls)] == \
            [f.name for f in dataclasses.fields(ref_spec._SPEC_TYPES[name])]


@pytest.mark.parametrize("name", sorted(ref_spec._SPEC_TYPES))
def test_decodes_reference_json_of_every_spec_type(name):
    inst = C._nondefault_instance(ref_spec._SPEC_TYPES[name])
    if name == "EngineConfig":
        inst = dataclasses.replace(inst, fl_cfg=C._nondefault_instance(
            ref_spec._SPEC_TYPES["FLStepConfig"]))
    elif name == "ExperimentSpec":
        inst = dataclasses.replace(
            inst, engine=dataclasses.replace(inst.engine, mesh=None))
    d = _ref_json(inst)
    got = decode(d)
    assert type(got).__name__ == name
    assert encode(got) == d


@pytest.mark.parametrize("name", UNPORTED_ENGINE)
def test_default_engine_config_still_round_trips(name):
    """The spec round trip keeps the mesh: the reference's JSON of a
    spec whose engine carries its host mesh decodes to the port's host
    mesh of the same axes and encodes back to the same JSON."""
    from repro_torch.launch.mesh import HostMesh
    inst = C._nondefault_instance(ref_spec._SPEC_TYPES[name])
    engine_cfg = C._nondefault_instance(ref_spec._SPEC_TYPES["EngineConfig"])
    inst = (engine_cfg if name == "EngineConfig"
            else dataclasses.replace(inst, engine=engine_cfg))
    d = _ref_json(inst)
    assert (d if name == "EngineConfig" else d["engine"])["mesh"] == {
        "__mesh__": {"data": 1, "model": 1}}
    got = decode(d)
    mesh = got.mesh if name == "EngineConfig" else got.engine.mesh
    assert isinstance(mesh, HostMesh)
    assert encode(got) == d
    if name == "ExperimentSpec":
        assert ExperimentSpec.from_dict(d) == got


@pytest.mark.parametrize("field,value,item", [
    ("mesh", {"__mesh__": {"data": 1, "model": 2}}, 19)])
def test_unported_engine_features_raise_at_decode(field, value, item):
    """A spec mesh decodes (clamped to the process group, as the
    reference clamps it to its devices).  A model axis above 1 runs
    (``tests/test_torch_model_axis_zoo.py`` runs ``Session.run`` on (1, 2)
    and (2, 2) gloo meshes); a mesh over ranks that the process group
    does not have raises when the run starts."""
    from repro_torch.launch.mesh import HostMesh
    d = _ref_json(ref_spec.ExperimentSpec())
    d["engine"][field] = value
    spec = decode(d)
    assert spec.engine.mesh.shape == {"data": 1, "model": 1}
    spec = dataclasses.replace(spec, engine=dataclasses.replace(
        spec.engine, mesh=HostMesh(1, 2, world=1)))
    with pytest.raises(ValueError, match="spans 2 of the process group's 1"):
        Session(device="cpu").run(spec)


@pytest.mark.parametrize("field,value", [
    ("store", {"__type__": "StoreConfig", "hot_slots": 2, "lookahead": 2}),
    ("pipeline_depth", 2),
    ("device_arena", False),
    ("client_axis", "vmap"),
    ("fl_cfg", "__fl__")])
def test_ported_engine_features_decode_and_run(field, value):
    """The reference's JSON of a tiered, a pipelined, a host-fed, a
    vmapped and a production-round (``client_axis="fl_step"`` with a
    coherent ``fl_cfg``) spec decodes, re-encodes equal, and runs on the
    tiny testbed."""
    d = _ref_json(ref_spec.ExperimentSpec(
        testbed=ref_spec._SPEC_TYPES["TestbedConfig"](),
        run=ref_spec.RunBudget(max_updates=2, eval_every=2)))
    testbed = _tiny()
    if value == "__fl__":
        value = _ref_json(ref_spec._SPEC_TYPES["FLStepConfig"](
            num_clients=1, n_micro=2, dp=ref_spec._SPEC_TYPES["DPConfig"](
                clip_norm=1.0, noise_multiplier=0.5,
                granularity="per_microbatch")))
        d["engine"]["client_axis"] = "fl_step"
        testbed = dataclasses.replace(testbed, dp_path="jnp")
    d["engine"][field] = value
    d["engine"]["max_cohort"] = 2
    spec = decode(d)
    assert encode(spec) == d
    spec = dataclasses.replace(spec, testbed=testbed)
    _, log = Session(device="cpu").run(spec)
    st = log.engine_stats
    assert sum(log.update_counts.values()) == 2
    assert st["pipeline_depth"] == spec.engine.pipeline_depth
    assert st["data_path"] == ("arena" if spec.engine.device_arena
                               else "host")
    assert (st["store_fetches"] > 0) == (field == "store")


def test_use_kernel_migrates_to_dp_path():
    for flag, path in ((True, "pallas"), (False, "jnp")):
        d = encode(TestbedConfig())
        del d["dp_path"]
        d["use_kernel"] = flag
        assert decode(d).dp_path == path


def test_strategy_spec_validates_like_reference():
    assert StrategySpec("FedAsync", alpha=0.3).name == "fedasync"
    for bad in (dict(name="fedasync", beta=1.0),
                dict(name="fedavg_trimmed", trim_frac=0.6)):
        kw = dict(bad)
        name = kw.pop("name")
        with pytest.raises(ValueError) as ref_err:
            ref_spec.StrategySpec(name, **kw)
        with pytest.raises(ValueError) as port_err:
            StrategySpec(name, **kw)
        assert str(port_err.value) == str(ref_err.value)
    assert RunBudget(eval_every=0).eval_every == 1


# ---------------------------------------------------------------------------
# sessions: warm runs equal fresh-process runs
# ---------------------------------------------------------------------------

def _tiny(**kw):
    return TestbedConfig(
        data=SERDataConfig(n_total=360, **R.DIMS),
        model=SERConfig(channels1=8, channels2=16, fc_dim=32, **R.DIMS),
        **dict(R.testbed_kwargs(0.5), dp_path="pallas", **kw))


def _specs():
    tb = _tiny(faults=FaultModel(**R.FAULTS),
               screening=ScreeningConfig(**R.SCREENING))
    windowed = EngineConfig(staleness_window=1e9, max_cohort=2)
    return {
        "engine": ExperimentSpec(
            testbed=tb, strategy=StrategySpec("fedasync", alpha=0.4),
            run=RunBudget(max_updates=8, eval_every=4), engine=windowed),
        "legacy": ExperimentSpec(
            testbed=_tiny(personalized=True),
            strategy=StrategySpec("fedbuff", buffer_size=2),
            run=RunBudget(max_updates=6, eval_every=3), backend="legacy"),
        "fedavg": ExperimentSpec(
            testbed=tb, strategy=StrategySpec("fedavg_trimmed"),
            run=RunBudget(rounds=2), engine=windowed),
    }


_FRESH = '''
import json, sys
import numpy as np
import torch
torch.set_num_threads(1)       # as the session under test
from repro_torch.api import ExperimentSpec, Session
from repro_torch.pytree import tree_leaves
specs = json.loads(open(sys.argv[1]).read())
for name, d in specs.items():
    params, log = Session(device="cpu").run(ExperimentSpec.from_dict(d))
    np.savez(sys.argv[2] + name + ".npz",
             *[l.numpy() for l in tree_leaves(params)])
    with open(sys.argv[2] + name + ".json", "w") as f:
        json.dump({k: getattr(log, k) for k in %r}, f)
''' % (LOG_FIELDS,)


@pytest.fixture(scope="module")
def fresh_runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("fresh")
    specs = {k: s.to_dict() for k, s in _specs().items()}
    (out / "specs.json").write_text(json.dumps(specs))
    env = dict(os.environ, PYTHONPATH=str(TESTS.parent / "src"))
    res = subprocess.run([sys.executable, "-c", _FRESH, str(out / "specs.json"),
                          str(out) + "/"], env=env, capture_output=True,
                         text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    runs = {}
    for name in specs:
        arrs = np.load(out / f"{name}.npz")
        runs[name] = ([arrs[f"arr_{i}"] for i in range(len(arrs.files))],
                      json.loads((out / f"{name}.json").read_text()))
    return runs


@pytest.fixture(scope="module")
def warm_session():
    """One session that has run other scenarios first (another sigma, a
    legacy run) and then each spec twice."""
    sess = Session(device="cpu")
    specs = _specs()
    sess.run(dataclasses.replace(
        specs["engine"], testbed=dataclasses.replace(
            specs["engine"].testbed, sigma=1.5)))
    out = {}
    for rep in range(2):
        for name, spec in specs.items():
            out[(name, rep)] = sess.run(spec)
    return sess, out


@pytest.mark.parametrize("rep", [0, 1])
@pytest.mark.parametrize("name", ["engine", "legacy", "fedavg"])
def test_session_run_equals_fresh_process_run(fresh_runs, warm_session,
                                              name, rep):
    params, log = warm_session[1][(name, rep)]
    want_leaves, want_log = fresh_runs[name]
    for a, b in zip(want_leaves, tree_leaves(params)):
        assert np.array_equal(a, b.numpy(), equal_nan=True)
    got = json.loads(json.dumps({k: getattr(log, k) for k in LOG_FIELDS}))
    assert got == want_log
    if name != "legacy":
        assert log.engine_stats["fault_corruptions"] > 0


def test_session_reuses_its_layers(warm_session):
    ev = warm_session[0].stats()
    assert ev["partition_builds"] == 1
    assert ev["data_arena_builds"] == 1 and ev["data_arena_reuses"] >= 1
    assert ev["runner_reuses"] >= 1 and ev["testbed_reuses"] >= 1
    assert ev["runs"] == 7


def test_warm_sigma_sweep_builds_no_step():
    cohort_step.invalidate_step_cache()
    spec = ExperimentSpec(testbed=_tiny(),
                          strategy=StrategySpec("fedasync", alpha=0.4),
                          run=RunBudget(max_updates=4, eval_every=2),
                          engine=EngineConfig(staleness_window=1e9))
    sess = Session(device="cpu")
    axes = {"testbed.sigma": [0.5, 1.0, 1.5, 2.0]}
    b0 = cohort_step.step_builds()
    cold = sess.sweep(spec, axes)
    assert cohort_step.step_builds() - b0 == 1
    b1 = cohort_step.step_builds()
    warm = sess.sweep(spec, axes)
    assert cohort_step.step_builds() == b1
    assert sess.stats()["sweep_step_builds"] == 1
    assert [r["sigma"] for r in warm.table()] == axes["testbed.sigma"]
    for a, b in zip(cold.logs, warm.logs):
        assert a.eps_trajectory == b.eps_trajectory
        assert a.global_acc == b.global_acc
    assert len({tuple(log.eps_trajectory["HW_T5"]) for log in warm.logs}) == 4


def test_sweep_guard_fails_a_rebuild_leak(monkeypatch):
    from repro_torch.analysis import guard
    monkeypatch.setattr(guard, "sweep_max_builds", lambda specs: 0)
    cohort_step.invalidate_step_cache()
    spec = ExperimentSpec(testbed=_tiny(), run=RunBudget(max_updates=2,
                                                         eval_every=2))
    with pytest.raises(guard.CompileBudgetExceeded, match="budgeted for 0"):
        Session(device="cpu").sweep(spec, {"testbed.sigma": [0.5, 1.0]})


def test_step_signature_matches_reference():
    from repro.analysis import guard as ref_guard
    from repro_torch.analysis import guard
    grid_p = [ExperimentSpec(testbed=_tiny(sigma=s)) for s in (0.0, 0.5, 2.0)]
    grid_r = [ref_spec.ExperimentSpec.from_dict(s.to_dict()) for s in grid_p]
    assert guard.sweep_max_builds(grid_p) == \
        ref_guard.sweep_max_builds(grid_r) == 2
    legacy = dataclasses.replace(grid_p[0], backend="legacy")
    assert guard.step_signature(legacy) is None


def test_quickstart_config_runs_through_session():
    """examples/quickstart.py's testbed (the paper's CNN, 1,600 clips,
    B = 64, sigma = 1) through ``Session.sweep`` over its two strategies
    on the CPU, depth cut to one FedAvg round and three FedAsync updates."""
    cfg = TestbedConfig(use_dp=True, sigma=1.0, batch_size=64,
                        data=SERDataConfig(n_total=1600), seed=0)
    spec = ExperimentSpec(testbed=cfg,
                          run=RunBudget(rounds=1, max_updates=3,
                                        eval_every=1))
    res = Session(device="cpu").sweep(spec, {"strategy": [
        StrategySpec("fedavg"), StrategySpec("fedasync", alpha=0.4)]})
    fedavg, fedasync = res.logs
    assert set(fedavg.update_counts.values()) == {1}
    assert all(0 < v[-1] < 10 for v in fedavg.eps_trajectory.values())
    assert sum(fedasync.update_counts.values()) == 3
    rows = res.table()
    assert [r["strategy"] for r in rows] == ["fedavg", "fedasync(alpha=0.4)"]
    assert all(0.0 <= r["final_acc"] <= 1.0 for r in rows)
