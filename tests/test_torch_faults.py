"""Faults and screening of the PyTorch port against the JAX reference.

* ``FaultModel`` / ``FaultInjector`` / ``apply_deadline`` are numpy host
  logic copied into the port: driven by the same call sequence they give
  bitwise-equal draws, events, counters and state dicts.
* Whole runs on the tiny testbed of ``tests/_torch_ref_runs.py`` at
  sigma = 0 with faults of every kind and screening, on both backends
  (the legacy per-client loop and the cohort engine at
  ``staleness_window=0``): fault events, screen counters, virtual times,
  update counts, staleness and epsilon trajectories must EQUAL the
  reference's (the reference runs in a subprocess, see there), and the
  params stay within the run-level tolerance of
  ``tests/test_torch_engine_parity.py`` (atol 1e-2).
* Screen verdicts compare update norms with a threshold, so the test
  first asserts that every observed norm, the reference's and the
  port's, lies at least half the threshold away from it: a verdict that
  then differs is a real fault, not a norm rounded across the line.
"""
import math
import pathlib
import sys

import numpy as np
import pytest

import repro.core.faults as ref_faults
import repro_torch.core.faults as port_faults
from repro_torch.pytree import tree_leaves

sys.path.insert(0, str(pathlib.Path(__file__).parent))
import _torch_ref_runs as R  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    with R.one_torch_thread():
        yield

PARAMS_ATOL = 1e-2
ROBUST = ("robust_async_engine", "robust_async_legacy",
          "robust_fedavg_engine", "robust_fedavg_legacy")
EXACT_FIELDS = ("times", "server_version", "update_counts", "staleness",
                "eps_trajectory", "cohort_sizes", "influence",
                "fault_events")
MARGIN = 0.5 * R.SCREEN_THRESHOLD


@pytest.fixture(scope="module")
def ref_runs(tmp_path_factory):
    return R.run_reference(tmp_path_factory.mktemp("ref_faults"), ROBUST)


_PORT = {}


def _port(ref_runs, name, dp_path):
    if (name, dp_path) not in _PORT:
        _, params, log, calls = R.execute(
            "repro_torch", name, ref_runs[name]["init"], dp_path=dp_path,
            device="cpu")
        _PORT[(name, dp_path)] = (params, R.log_dict(log, calls))
    return _PORT[(name, dp_path)]


# ---------------------------------------------------------------------------
# the copied host logic, draw for draw
# ---------------------------------------------------------------------------

MODELS = [
    dict(R.FAULTS),
    dict(R.FEDAVG_FAULTS),
    dict(seed=7, failure_prob=0.3, upload_loss_prob=0.5, max_retries=1,
         retry_backoff_s=2.0, duplicate_prob=0.4, late_prob=0.3,
         leave_prob=0.3, corrupt_prob=0.5, corrupt_nan_frac=0.2,
         corrupt_scale=1e6),
]


def _drive(mod, kw, n=6, steps=400):
    """A fixed pseudo-random sequence of every injector entry point."""
    inj = mod.FaultInjector(mod.FaultModel(**kw), n)
    script = np.random.default_rng(11)
    outs = []
    t = 0.0
    for _ in range(steps):
        cid = int(script.integers(n))
        t += float(script.random()) * 10.0
        op = int(script.integers(4))
        if op == 0:
            out = inj.on_completion(cid, t)
        elif op == 1:
            out = inj.redispatch_delay(cid, t)
        elif op == 2:
            out = inj.fedavg_fate(cid, t, float(script.random()) * 100.0)
        else:
            out = inj.take_corruption(cid)
        outs.append(repr(out))
    return outs, inj


@pytest.mark.parametrize("kw", MODELS, ids=["async", "fedavg", "heavy"])
def test_injector_draws_bitwise_equal(kw):
    got_out, got = _drive(port_faults, kw)
    want_out, want = _drive(ref_faults, kw)
    assert got_out == want_out
    assert got.events == want.events
    assert got.stats() == want.stats()
    assert repr(got.state_dict()) == repr(want.state_dict())


def test_injector_state_dict_round_trips():
    kw = MODELS[2]
    _, a = _drive(port_faults, kw, steps=150)
    b = port_faults.FaultInjector(port_faults.FaultModel(**kw), 6)
    b.load_state_dict(a.state_dict())
    assert repr(b.state_dict()) == repr(a.state_dict())
    for t in (1e4, 1e4 + 3.0):
        assert [b.on_completion(c, t) for c in range(6)] == \
            [a.on_completion(c, t) for c in range(6)]


@pytest.mark.parametrize("offsets,deadline,quorum", [
    ([10.0, None, 30.0, 50.0], None, 1),
    ([10.0, None, 30.0, 50.0], 20.0, 1),
    ([10.0, None, 30.0, 50.0], 20.0, 3),
    ([None, None, None], 5.0, 2),
    ([40.0, 35.0, 60.0, 20.0, 90.0], 30.0, 2),
])
def test_apply_deadline_matches_reference(offsets, deadline, quorum):
    kw = dict(round_deadline_s=deadline, min_quorum=quorum)
    assert port_faults.apply_deadline(port_faults.FaultModel(**kw), offsets) \
        == ref_faults.apply_deadline(ref_faults.FaultModel(**kw), offsets)


@pytest.mark.parametrize("bad", [
    dict(failure_prob=1.5), dict(seed=-1), dict(max_retries=-1),
    dict(late_prob=0.1, late_delay_s=0.0), dict(corrupt_scale=math.inf),
    dict(corrupt_prob=0.1, corrupt_scale=1.0), dict(round_deadline_s=0.0),
    dict(min_quorum=0)])
def test_fault_model_validation_matches_reference(bad):
    with pytest.raises(ValueError) as ref_err:
        ref_faults.FaultModel(**bad)
    with pytest.raises(ValueError) as port_err:
        port_faults.FaultModel(**bad)
    assert str(port_err.value) == str(ref_err.value)


# ---------------------------------------------------------------------------
# whole runs: faults and screening on both backends
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dp_path", ["jnp", "pallas"])
@pytest.mark.parametrize("name", ROBUST)
def test_fault_bookkeeping_equals_reference(ref_runs, name, dp_path):
    _, got = _port(ref_runs, name, dp_path)
    want = ref_runs[name]["log"]
    for f in EXACT_FIELDS:
        assert got[f] == want[f], f
    assert got["counters"] == want["counters"]
    assert [c[:3] for c in got["screen_calls"]] == \
        [c[:3] for c in want["screen_calls"]]


def test_runs_cover_every_fault_and_verdict_kind(ref_runs):
    kinds = {e[0] for name in ROBUST
             for e in _port(ref_runs, name, "jnp")[1]["fault_events"]}
    assert {"failure", "upload_loss", "retry", "late", "leave",
            "duplicate_dropped", "corrupt_nan", "corrupt_scale",
            "deadline_drop", "screen_nonfinite", "screen_norm",
            "quarantine"} <= kinds


@pytest.mark.parametrize("name", ROBUST)
def test_screen_norms_lie_far_from_the_threshold(ref_runs, name):
    """Every finite update norm either run saw is at least half the
    threshold away from it, so the verdicts above cannot flip on rounding
    (clean norms ~0.1, corrupted ones 4-6, threshold 1)."""
    seen = 0
    for calls in (ref_runs[name]["log"]["screen_calls"],
                  _port(ref_runs, name, "jnp")[1]["screen_calls"]):
        for _, _, finite, norm in calls:
            if finite:
                assert abs(norm - R.SCREEN_THRESHOLD) > MARGIN, norm
                seen += 1
    assert seen > 0


@pytest.mark.parametrize("dp_path", ["jnp", "pallas"])
@pytest.mark.parametrize("name", ROBUST)
def test_fault_params_within_run_tolerance(ref_runs, name, dp_path):
    params, _ = _port(ref_runs, name, dp_path)
    for a, b in zip(ref_runs[name]["final"], tree_leaves(params)):
        assert np.isfinite(b.numpy()).all()
        np.testing.assert_allclose(a, b.numpy(), rtol=0, atol=PARAMS_ATOL)


@pytest.mark.parametrize("kind", ["async", "fedavg"])
def test_legacy_and_engine_replay_the_same_faults(ref_runs, kind):
    """The two backends of the port replay one fault sequence (and the
    reference's two backends agree with each other, as both equal it)."""
    eng = _port(ref_runs, f"robust_{kind}_engine", "jnp")[1]
    leg = _port(ref_runs, f"robust_{kind}_legacy", "jnp")[1]
    assert eng["fault_events"] == leg["fault_events"]
    assert eng["update_counts"] == leg["update_counts"]
    assert ref_runs[f"robust_{kind}_engine"]["log"]["fault_events"] == \
        ref_runs[f"robust_{kind}_legacy"]["log"]["fault_events"]
