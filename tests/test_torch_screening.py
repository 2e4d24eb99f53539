"""Update screening of the PyTorch port against the JAX reference.

* ``screen_update`` and ``corrupt_update`` (functions on dicts of
  tensors) against the reference's on the same numpy params: norms and
  corrupted payloads within 1e-6 relative (float32 sums in another
  order), the clean sentinel returning its input itself.
* ``screen_update`` / ``corrupt_update`` run the cohort step's
  ``_screen_members`` / ``_corrupt_members`` on one update: a member of a
  stacked cohort gets the payload it gets alone (bitwise) and the same
  verdict.
* ``ScreeningState`` is host logic copied from the reference: driven by
  the same verdicts it gives equal events, counters and state dicts, and
  a screened engine run keeps the ledger law
  ``screen_rejections == screen_nonfinite + screen_norm_rejects``
  without building another step.
"""
import dataclasses
import pathlib
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.screening as ref_scr
import repro_torch.core.screening as port_scr
from repro_torch.api import ExperimentSpec, RunBudget, Session, StrategySpec
from repro_torch.core.faults import FaultModel
from repro_torch.core.testbed import TestbedConfig
from repro_torch.data.synthetic_ser import SERDataConfig
from repro_torch.engine import cohort_step
from repro_torch.models.ser_cnn import SERConfig
from repro_torch.pytree import tree_leaves

sys.path.insert(0, str(pathlib.Path(__file__).parent))
import _torch_ref_runs as R  # noqa: E402

RTOL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    with R.one_torch_thread():
        yield


def _params(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"conv1": {"b": rng.standard_normal(8).astype(np.float32) * scale,
                      "w": rng.standard_normal((3, 1, 8)).astype(np.float32)
                      * scale},
            "out": {"b": rng.standard_normal(6).astype(np.float32) * scale,
                    "w": rng.standard_normal((32, 6)).astype(np.float32)
                    * scale}}


def _torch(tree):
    return {k: {n: torch.from_numpy(v.copy()) for n, v in sub.items()}
            for k, sub in tree.items()}


def _jax(tree):
    return {k: {n: jnp.asarray(v) for n, v in sub.items()}
            for k, sub in tree.items()}


@pytest.mark.parametrize("seed,delta", [(0, 1e-3), (1, 0.5), (2, 40.0)])
def test_screen_update_matches_reference(seed, delta):
    p0 = _params(seed)
    p1 = {k: {n: v + delta * np.float32(1 + i)
              for i, (n, v) in enumerate(sub.items())}
          for k, sub in p0.items()}
    fin_r, nrm_r = ref_scr.screen_update(_jax(p0), _jax(p1))
    fin_p, nrm_p = port_scr.screen_update(_torch(p0), _torch(p1))
    assert fin_p is fin_r is True
    assert nrm_p == pytest.approx(nrm_r, rel=RTOL)


@pytest.mark.parametrize("bad", [np.nan, np.inf])
def test_screen_update_flags_nonfinite(bad):
    p0, p1 = _params(3), _params(4)
    p1["out"]["w"][2, 3] = bad
    assert ref_scr.screen_update(_jax(p0), _jax(p1))[0] is False
    assert port_scr.screen_update(_torch(p0), _torch(p1))[0] is False


@pytest.mark.parametrize("scale", [50.0, 1e6, 0.25, float("nan")])
def test_corrupt_update_matches_reference(scale):
    p0, p1 = _params(5), _params(6)
    want = ref_scr.corrupt_update(_jax(p0), _jax(p1), scale)
    got = port_scr.corrupt_update(_torch(p0), _torch(p1), scale)
    for k in p0:
        for n in p0[k]:
            np.testing.assert_allclose(got[k][n].numpy(),
                                       np.asarray(want[k][n]), rtol=RTOL,
                                       atol=0, equal_nan=True)


def test_clean_corruption_returns_the_input_itself():
    p0, p1 = _torch(_params(7)), _torch(_params(8))
    assert port_scr.corrupt_update(p0, p1, 1.0) is p1


def test_in_step_corruption_and_screen_match_the_host_mirrors():
    """The cohort step's stacked epilogue over three members against each
    member's update alone (the legacy loops' calls): the corrupted
    payloads bitwise, the norms to float32 sum order."""
    refs = [_torch(_params(10 + i)) for i in range(3)]
    news = [_torch(_params(20 + i, scale=1.5)) for i in range(3)]
    scales = [1.0, 50.0, float("nan")]
    stacked_ref = cohort_step.stack_trees(refs)
    stacked_new = cohort_step.stack_trees(news)
    up = cohort_step._corrupt_members(
        stacked_ref, stacked_new, torch.tensor(scales))
    fin, nrm = cohort_step._screen_members(stacked_ref, up)
    for i, s in enumerate(scales):
        host = port_scr.corrupt_update(refs[i], news[i], s)
        for a, b in zip(tree_leaves(cohort_step.unstack_tree(up, i)),
                        tree_leaves(host)):
            assert torch.equal(a, b) or (
                torch.isnan(a).all() and torch.isnan(b).all())
        h_fin, h_nrm = port_scr.screen_update(refs[i], host)
        assert bool(fin[i]) is h_fin
        if h_fin:
            assert float(nrm[i]) == pytest.approx(h_nrm, rel=RTOL)


# a verdict script: (cid, t, finite, norm) with rejections, quarantine,
# drops while suspended and re-admission
VERDICTS = [(0, 1.0, True, 0.1), (1, 2.0, False, float("nan")),
            (1, 3.0, True, 5.0), (1, 4.0, True, 0.1), (2, 5.0, True, 9.0),
            (1, 650.0, True, 0.2), (2, 700.0, False, float("nan")),
            (2, 800.0, True, 0.1), (0, 900.0, True, 3.0)]


@pytest.mark.parametrize("cfg", [
    dict(max_update_norm=1.0, quarantine_after=2, readmit_delay_s=600.0),
    dict(max_update_norm=None, quarantine_after=1, readmit_delay_s=50.0),
    dict(max_update_norm=4.0)])
def test_screening_state_ledger_matches_reference(cfg):
    ref = ref_scr.ScreeningState(ref_scr.ScreeningConfig(**cfg), 3)
    port = port_scr.ScreeningState(port_scr.ScreeningConfig(**cfg), 3)
    for v in VERDICTS:
        assert port.screen(*v) is ref.screen(*v)
    assert port.events == ref.events
    assert port.stats() == ref.stats()
    assert port.state_dict() == ref.state_dict()
    c = port.stats()
    assert c["screen_rejections"] == (c["screen_nonfinite"]
                                      + c["screen_norm_rejects"])
    again = port_scr.ScreeningState(port_scr.ScreeningConfig(**cfg), 3)
    again.load_state_dict(port.state_dict())
    assert again.state_dict() == port.state_dict()


@pytest.mark.parametrize("bad", [dict(max_update_norm=0.0),
                                 dict(quarantine_after=-1),
                                 dict(quarantine_after=2,
                                      readmit_delay_s=0.0)])
def test_screening_config_validation_matches_reference(bad):
    with pytest.raises(ValueError) as ref_err:
        ref_scr.ScreeningConfig(**bad)
    with pytest.raises(ValueError) as port_err:
        port_scr.ScreeningConfig(**bad)
    assert str(port_err.value) == str(ref_err.value)


def test_screened_engine_run_keeps_the_ledger_and_the_step():
    """Screening and faults change nothing the step is built from: a
    screened, faulty run after a clean one builds no step, its counters
    keep the ledger law, and the verdict fetches are counted apart from
    the between-evals syncs (one per cohort)."""
    tb = TestbedConfig(
        data=SERDataConfig(n_total=360, **R.DIMS),
        model=SERConfig(channels1=8, channels2=16, fc_dim=32, **R.DIMS),
        **dict(R.testbed_kwargs(0.0), dp_path="pallas"))
    spec = ExperimentSpec(testbed=tb, strategy=StrategySpec(
        "fedasync_normbound", alpha=0.4, norm_bound=0.1),
        run=RunBudget(max_updates=10, eval_every=5))
    sess = Session(device="cpu")
    sess.run(spec)
    b0 = cohort_step.step_builds()
    _, log = sess.run(dataclasses.replace(spec, testbed=dataclasses.replace(
        tb, faults=FaultModel(**R.FAULTS),
        screening=port_scr.ScreeningConfig(**R.SCREENING))))
    assert cohort_step.step_builds() == b0
    st = log.engine_stats
    assert st["screen_rejections"] > 0
    assert st["screen_rejections"] == (st["screen_nonfinite"]
                                       + st["screen_norm_rejects"])
    assert st["screen_verdict_syncs"] == st["cohorts"]
    assert st["host_syncs_between_evals"] == st["blocking_submits"]
