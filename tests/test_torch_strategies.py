"""The seven aggregation strategies and the legacy client/server loop of
the PyTorch port against the JAX reference.

* Each strategy's ``aggregate`` / ``merge`` / ``offer`` and
  ``apply_update`` on the same numpy params as the JAX function: within
  1e-6 (float32 arithmetic in the reference's order; only reduction
  order can differ).
* Runs on the tiny testbed of ``tests/_torch_ref_runs.py`` (the
  reference in a subprocess, see there): the legacy loop against the
  reference's ``engine="legacy"``, and FedBuff, personalized FedAsync and
  FedAvg and personalized AdaptiveAsync, which the engine merges member
  by member, on both backends.  Bookkeeping must be EXACTLY equal; params
  at sigma = 0 stay within the run-level tolerance of
  ``tests/test_torch_engine_parity.py`` (atol 1e-2).  The personalized
  runs at sigma = 0 also give EXACTLY the reference's ``local_acc``: each
  client's accuracy under its own personal heads, which only the overlay
  before training, the upload of the received heads and
  ``Client.evaluate`` produce.  The AdaptiveAsync runs use sigma = 1 (at
  sigma = 0 epsilon is infinite and every client stops after one round),
  so their params are held, at the same tolerance, to the port's other
  backend — both draw the same noise from the same dispatch seeds — and
  only their bookkeeping to the reference.
"""
import pathlib
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.aggregation as ref_agg
import repro_torch.core.aggregation as port_agg
from repro_torch.pytree import tree_leaves

sys.path.insert(0, str(pathlib.Path(__file__).parent))
import _torch_ref_runs as R  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    with R.one_torch_thread():
        yield

RTOL, ATOL = 1e-6, 1e-6
PARAMS_ATOL = 1e-2
EXACT_FIELDS = ("times", "server_version", "update_counts", "staleness",
                "eps_trajectory", "cohort_sizes", "influence")
LEGACY = ("legacy_async", "legacy_fedavg", "fedbuff_legacy")
ENGINE = ("fedbuff_engine",)
PERSONAL = ("personal_async_legacy", "personal_async_engine",
            "personal_fedavg_legacy", "personal_fedavg_engine")
NOISY = ("adaptive_personal_legacy", "adaptive_personal_engine")


def _params(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"a": {"b": (rng.standard_normal(7) * scale).astype(np.float32),
                  "w": (rng.standard_normal((5, 3)) * scale
                        ).astype(np.float32)},
            "out": {"w": (rng.standard_normal((4, 2)) * scale
                          ).astype(np.float32)}}


def _to(tree, lib):
    conv = torch.from_numpy if lib == "torch" else jnp.asarray
    return {k: {n: conv(v.copy()) for n, v in sub.items()}
            for k, sub in tree.items()}


def _close(got, want):
    for k in want:
        for n in want[k]:
            np.testing.assert_allclose(got[k][n].numpy(),
                                       np.asarray(want[k][n]), rtol=RTOL,
                                       atol=ATOL)


def _both(name, **kw):
    return (port_agg.make_strategy(name, **kw),
            ref_agg.make_strategy(name, **kw))


def test_registries_agree():
    assert port_agg.STRATEGY_NAMES == ref_agg.STRATEGY_NAMES
    for name in ref_agg.STRATEGY_NAMES:
        assert port_agg.strategy_params(name) == \
            ref_agg.strategy_params(name)


@pytest.mark.parametrize("name,kw", [
    ("fedavg", {}), ("fedavg_trimmed", {}), ("fedavg_trimmed",
                                            dict(trim_frac=0.34))])
@pytest.mark.parametrize("k", [1, 3, 5])
def test_aggregate_matches_reference(name, kw, k):
    g = _params(0)
    ups = [(_params(1 + i, scale=1.0 + i), 40 + 7 * i) for i in range(k)]
    port, ref = _both(name, **kw)
    got = port.aggregate(_to(g, "torch"),
                         [(_to(p, "torch"), n) for p, n in ups])
    want = ref.aggregate(_to(g, "jax"), [(_to(p, "jax"), n) for p, n in ups])
    _close(got, want)


@pytest.mark.parametrize("name,kw", [
    ("fedasync", dict(alpha=0.4)), ("fedasync_nostale", dict(alpha=0.6)),
    ("fedasync_normbound", dict(norm_bound=10.0)),
    ("fedasync_normbound", dict(norm_bound=0.5)),
    ("adaptive_async", dict(eps_target=8.0))])
@pytest.mark.parametrize("tau", [0, 3])
def test_merge_matches_reference(name, kw, tau):
    g, p = _params(2), _params(3, scale=0.1)
    port, ref = _both(name, **kw)
    extra = dict(eps_spent=5.0) if name == "adaptive_async" else {}
    got, w_p = port.merge(_to(g, "torch"), _to(p, "torch"), tau, **extra)
    want, w_r = ref.merge(_to(g, "jax"), _to(p, "jax"), tau, **extra)
    assert w_p == w_r
    _close(got, want)


def test_normbound_drops_a_nonfinite_update():
    g, p = _params(4), _params(5)
    p["a"]["w"][1, 1] = np.nan
    port, ref = _both("fedasync_normbound", norm_bound=1.0)
    got, _ = port.merge(_to(g, "torch"), _to(p, "torch"), 0)
    want, _ = ref.merge(_to(g, "jax"), _to(p, "jax"), 0)
    _close(got, want)
    _close(got, _to(g, "jax"))


def test_fedbuff_offer_matches_reference():
    port, ref = _both("fedbuff", alpha=0.5, buffer_size=3)
    g = _params(6)
    g_p, g_r = _to(g, "torch"), _to(g, "jax")
    for i in range(7):
        p = _params(10 + i)
        out_p, applied_p, w_p = port.offer(g_p, _to(p, "torch"), i % 3)
        out_r, applied_r, w_r = ref.offer(g_r, _to(p, "jax"), i % 3)
        assert (applied_p, w_p) == (applied_r, w_r)
        if applied_r:
            _close(out_p, out_r)
            g_p, g_r = out_p, out_r


@pytest.mark.parametrize("name,kw", [
    ("fedasync", {}), ("fedbuff", dict(buffer_size=2)),
    ("adaptive_async", dict(eps_target=4.0)),
    ("fedasync_normbound", dict(norm_bound=0.3))])
def test_apply_update_matches_reference(name, kw):
    port, ref = _both(name, **kw)
    g_p, g_r = _to(_params(7), "torch"), _to(_params(7), "jax")
    for i in range(4):
        p = _params(20 + i, scale=0.5)
        g_p, inc_p, w_p = port_agg.apply_update(
            port, g_p, _to(p, "torch"), i, eps_spent=1.5 * i)
        g_r, inc_r, w_r = ref_agg.apply_update(
            ref, g_r, _to(p, "jax"), i, eps_spent=1.5 * i)
        assert (inc_p, w_p) == (inc_r, w_r)
        _close(g_p, g_r)


@pytest.mark.parametrize("name,kw", [
    ("fedavg_trimmed", dict(trim_frac=0.5)), ("fedbuff", dict(beta=1.0)),
    ("fedasync_normbound", dict(norm_bound=0.0)), ("fedmagic", {})])
def test_bad_strategy_params_raise_like_reference(name, kw):
    with pytest.raises(ValueError) as ref_err:
        ref_agg.make_strategy(name, **kw)
    with pytest.raises(ValueError) as port_err:
        port_agg.make_strategy(name, **kw)
    assert str(port_err.value) == str(ref_err.value)


# ---------------------------------------------------------------------------
# runs: the legacy loop and the member-by-member strategies
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref_runs(tmp_path_factory):
    return R.run_reference(tmp_path_factory.mktemp("ref_strategies"),
                           LEGACY + ENGINE + PERSONAL + NOISY)


_PORT = {}


def _port(ref_runs, name, dp_path):
    if (name, dp_path) not in _PORT:
        _, params, log, calls = R.execute(
            "repro_torch", name, ref_runs[name]["init"], dp_path=dp_path,
            device="cpu")
        _PORT[(name, dp_path)] = (params, R.log_dict(log, calls))
    return _PORT[(name, dp_path)]


@pytest.mark.parametrize("dp_path", ["jnp", "pallas"])
@pytest.mark.parametrize("name", LEGACY + ENGINE + PERSONAL + NOISY)
def test_run_bookkeeping_equals_reference(ref_runs, name, dp_path):
    _, got = _port(ref_runs, name, dp_path)
    want = ref_runs[name]["log"]
    for f in EXACT_FIELDS:
        assert got[f] == want[f], f


@pytest.mark.parametrize("dp_path", ["jnp", "pallas"])
@pytest.mark.parametrize("name", LEGACY + ENGINE + PERSONAL)
def test_run_params_within_run_tolerance(ref_runs, name, dp_path):
    params, _ = _port(ref_runs, name, dp_path)
    for a, b in zip(ref_runs[name]["final"], tree_leaves(params)):
        assert np.isfinite(b.numpy()).all()
        np.testing.assert_allclose(a, b.numpy(), rtol=0, atol=PARAMS_ATOL)


@pytest.mark.parametrize("dp_path", ["jnp", "pallas"])
@pytest.mark.parametrize("name", PERSONAL)
def test_personal_local_acc_equals_reference(ref_runs, name, dp_path):
    """Each client's accuracy under its personal heads, at every eval,
    exactly the reference's; the heads really are the client's own (they
    do not score as the global model does)."""
    _, got = _port(ref_runs, name, dp_path)
    want = ref_runs[name]["log"]
    assert got["local_acc"] == want["local_acc"]
    assert got["local_acc"] != _port(
        ref_runs, "legacy_async" if "async" in name else "legacy_fedavg",
        dp_path)[1]["local_acc"]


def test_fedbuff_buffers_across_cohorts(ref_runs):
    """FedBuff's server versions advance once per full buffer, so they
    lag the update count — on both backends, as in the reference."""
    for name in ("fedbuff_legacy", "fedbuff_engine"):
        log = _port(ref_runs, name, "jnp")[1]
        assert log["server_version"][-1] < sum(log["update_counts"].values())
    assert max(_port(ref_runs, "fedbuff_engine", "jnp")[1]["cohort_sizes"]) > 1


@pytest.mark.parametrize("dp_path", ["jnp", "pallas"])
def test_adaptive_personal_backends_agree(ref_runs, dp_path):
    """Same dispatch seeds, same noise: the legacy loop and the engine end
    within the run-level tolerance at sigma = 1, and the privacy budget
    stopped some clients before the update budget ran out."""
    p_leg, log_leg = _port(ref_runs, "adaptive_personal_legacy", dp_path)
    p_eng, log_eng = _port(ref_runs, "adaptive_personal_engine", dp_path)
    assert log_leg["eps_trajectory"] == log_eng["eps_trajectory"]
    for a, b in zip(tree_leaves(p_leg), tree_leaves(p_eng)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                   atol=PARAMS_ATOL)
    assert sum(log_eng["update_counts"].values()) < 20
