"""Host layer of the PyTorch port vs the JAX reference, bit for bit:
corpus, partitions, tier clocks, moments accountant, fairness report,
cohort planning and the flat param layout."""
import heapq

import numpy as np
import pytest
import torch

from repro.core import accountant as r_acc
from repro.core import fairness as r_fair
from repro.core import heterogeneity as r_het
from repro.core import testbed as r_tb
from repro.data import partition as r_part
from repro.data import synthetic_ser as r_ser
from repro.engine import cohort as r_cohort
from repro.models import ser_cnn as r_cnn
from repro.pytree import tree_flatten_to_vector as r_flatten

from repro_torch.core import accountant as t_acc
from repro_torch.core import fairness as t_fair
from repro_torch.core import heterogeneity as t_het
from repro_torch.core import runlog as t_runlog
from repro_torch.core import testbed as t_tb
from repro_torch.data import partition as t_part
from repro_torch.data import synthetic_ser as t_ser
from repro_torch.engine import cohort as t_cohort
from repro_torch.models import convert, ser_cnn as t_cnn
from repro_torch import pytree as t_pytree

_DIMS = dict(time_frames=12, n_mels=12)


def _data_cfg(mod, **kw):
    return mod.SERDataConfig(n_total=360, **_DIMS, **kw)


def _assert_dicts_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("seed", [1234, 7])
def test_corpus_bitwise(seed):
    ref = r_ser.generate(_data_cfg(r_ser, seed=seed))
    port = t_ser.generate(_data_cfg(t_ser, seed=seed))
    _assert_dicts_equal(ref, port)
    _assert_dicts_equal(r_ser.train_test_split(ref, seed=3)[1],
                        t_ser.train_test_split(port, seed=3)[1])


@pytest.mark.parametrize("kind", ["iid", "dirichlet"])
def test_partitions_bitwise(kind):
    data = t_ser.generate(_data_cfg(t_ser))
    if kind == "iid":
        ref, port = (r_part.iid_partition(data, 5, seed=2),
                     t_part.iid_partition(data, 5, seed=2))
    else:
        ref, port = (r_part.dirichlet_partition(data, 5, 0.5, seed=2),
                     t_part.dirichlet_partition(data, 5, 0.5, seed=2))
    assert len(ref) == len(port)
    for a, b in zip(ref, port):
        _assert_dicts_equal(a, b)


def test_testbed_partitions_bitwise():
    kw = dict(num_clients=5, seed=3, batch_size=16)
    ref_s, ref_pool = r_tb.build_partitions(
        r_tb.TestbedConfig(data=_data_cfg(r_ser), **kw))
    port_s, port_pool = t_tb.build_partitions(
        t_tb.TestbedConfig(data=_data_cfg(t_ser), **kw))
    _assert_dicts_equal(ref_pool, port_pool)
    for (rtr, rte), (ptr, pte) in zip(ref_s, port_s):
        _assert_dicts_equal(rtr, ptr)
        _assert_dicts_equal(rte, pte)


@pytest.mark.parametrize("tier", r_het.TIERS)
def test_clock_draws_bitwise(tier):
    assert vars(r_het.PROFILES[tier]) == vars(t_het.PROFILES[tier])
    rc = r_het.VirtualClock(r_het.PROFILES[tier], seed=977 * 3 + 1)
    tc = t_het.VirtualClock(t_het.PROFILES[tier], seed=977 * 3 + 1)
    assert [rc.round_duration() for _ in range(40)] == \
        [tc.round_duration() for _ in range(40)]
    assert rc.dropouts == tc.dropouts
    assert rc.resource_sample() == tc.resource_sample()


@pytest.mark.parametrize("q,sigma", [(0.136, 1.0), (0.3, 0.5), (1.0, 2.0),
                                     (0.2, 0.0), (0.0, 1.0)])
def test_log_moments_and_epsilon_bitwise(q, sigma):
    np.testing.assert_array_equal(r_acc.log_moments_vector(q, sigma),
                                  t_acc.log_moments_vector(q, sigma))
    ra, ta = r_acc.MomentsAccountant(), t_acc.MomentsAccountant()
    for steps in (3, 7, 1):
        ra.step(q, sigma, steps)
        ta.step(q, sigma, steps)
        assert ra.epsilon(1e-5) == ta.epsilon(1e-5)
    rs = r_acc.EpsilonSchedule(q, sigma, 7, 1e-5)
    ts = t_acc.EpsilonSchedule(q, sigma, 7, 1e-5)
    assert [rs.epsilon_after_rounds(r) for r in range(12)] == \
        [ts.epsilon_after_rounds(r) for r in range(12)]


def test_fairness_report_equal():
    counts = {"HW_T1": 3, "HW_T2": 4, "HW_T3": 9, "HW_T4": 20, "HW_T5": 22}
    acc = {"HW_T1": 0.4, "HW_T2": 0.45, "HW_T3": 0.5, "HW_T4": 0.52,
           "HW_T5": 0.55}
    eps = {"HW_T1": 1.5, "HW_T2": 1.9, "HW_T3": 3.0, "HW_T4": 6.1,
           "HW_T5": 7.7}
    assert r_fair.fairness_report(counts, acc, eps) == \
        t_fair.fairness_report(counts, acc, eps)


@pytest.mark.parametrize("n,b,e", [(58, 16, 1), (941, 128, 1), (10, 16, 2),
                                   (130, 16, 3)])
def test_batch_plans_bitwise(n, b, e):
    assert r_cohort.steps_per_round(n, b, e) == t_cohort.steps_per_round(n, b, e)
    r = r_cohort.plan_batches(np.random.default_rng(5), n, b, e)
    t = t_cohort.plan_batches(np.random.default_rng(5), n, b, e)
    assert r.dtype == t.dtype
    np.testing.assert_array_equal(r, t)


@pytest.mark.parametrize("window,max_size,pow2", [(0.0, 2, True),
                                                   (30.0, 4, True),
                                                   (1e9, 3, False)])
def test_pop_cohort_and_weights_equal(window, max_size, pow2):
    rng = np.random.default_rng(0)
    times = np.round(rng.exponential(20.0, size=12), 1)
    h_r = [(float(t), cid) for cid, t in enumerate(times)]
    h_t = list(h_r)
    heapq.heapify(h_r)
    heapq.heapify(h_t)
    while h_r:
        ev_r = r_cohort.pop_cohort(h_r, window, max_size, pow2)
        ev_t = t_cohort.pop_cohort(h_t, window, max_size, pow2)
        assert ev_r == ev_t
        ws = [0.4 / (1 + i) for i in range(len(ev_r))]
        g_r, c_r = r_cohort.fold_cohort_weights(ws)
        g_t, c_t = t_cohort.fold_cohort_weights(ws)
        assert g_r == g_t
        np.testing.assert_array_equal(c_r, c_t)
    assert not h_t
    for k in range(1, 9):
        assert r_cohort.padded_cohort_size(k, 3, pow2) == \
            t_cohort.padded_cohort_size(k, 3, pow2)
    np.testing.assert_array_equal(r_cohort.fedavg_weights([58, 59, 60])[1],
                                  t_cohort.fedavg_weights([58, 59, 60])[1])


def test_flat_leaf_layout_matches_reference():
    """The flat D layout (kernel rows, noise z) is jax.tree_util's."""
    import jax
    cfg_r = r_cnn.SERConfig(channels1=8, channels2=16, fc_dim=32, **_DIMS)
    p_r = r_cnn.init(jax.random.PRNGKey(1), cfg_r)
    p_t = convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, p_r))
    assert [".".join(p) for p in t_pytree.tree_paths(p_t)] == [
        "conv1.b", "conv1.w", "conv2.b", "conv2.w", "fc1.b", "fc1.w",
        "gn1.bias", "gn1.scale", "gn2.bias", "gn2.scale", "out.b", "out.w"]
    flat_t = t_pytree.tree_flatten_to_vector(p_t)
    np.testing.assert_array_equal(np.asarray(r_flatten(p_r)), flat_t.numpy())
    back = t_pytree.tree_unflatten_from_vector(flat_t, p_t)
    for a, b in zip(t_pytree.tree_leaves(back), t_pytree.tree_leaves(p_t)):
        assert torch.equal(a, b)
    stacked = torch.stack([flat_t, 2 * flat_t])
    st = t_pytree.tree_unflatten_from_vector(stacked, p_t, lead=1)
    assert torch.equal(t_pytree.tree_flatten_to_vector(st, lead=1), stacked)


def test_tree_paths_match_jax_paths():
    """One walker owns the leaf order: ``tree_paths``/``tree_leaves`` give
    jax.tree_util's paths and order over dicts, NamedTuple optimizer
    states, tuples, lists and None, keyed as the reference's checkpoint
    keys them."""
    import jax
    from repro.checkpoint.checkpoint import _path_key as r_key
    from repro.optim.optimizers import AdamState as RAdam
    from repro_torch.checkpoint.checkpoint import _path_key as t_key
    from repro_torch.optim.optimizers import AdamState as TAdam

    rng = np.random.default_rng(0)
    arrays = [rng.standard_normal((i + 1, 2)).astype(np.float32)
              for i in range(7)]

    def tree(adam, leaf):
        a = [leaf(x) for x in arrays]
        return {"z/w": a[0], "opt": adam(a[1], {"b": a[2], "a": a[3]},
                                         {"b": a[4], "a": a[5]}),
                "seq": [a[6], None], "pair": (a[0], a[1])}

    t_tree = tree(TAdam, torch.from_numpy)
    r_paths = jax.tree_util.tree_flatten_with_path(tree(RAdam, np.asarray))[0]
    assert [t_key(p) for p in t_pytree.tree_paths(t_tree)] == [
        r_key(p) for p, _ in r_paths]
    for t, (_, r) in zip(t_pytree.tree_leaves(t_tree), r_paths, strict=True):
        np.testing.assert_array_equal(t.numpy(), r)
    back = t_pytree.tree_unflatten_like(t_tree, t_pytree.tree_leaves(t_tree))
    assert isinstance(back["opt"], TAdam) and back["seq"][1] is None
    assert t_pytree.tree_paths(back) == t_pytree.tree_paths(t_tree)


def test_full_width_param_count():
    """The paper's default CNN has D = 317,124 parameters in both."""
    assert t_cnn.param_count(t_cnn.init(0, t_cnn.SERConfig())) == 317124
    assert convert.params_to_numpy(
        t_cnn.init(0, t_cnn.SERConfig()))["conv1"]["w"].shape == (5, 40, 64)


def test_engine_stats_schema_matches_reference():
    from repro.core.runlog import ENGINE_STATS_KEYS
    assert t_runlog.ENGINE_STATS_KEYS == ENGINE_STATS_KEYS
