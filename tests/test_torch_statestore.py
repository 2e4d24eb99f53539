"""The tiered client-state store of the PyTorch port
(``repro_torch.engine.statestore``) against the JAX reference's.

* Residency is a pure function of the call sequence: the reference's and
  the port's ``TieredStateStore`` driven with one ``note_dispatch`` /
  ``acquire_cohort`` / ``prefetch_cids`` / ``note_trained`` sequence give
  equal slots, device calls (writes, spills, loads, re-inits), evictions,
  ``stats()`` and ``state_meta()``.
* A tiered run equals the all-resident run bit for bit within the port
  (params and RunLog), serial and pipelined, async and FedAvg, with the
  prefetcher on or off; its ``store_*`` counters, bookkeeping and
  scheduler counters exactly equal the reference's small tiered run
  (``tests/_torch_ref_runs.py``), under the ledger law
  ``store_fetches == store_hot_hits + store_prefetch_hits +
  store_stall_waits``.
* Dispatch stays O(cohort) at 10,000 clients sharing one dataset row,
  ``DataArena`` dedupes rows as the reference's does, a Session hands one
  arena to every runner of a sweep, and a tiered run resumes
  bit-identically (store counters included).
"""
import dataclasses
import pathlib
import sys

import numpy as np
import pytest
import torch

import repro.engine as ref_engine
import repro.engine.statestore as ref_store
import repro_torch.engine.engine as engine_mod
from repro_torch.core.aggregation import FedAsync
from repro_torch.core.testbed import (
    TestbedConfig, build_clients, build_partitions, build_testbed)
from repro_torch.data.synthetic_ser import SERDataConfig
from repro_torch.engine import (
    CheckpointPolicy, CohortRunner, EngineConfig, SimulatedCrash, StoreConfig,
    run_async_engine, run_fedavg_engine)
from repro_torch.engine.statestore import DataArena, TieredStateStore
from repro_torch.models.ser_cnn import SERConfig
from repro_torch.pytree import tree_leaves

sys.path.insert(0, str(pathlib.Path(__file__).parent))
import _torch_ref_runs as R  # noqa: E402

EXACT_FIELDS = ("times", "server_version", "update_counts", "staleness",
                "eps_trajectory", "cohort_sizes", "influence")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    with R.one_torch_thread():
        yield


@pytest.fixture(scope="module")
def ref_runs(tmp_path_factory):
    return R.run_reference(tmp_path_factory.mktemp("ref_runs"),
                           ("tiered_async",))


def _ledger(st):
    assert st["store_fetches"] == (
        st["store_hot_hits"] + st["store_prefetch_hits"]
        + st["store_stall_waits"]), st


def _store_stats(log):
    return {k: v for k, v in log.engine_stats.items()
            if k.startswith("store_")}


# ---------------------------------------------------------------------------
# residency: the same decisions as the reference, call for call
# ---------------------------------------------------------------------------

class _FakeRunner:
    """Records the store's device calls; a spilled row is a (2, 3) float32
    block tagged with the slot (``as_torch`` picks the port's type)."""

    def __init__(self, as_torch: bool):
        self.as_torch = as_torch
        self.calls = []

    def _queue_write(self, slot, tree):
        self.calls.append(("write", int(slot), tree["tag"]))

    def _cancel_writes(self, slot):
        self.calls.append(("cancel", int(slot)))

    def spill_opt_slot(self, slot):
        self.calls.append(("spill", int(slot)))
        row = np.full((2, 3), float(slot), np.float32)
        return {"m": torch.from_numpy(row) if self.as_torch else row}

    def init_opt_rows(self, tree, slots):
        self.calls.append(("init", tree["tag"], [int(s) for s in slots]))

    def load_opt_rows(self, rows, slots):
        self.calls.append(("load", [float(np.asarray(r["m"])[0, 0])
                                    for r in rows],
                           [int(s) for s in slots]))


def _drive(store_cls, cfg_cls, runner, hot, lookahead, seed, n=24,
           max_cohort=4, steps=40):
    store = store_cls(cfg_cls(hot_slots=hot, lookahead=lookahead), n, runner)
    rng = np.random.default_rng(seed)
    trace = []
    for cid in range(n):                       # startup dispatch
        store.note_dispatch(cid, {"tag": 0})
    for t in range(1, steps + 1):
        cohort = [int(c) for c in rng.choice(
            n, size=int(rng.integers(1, max_cohort + 1)), replace=False)]
        trace.append(store.acquire_cohort(cohort))
        store.note_trained(cohort)
        for cid in cohort:                     # re-dispatch on new globals
            store.note_dispatch(cid, {"tag": t})
        ahead = [int(c) for c in rng.choice(n, size=lookahead + 2,
                                            replace=False)]
        store.prefetch_cids(ahead)
    return trace, store


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("hot,lookahead", [(4, 0), (4, 2), (6, 4), (16, 8)])
def test_residency_decisions_equal_reference(hot, lookahead, seed):
    r_runner, p_runner = _FakeRunner(False), _FakeRunner(True)
    r_trace, r_st = _drive(ref_store.TieredStateStore, ref_store.StoreConfig,
                           r_runner, hot, lookahead, seed)
    p_trace, p_st = _drive(TieredStateStore, StoreConfig, p_runner, hot,
                           lookahead, seed)
    assert p_trace == r_trace
    assert p_runner.calls == r_runner.calls
    assert p_st.stats() == r_st.stats()
    assert p_st.state_meta() == r_st.state_meta()
    assert sorted(p_st.cold) == sorted(r_st.cold)
    _ledger(p_st.stats())
    if hot < 16:
        assert p_st.stats()["store_evictions"] > 0
        assert p_st.stats()["store_spill_bytes"] > 0


def test_deadlock_message_equals_reference():
    msgs = []
    for cls, cfg, as_torch in (
            (ref_store.TieredStateStore, ref_store.StoreConfig, False),
            (TieredStateStore, StoreConfig, True)):
        store = cls(cfg(hot_slots=2, lookahead=0), 4, _FakeRunner(as_torch))
        for cid in range(4):
            store.note_dispatch(cid, {"tag": 0})
        with pytest.raises(RuntimeError) as err:
            store.acquire_cohort([0, 1, 2])
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


def test_store_meta_round_trips():
    _, st = _drive(TieredStateStore, StoreConfig, _FakeRunner(True), 6, 4, 3)
    fresh = TieredStateStore(StoreConfig(hot_slots=6, lookahead=4), 24,
                             _FakeRunner(True))
    fresh.load_state_meta(st.state_meta())
    assert fresh.state_meta() == st.state_meta()
    assert fresh.cid_of == st.cid_of


# ---------------------------------------------------------------------------
# config validation, with the reference's messages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(hot_slots=0), dict(hot_slots=2.5),
                                dict(lookahead=-1)], ids=str)
def test_storeconfig_validation_equals_reference(kw):
    with pytest.raises(ValueError) as port_err:
        StoreConfig(**kw)
    with pytest.raises(ValueError) as ref_err:
        ref_store.StoreConfig(**kw)
    assert str(port_err.value) == str(ref_err.value)
    assert StoreConfig().hot_slots is None


@pytest.mark.parametrize("kw", [
    dict(max_cohort=8, hot_slots=4), dict(device_arena=False, hot_slots=8)],
    ids=["max_cohort", "device_arena"])
def test_engineconfig_guards_tiering_like_reference(kw):
    kw = dict(kw)
    hot = kw.pop("hot_slots")
    with pytest.raises(ValueError) as port_err:
        EngineConfig(store=StoreConfig(hot_slots=hot), **kw)
    with pytest.raises(ValueError) as ref_err:
        ref_engine.EngineConfig(store=ref_engine.StoreConfig(hot_slots=hot),
                                **kw)
    assert str(port_err.value) == str(ref_err.value)


# ---------------------------------------------------------------------------
# tiered == all-resident, bit for bit
# ---------------------------------------------------------------------------

def _tb(n=5, sigma=0.5):
    return TestbedConfig(
        data=SERDataConfig(n_total=72 * n, **R.DIMS),
        model=SERConfig(channels1=8, channels2=16, fc_dim=32, **R.DIMS),
        **dict(R.testbed_kwargs(sigma), dp_path="pallas", num_clients=n))


def _go(kind, store, pipeline_depth=2, n=5, **kw):
    cfg = _tb(n)
    clients, params, acc_fn, pooled = build_testbed(cfg, device="cpu")
    ecfg = EngineConfig(staleness_window=30.0, max_cohort=2,
                        pipeline_depth=pipeline_depth, store=store)
    if kind == "fedavg":
        return run_fedavg_engine(clients, params, acc_fn, pooled, rounds=3,
                                 eval_every=3, seed=cfg.seed,
                                 engine_cfg=ecfg, **kw)
    return run_async_engine(clients, params, acc_fn, pooled,
                            FedAsync(alpha=0.4), max_updates=14,
                            eval_every=7, seed=cfg.seed, engine_cfg=ecfg,
                            **kw)


_CACHE = {}


def _cached(kind, store, pipeline_depth=2):
    key = (kind, store, pipeline_depth)
    if key not in _CACHE:
        _CACHE[key] = _go(kind, store, pipeline_depth)
    return _CACHE[key]


def _equal_ex_stats(a, b):
    (pa, la), (pb, lb) = a, b
    assert all(torch.equal(x, y)
               for x, y in zip(tree_leaves(pa), tree_leaves(pb)))
    for f in R.LOG_FIELDS:
        assert getattr(la, f) == getattr(lb, f), f


@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("kind", ["async", "fedavg"])
@pytest.mark.parametrize("store", [StoreConfig(hot_slots=2, lookahead=2),
                                   StoreConfig(hot_slots=3, lookahead=0)],
                         ids=["hot2-look2", "hot3-look0"])
def test_tiered_equals_all_resident_bitwise(kind, store, depth):
    resident = _cached(kind, StoreConfig(), depth)
    tiered = _cached(kind, store, depth)
    _equal_ex_stats(resident, tiered)
    st = _store_stats(tiered[1])
    _ledger(st)
    assert st["store_fetches"] > 0 and st["store_evictions"] > 0
    assert st["store_spill_bytes"] > 0
    assert st["store_sync_reads"] > 0
    if kind == "fedavg":     # the next chunk is prefetched at any lookahead
        assert st["store_prefetch_hits"] > 0
    elif store.lookahead == 0:
        assert st["store_prefetch_hits"] == 0 and st["store_stall_waits"] > 0
    else:
        assert st["store_prefetch_hits"] > 0
    assert all(v == 0 for v in _store_stats(resident[1]).values())
    if depth == 2:
        assert tiered[1].engine_stats["host_syncs_between_evals"] == 0


def test_tiered_counters_equal_reference(ref_runs):
    """The reference's small tiered run, replayed by the port: the store
    counters, the bookkeeping and the scheduler counters all equal."""
    _, _, log, _ = R.execute("repro_torch", "tiered_async",
                             ref_runs["tiered_async"]["init"],
                             dp_path="pallas", device="cpu")
    got = R.log_dict(log, [])
    want = ref_runs["tiered_async"]["log"]
    for f in EXACT_FIELDS:
        assert got[f] == want[f], f
    assert got["counters"] == want["counters"]
    assert got["sched"] == want["sched"]
    st = {k: v for k, v in got["counters"].items() if k.startswith("store_")}
    _ledger(st)
    assert st["store_evictions"] > 0 and st["store_prefetch_hits"] > 0


# ---------------------------------------------------------------------------
# scale, the data arena, sessions and resume
# ---------------------------------------------------------------------------

def test_dispatch_stays_o_cohort_at_10k_clients(monkeypatch):
    """At N = 10,000 clients sharing one dataset row, a short tiered run
    draws batch permutations only for staged cohort members and keeps
    hot_slots + 1 client rows on the device."""
    cfg = _tb()
    splits, pooled = build_partitions(cfg)
    _, params, acc_fn, _ = build_testbed(cfg, device="cpu")
    n = 10_000
    clients = build_clients(cfg, [splits[0]] * n)
    calls = {"n": 0}
    real = engine_mod.plan_batches

    def counting(*a, **kw):
        calls["n"] += 1
        return real(*a, **kw)

    monkeypatch.setattr(engine_mod, "plan_batches", counting)
    ecfg = EngineConfig(staleness_window=30.0, max_cohort=4,
                        pipeline_depth=2,
                        store=StoreConfig(hot_slots=64, lookahead=8))
    runner = CohortRunner(clients, ecfg, "cpu")
    _, log = run_async_engine(clients, params, acc_fn, pooled,
                              FedAsync(alpha=0.5), max_updates=12, seed=0,
                              eval_every=12, runner=runner)
    assert sum(log.update_counts.values()) >= 12
    assert 0 < calls["n"] < 100, calls["n"]
    _ledger(_store_stats(log))
    assert tree_leaves(runner._arena_params)[0].shape[0] == 65
    assert runner.data_arena.n_slots == 2


def test_data_arena_dedupes_like_reference():
    from repro.core.testbed import build_clients as r_build_clients
    from repro.core.testbed import build_partitions as r_build_partitions
    from repro.core.testbed import TestbedConfig as RTestbedConfig
    from repro.data.synthetic_ser import SERDataConfig as RData
    from repro.models.ser_cnn import SERConfig as RSER
    import jax.numpy as jnp
    cfg = _tb(n=8)
    rcfg = RTestbedConfig(
        data=RData(n_total=72 * 8, **R.DIMS),
        model=RSER(channels1=8, channels2=16, fc_dim=32, **R.DIMS),
        **dict(R.testbed_kwargs(0.5), num_clients=8))
    splits, _ = build_partitions(cfg)
    r_splits, _ = r_build_partitions(rcfg)
    for share in (False, True):
        sp = [splits[0]] * 8 if share else splits
        r_sp = [r_splits[0]] * 8 if share else r_splits
        port = DataArena.build(build_clients(cfg, sp), "cpu")
        ref = ref_store.DataArena.build(r_build_clients(rcfg, r_sp), 1,
                                        jnp.asarray)
        assert np.array_equal(port.slot_of_cid, ref.slot_of_cid)
        assert (port.pad_slot, port.n_slots, port.n_max, port.nbytes) == (
            ref.pad_slot, ref.n_slots, ref.n_max, ref.nbytes)
        for k, v in ref.leaves.items():
            np.testing.assert_array_equal(port.leaves[k].numpy(),
                                          np.asarray(v))
        if share:
            assert port.pad_slot == 1 and port.n_slots == 2
        else:
            assert np.array_equal(port.slot_of_cid, np.arange(8))


def test_session_sweep_shares_one_data_arena():
    from repro_torch.api import ExperimentSpec, RunBudget, Session
    sess = Session(device="cpu")
    spec = ExperimentSpec(
        testbed=_tb(), run=RunBudget(max_updates=4, eval_every=4),
        engine=EngineConfig(staleness_window=30.0, max_cohort=2,
                            store=StoreConfig(hot_slots=2, lookahead=2)))
    sess.run(spec)
    arena0 = sess._runner.data_arena
    sess.run(dataclasses.replace(
        spec, testbed=dataclasses.replace(spec.testbed, sigma=1.5)))
    assert sess._runner.data_arena is arena0
    assert sess.events["data_arena_builds"] == 1
    assert sess.events["data_arena_reuses"] == 1


def test_tiered_crash_resume_bit_identical(tmp_path):
    store = StoreConfig(hot_slots=2, lookahead=2)
    ref = _cached("async", store)
    with pytest.raises(SimulatedCrash):
        _go("async", store, checkpoint=CheckpointPolicy(
            str(tmp_path), every=4, crash_after_saves=2))
    resumed = _go("async", store, resume_from=str(tmp_path))
    _equal_ex_stats(ref, resumed)
    # the resumed run replays the same residency and prefetch schedule
    assert _store_stats(resumed[1]) == _store_stats(ref[1])
    assert _store_stats(ref[1])["store_evictions"] > 0
    with pytest.raises(ValueError, match="StoreConfig mismatch"):
        _go("async", StoreConfig(hot_slots=3, lookahead=2),
            resume_from=str(tmp_path))
