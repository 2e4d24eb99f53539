"""The port's program audits and compile guard (mirrors
``tests/test_analysis_audits.py``).

Device-free logic runs on stand-ins; the real-cohort-step audits run the
port's cohort step on two gloo CPU ranks (``tests/_torch_mesh_ranks.py``)
and on one process, where each audit passes on the real step and a
seeded regression (a cohort whole on every rank, a forbidden
collective, a reallocated arena) must fail.  The laws the port shares
with the JAX package are held to it on the same inputs: the engine-stats
audit's verdicts, and the walk of the same collectives and products
(``tests/_torch_ref_hlo.py``)."""
import dataclasses
import pathlib
import sys

import numpy as np
import pytest
import torch

from repro_torch.analysis import (
    AuditFailure, CompileBudgetExceeded, analyze, audit_collectives,
    audit_donation, audit_engine_stats, audit_sharding, compile_guard,
    donation_aliases, step_signature, sweep_max_builds)
from repro_torch.analysis.hlo import NOT_PORTED, ring_traffic
from repro_torch.core.runlog import ENGINE_STATS_KEYS
from repro_torch.engine.mesh_backend import Shard
from repro_torch.pytree import tree_leaves, tree_map

sys.path.insert(0, str(pathlib.Path(__file__).parent))
import _torch_mesh_ranks as M  # noqa: E402
import _torch_ref_hlo as H  # noqa: E402
import _torch_ref_runs as R  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    with R.one_torch_thread():
        yield


# ---------------------------------------------------------------------------
# donation audit: storages before and after
# ---------------------------------------------------------------------------

def test_donation_alias_table_pairs_storages():
    a, b = torch.zeros(8, 4), torch.ones(8, 4)
    outs = {"x": a, "y": b * 2, "z": b[1:]}
    assert donation_aliases({"a": a, "b": b}, outs) == [(0, 0), (2, 1)]
    assert audit_donation({"a": a, "b": b}, outs, expect=True) == 2


def test_donation_aliases_tell_meta_tensors_apart():
    # every meta tensor's data_ptr() is 0; storage identity still differs
    a, b = torch.empty(4, device="meta"), torch.empty(4, device="meta")
    assert a.data_ptr() == b.data_ptr() == 0
    assert donation_aliases([a], [b]) == []
    assert donation_aliases([a], [b, a.view(2, 2)]) == [(1, 0)]


def test_donation_audit_catches_a_reallocated_arena():
    a, b = torch.zeros(8, 4), torch.ones(8, 4)
    with pytest.raises(AuditFailure, match="aliases materialized"):
        audit_donation([a, b], [a, b.clone()], expect=True)
    assert audit_donation([a, b], [a, b.clone()], expect=True,
                          min_aliases=1) == 1


def test_donation_audit_catches_unexpected_alias():
    a, b = torch.zeros(8, 4), torch.ones(8, 4)
    with pytest.raises(AuditFailure, match="expected OFF"):
        audit_donation([a, b], [a + b, b], expect=False)
    assert audit_donation([a, b], [a + b, b * 2], expect=False) == 0


# ---------------------------------------------------------------------------
# sharding audit (stand-in Shard trees)
# ---------------------------------------------------------------------------

def _shard(k, local_rows, width=4):
    return Shard(torch.zeros(local_rows, width), (k, width), 0)


def test_sharding_audit_passes_partitioned():
    tree = {"w": _shard(8, 1), "b": Shard(torch.zeros(1), (2,), 0)}
    assert audit_sharding(tree, client_dim=8, min_partition=2) == 1


def test_sharding_audit_fails_replicated_client_axis():
    with pytest.raises(AuditFailure, match="replicated"):
        audit_sharding({"w": _shard(8, 8)}, client_dim=8)
    # a plain tensor leaf is whole on its rank
    with pytest.raises(AuditFailure, match="replicated"):
        audit_sharding({"w": torch.zeros(8, 4)}, client_dim=8)


def test_sharding_audit_fails_when_nothing_matches():
    with pytest.raises(AuditFailure, match="checked nothing"):
        audit_sharding({"w": _shard(16, 2)}, client_dim=8)
    with pytest.raises(AuditFailure, match="checked nothing"):
        audit_sharding(None, client_dim=8)


# ---------------------------------------------------------------------------
# collective audit and the program walk (synthetic counts)
# ---------------------------------------------------------------------------

def _stats(**kinds):
    """``collectives.stats()``-shaped counts: kind=(calls, bytes, g)."""
    return {k: {"calls": c, "bytes": b, "host_staged": 0, "seconds": 0.0,
                "by_group": {g: {"calls": c, "bytes": b}}}
            for k, (c, b, g) in kinds.items()}


AG = _stats(all_gather=(1, 128, 8))


def test_collective_audit_forbid_fires():
    with pytest.raises(AuditFailure, match="forbidden collective"):
        audit_collectives(AG, forbid=("all-gather",))


def test_collective_audit_budget():
    counts = audit_collectives(AG, max_counts={"all-gather": 1})
    assert counts["all-gather"] == 1
    with pytest.raises(AuditFailure, match="exceeds budget"):
        audit_collectives(AG, max_counts={"all-gather": 0})


@pytest.mark.parametrize("g", [2, 4, 8, 16])
def test_walk_follows_the_ring_multipliers(g):
    b = 1024
    walk = analyze(_stats(all_gather=(3, 3 * b, g), all_reduce=(2, 2 * b, g),
                          reduce_scatter=(1, b, g), broadcast=(1, b, g),
                          barrier=(1, 0, g)), dot_flops=12)
    ring = (g - 1) / g
    assert walk["collective_traffic_bytes"] == {
        "all-gather": (g - 1) * 3 * b, "all-reduce": 2 * ring * 2 * b,
        "reduce-scatter": ring * b, "broadcast": float(b), "barrier": 0.0}
    assert walk["collective_counts"] == {
        "all-gather": 3, "all-reduce": 2, "reduce-scatter": 1,
        "broadcast": 1, "barrier": 1}
    assert walk["total_collective_bytes"] == pytest.approx(
        sum(walk["collective_traffic_bytes"].values()))
    assert walk["dot_flops"] == 12.0 and walk["hbm_bytes"] is None
    assert set(NOT_PORTED) == {"hbm_bytes", "parse_module", "hlo_ops"}


def test_walk_sums_calls_over_group_sizes():
    st = {"all_reduce": {"calls": 3, "bytes": 300, "by_group": {
        2: {"calls": 1, "bytes": 100}, 4: {"calls": 2, "bytes": 200}}}}
    walk = analyze(st)
    assert walk["collective_traffic_bytes"]["all-reduce"] == pytest.approx(
        ring_traffic("all-reduce", 100, 2)
        + ring_traffic("all-reduce", 200, 4))
    assert ring_traffic("all-gather", 100, 1) == 0.0


@pytest.mark.parametrize("g", [2, 4, 16])
def test_walk_equals_the_reference_walk_of_the_same_program(g):
    """The port's collectives on a fake group of ``g`` ranks and one
    product under ``FlopCounterMode``, against the JAX package's walk of
    an HLO module running the same collectives on ``replica_groups=
    [1,g]`` and the same product."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.launch import collectives as coll
    from repro_torch.launch.dryrun import fake_group
    x, y = torch.zeros(6, 8), torch.zeros(2 * g, 8)
    coll.reset_stats()
    try:
        with fake_group(g):
            coll.all_gather_rows(x, None)
            coll.all_reduce_sum(x, None)
            coll.all_reduce_sum(y, None)
            coll.reduce_scatter_rows(y, None)
            st = coll.stats()
    finally:
        coll.reset_stats()
    with FlopCounterMode(display=False) as fc:
        torch.mm(x, x.T)
    ours = analyze(st, fc.get_total_flops())
    nx, ny = x.numel() * 4, y.numel() * 4
    ref = H.reference_walk([("all-gather", nx), ("all-reduce", nx),
                            ("all-reduce", ny), ("reduce-scatter", ny)], g,
                           dots=[(6, 8, 6)])
    assert ours["collective_counts"] == ref["collective_counts"]
    assert ours["collective_traffic_bytes"].keys() == ref[
        "collective_traffic_bytes"].keys()
    for kind, t in ref["collective_traffic_bytes"].items():
        assert ours["collective_traffic_bytes"][kind] == pytest.approx(
            t, rel=1e-12), kind
    assert ours["total_collective_bytes"] == pytest.approx(
        ref["total_collective_bytes"], rel=1e-12)
    assert ours["dot_flops"] == ref["dot_flops"] == 2 * 6 * 6 * 8


# ---------------------------------------------------------------------------
# engine-stats audit
# ---------------------------------------------------------------------------

def _est(**over):
    base = {k: 0 for k in ENGINE_STATS_KEYS}
    base.update(data_path="arena", dp_path="jnp", pallas_interpret=None,
                h2d_bytes_per_cohort=0.0, pipeline_depth=1)
    base.update(over)
    return base


def test_engine_stats_audit_roundtrip():
    assert audit_engine_stats(_est()) == _est()


def test_engine_stats_audit_catches_drift():
    missing = _est()
    missing.pop("drain_waits")
    with pytest.raises(AuditFailure, match="drain_waits"):
        audit_engine_stats(missing)
    with pytest.raises(AuditFailure, match="new_counter"):
        audit_engine_stats(_est(new_counter=3))


def test_engine_stats_audit_cross_field_invariants():
    with pytest.raises(AuditFailure, match="submit/drain overlap"):
        audit_engine_stats(_est(pipeline_depth=2,
                                host_syncs_between_evals=1))
    with pytest.raises(AuditFailure, match="interpret provenance"):
        audit_engine_stats(_est(dp_path="pallas"))
    audit_engine_stats(_est(dp_path="pallas", cohorts=3, pallas_interpret={
        "backend": "cpu", "kernel": "plain", "launches": 0}))
    audit_engine_stats(_est(dp_path="pallas", cohorts=3, pallas_interpret={
        "backend": "cuda", "kernel": "triton", "launches": 12}))


def test_engine_stats_audit_holds_the_card_to_its_kernel():
    with pytest.raises(AuditFailure, match="plain route"):
        audit_engine_stats(_est(dp_path="pallas", cohorts=3,
                                pallas_interpret={"backend": "cuda",
                                                  "kernel": "plain",
                                                  "launches": 0}))
    with pytest.raises(AuditFailure, match="0 launches"):
        audit_engine_stats(_est(dp_path="pallas", cohorts=3,
                                pallas_interpret={"backend": "cuda",
                                                  "kernel": "triton",
                                                  "launches": 0}))
    # no cohort ran: no launch is owed
    audit_engine_stats(_est(dp_path="pallas", pallas_interpret={
        "backend": "cuda", "kernel": "triton", "launches": 0}))


@pytest.mark.parametrize("law,over", [
    ("fault ledger", dict(fault_upload_losses=3, fault_retries=1,
                          fault_lost_updates=1)),
    ("screening ledger", dict(screen_rejections=2, screen_nonfinite=1)),
    ("store ledger", dict(store_fetches=4, store_hot_hits=1,
                          store_prefetch_hits=1, store_stall_waits=1)),
])
def test_engine_stats_audit_ledger_laws(law, over):
    with pytest.raises(AuditFailure, match=law):
        audit_engine_stats(_est(**over))


def _dropped(key):
    st = _est()
    st.pop(key)
    return st


# engine stats the two packages' audits must judge alike: sound, and
# each law broken (the provenance law is the port's own on the card;
# off it both want the record)
SHARED_STATS = {
    "sound": _est(),
    "pipelined": _est(pipeline_depth=2, drain_waits=3),
    "pipelined_syncs": _est(pipeline_depth=2, host_syncs_between_evals=1),
    "pallas_recorded": _est(dp_path="pallas", cohorts=3, pallas_interpret={
        "backend": "cpu", "kernel": "plain", "launches": 0}),
    "pallas_unrecorded": _est(dp_path="pallas", cohorts=3),
    "faults_balanced": _est(fault_upload_losses=3, fault_retries=2,
                            fault_lost_updates=1),
    "faults_unbalanced": _est(fault_upload_losses=3, fault_retries=1,
                              fault_lost_updates=1),
    "screen_balanced": _est(screen_rejections=3, screen_nonfinite=1,
                            screen_norm_rejects=2),
    "screen_unbalanced": _est(screen_rejections=2, screen_nonfinite=1),
    "store_balanced": _est(store_fetches=6, store_hot_hits=3,
                           store_prefetch_hits=2, store_stall_waits=1),
    "store_unbalanced": _est(store_fetches=4, store_hot_hits=1,
                             store_prefetch_hits=1, store_stall_waits=1),
    "key_missing": _dropped("drain_waits"),
    "key_extra": _est(new_counter=3),
}


def _verdict(audit, stats):
    try:
        audit(dict(stats))
    except Exception as e:                  # noqa: BLE001 - compared below
        return type(e).__name__, str(e)
    return None


@pytest.mark.parametrize("case", sorted(SHARED_STATS))
def test_engine_stats_verdicts_equal_the_reference(case):
    from repro.analysis.audits import audit_engine_stats as ref_audit
    ref = _verdict(ref_audit, SHARED_STATS[case])
    ours = _verdict(audit_engine_stats, SHARED_STATS[case])
    assert (ours is None) == (ref is None), (ours, ref)
    if ref is not None:
        assert ours[0] == ref[0] == "AuditFailure"
        # the same law: the reference's message up to its first dash
        # (the port names its own modules after it)
        assert ours[1].split(" — ")[0] == ref[1].split(" — ")[0]


# ---------------------------------------------------------------------------
# compile guard
# ---------------------------------------------------------------------------

def test_compile_guard_budget_and_delta():
    from repro_torch.engine import cohort_step
    base = cohort_step._STEP_BUILDS
    try:
        with compile_guard(2, label="test") as g:
            cohort_step._STEP_BUILDS += 1
            assert g.delta == 1
        assert g.delta == 1
        with pytest.raises(CompileBudgetExceeded, match="budgeted for 0"):
            with compile_guard(0, label="test"):
                cohort_step._STEP_BUILDS += 1
    finally:
        cohort_step._STEP_BUILDS = base


def test_compile_budget_exceeded_is_an_audit_failure():
    assert issubclass(CompileBudgetExceeded, AuditFailure)
    assert issubclass(AuditFailure, AssertionError)


def test_compile_guard_never_masks_exceptions():
    from repro_torch.engine import cohort_step
    base = cohort_step._STEP_BUILDS
    try:
        with pytest.raises(RuntimeError, match="boom"):
            with compile_guard(0):
                cohort_step._STEP_BUILDS += 5
                raise RuntimeError("boom")
    finally:
        cohort_step._STEP_BUILDS = base


def test_compile_guard_rejects_negative_budget():
    with pytest.raises(ValueError):
        with compile_guard(-1):
            pass


def test_sigma_grid_is_one_signature():
    from repro_torch.api.spec import ExperimentSpec, replace_path
    spec = replace_path(ExperimentSpec(), "testbed.use_dp", True)
    grid = [replace_path(spec, "testbed.sigma", s) for s in (0.5, 1.0, 2.0)]
    assert sweep_max_builds(grid) == 1
    assert len({step_signature(s) for s in grid}) == 1
    grid.append(replace_path(spec, "testbed.sigma", 0.0))
    assert sweep_max_builds(grid) == 2
    grid.append(replace_path(grid[0], "testbed.dp_path", "pallas"))
    assert sweep_max_builds(grid) == 3
    legacy = dataclasses.replace(spec, backend="legacy")
    assert step_signature(legacy) is None
    assert sweep_max_builds([legacy]) == 0


# ---------------------------------------------------------------------------
# the real cohort step on one process: the arenas are written in place
# ---------------------------------------------------------------------------

def _runner(**engine):
    from repro_torch.core.testbed import build_testbed
    from repro_torch.engine import CohortRunner, EngineConfig
    clients, params, _, _ = build_testbed(M.tiny_cfg(1.0), device="cpu")
    runner = CohortRunner(clients, EngineConfig(max_cohort=4, **engine),
                          "cpu")
    plans = [runner.dispatch(c, params, 100 + c.cid, 0)
             for c in clients[:4]]
    return runner, plans


def test_real_step_writes_its_arenas_in_place():
    runner, plans = _runner()
    before = (runner._arena_params, runner._arena_opt)
    upload = runner.run_cohort(plans)
    after = (runner._arena_params, runner._arena_opt)
    n = len(tree_leaves(before))
    assert audit_donation(before, after, expect=True) == n
    # the uploads are new tensors: none aliases an arena
    assert audit_donation(before, upload, expect=False) == 0


def test_seeded_reallocating_step_fails_the_arena_audit():
    runner, plans = _runner()
    real = runner.cohort_step

    def reallocating(*a, **kw):
        upload, arena_opt, screen = real(*a, **kw)
        return upload, tree_map(torch.clone, arena_opt), screen

    reallocating.partition = None
    runner.cohort_step = reallocating
    before = (runner._arena_params, runner._arena_opt)
    runner.run_cohort(plans)
    with pytest.raises(AuditFailure, match="reallocated"):
        audit_donation(before, (runner._arena_params, runner._arena_opt),
                       expect=True)


def test_real_run_engine_stats_pass_the_audit():
    _, _, log, _ = R.execute("repro_torch", "async_window", dp_path="pallas",
                             device="cpu")
    st = audit_engine_stats(log.engine_stats, label="async_window")
    assert st["pallas_interpret"]["kernel"] == "plain"
    assert st["cohorts"] > 0
    # the JAX package's audit passes the port's record as well
    from repro.analysis.audits import audit_engine_stats as ref_audit
    ref_audit(dict(log.engine_stats), label="async_window")


# ---------------------------------------------------------------------------
# the real cohort step on two gloo ranks
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    res = M.spawn("audit_ranks", tmp_path_factory.mktemp("audit_ranks"))
    for r in res:
        for case in ("full", "whole"):
            assert "error" not in r[case], r[case].get("error")
    return res


def test_real_step_client_axis_partitions(ranks):
    for r in ranks:
        full = r["full"]
        audited = audit_sharding(full["partition"], client_dim=full["k_pad"],
                                 min_partition=M.WORLD)
        assert audited == len(tree_leaves(full["partition"])) > 0


def test_seeded_whole_cohort_fails_the_sharding_audit(ranks):
    for r in ranks:
        whole = r["whole"]
        with pytest.raises(AuditFailure, match="replicated"):
            audit_sharding(whole["partition"], client_dim=whole["k_pad"],
                           min_partition=M.WORLD)


def test_real_step_collective_budget(ranks):
    for r in ranks:
        st = r["full"]["collectives"]
        # one all-gather per run of one dtype in the trained (params,
        # Adam state) members' leaf order: the params, Adam's int32 step
        # counter, its moments
        counts = audit_collectives(
            st, forbid=("all-reduce", "reduce-scatter", "broadcast"),
            max_counts={"all-gather": 3})
        assert counts.get("all-gather", 0) > 0       # the gather IS there
        walk = analyze(st)
        assert walk["collective_traffic_bytes"]["all-gather"] == (
            (M.WORLD - 1) * st["all_gather"]["bytes"])
        with pytest.raises(AuditFailure, match="forbidden collective"):
            audit_collectives(st, forbid=("all-gather",))
        # the whole cohort trains on every rank and gathers nothing
        assert audit_collectives(r["whole"]["collectives"],
                                 forbid=("all-gather",)) == {}


def test_audit_ranks_ran_on_two_ranks(ranks):
    assert [r["rank"] for r in ranks] == [0, 1]
    assert all(r["mesh"] == {"data": 2, "model": 1} for r in ranks)
    # both ranks record the same global shapes, each its own rows
    a, b = (tree_leaves(r["full"]["partition"]) for r in ranks)
    assert [l.shape for l in a] == [l.shape for l in b]
    assert {l.offset for l in a} == {0} and {l.offset for l in b} == {
        a[0].local.shape[0]}
    assert np.array_equal(np.asarray(a[0].shape), np.asarray(b[0].shape))
