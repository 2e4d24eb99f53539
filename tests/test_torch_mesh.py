"""The port's mesh (``repro_torch.launch.{mesh,shardings,collectives}``,
``repro_torch.engine.mesh_backend``) against the JAX package's rules, and
the cohort engine run on a two-rank gloo mesh on the CPU.

* The sharding rules are pure shape logic: ``leaf_spec``,
  ``tree_shardings`` and ``batch_spec`` equal the JAX package's
  ``PartitionSpec`` entries on abstract (4, 2), (8, 1) and (2, 4) meshes
  for every leaf of all ten zoo configs, roles ``client`` and
  ``master``, both ``attn_shard`` options; ``cohort_spec``,
  ``largest_divisor`` and ``make_host_mesh``'s clamping equal the
  reference's cases (``tests/test_mesh_backend.py``), the clamping on a
  six-rank fake process group.
* The engine: one module-scoped pair of gloo ranks
  (``tests/_torch_mesh_ranks.py``) runs every case once, each rank
  training its half of every cohort, then the tests read the results.
  The JAX package cannot run a mesh on the installed JAX (ROADMAP.md
  queue 3), so a W = 2 run is held, as the reference holds its own mesh
  runs, to single-device runs of the same configuration:

  - to the JAX package's run (``tests/_torch_ref_runs.py``, from its
    initial params): bookkeeping exactly equal, params within
    ``test_torch_engine_parity.py``'s run tolerance (1e-5 for the
    ``"fl_step"`` executor, as in ``test_torch_engine_axes.py``);
  - to the port's one-process run: bookkeeping exactly equal, and params
    bit for bit where each member's local round is the same program on
    one rank as in one process (``"unroll"``, ``"map"``, ``"fl_step"``,
    host-fed, pipelined, tiered, a crash/resume, a spec's mesh).  The
    batched executors (``"vmap"`` and ``dp_path="pallas"``'s step-major
    one) batch K / 2 members per rank where one process batches K, which
    rounds differently; they are held at 1e-5 at sigma = 1.  At sigma = 0
    under Adam the group norm leaves ``conv1.b`` a gradient of rounding
    noise whose sign Adam's first step turns into +-lr
    (``test_torch_engine_axes.py``), so there they are held at the run
    tolerance;
  - rank 0 to rank 1: everything equal, bookkeeping and params.
* The partition proof (``assert_cohort_partitioned``): a cohort of 4 and
  a padded cohort of 3 hold 2 members per rank; a host-fed cohort of 3
  is replicated and the proof says so.
"""
import pathlib
import re
import sys

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

import repro.engine.mesh_backend as r_mb
import repro.launch.mesh as r_mesh
import repro.launch.shardings as r_sh
from repro.configs import ARCH_IDS
from repro.configs import get_config as r_get_config
from repro.models.base import get_family as r_get_family

from repro_torch.configs import get_config as t_get_config
from repro_torch.engine import mesh_backend as t_mb
from repro_torch.launch import mesh as t_mesh
from repro_torch.launch import shardings as t_sh
from repro_torch.models.base import get_family as t_get_family
from repro_torch.pytree import tree_leaves, tree_map

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
import _torch_mesh_ranks as M  # noqa: E402
import _torch_ref_runs as R  # noqa: E402

ROADMAP_19 = r"ROADMAP\.md queue 1 item 19"
PARAMS_ATOL = 1e-2                 # test_torch_engine_parity.py
EXACT_FIELDS = ("times", "server_version", "update_counts", "staleness",
                "eps_trajectory", "cohort_sizes", "influence")
REF_ENTRIES = ("fedavg", "async_window", "fl_step_clip")
# case -> params tolerance against the port's one-process run (0: bitwise)
ONE_PROCESS_TOL = {
    "fedavg": 0.0, "async_window": 0.0, "async_map": 0.0, "fl_step": 0.0,
    "async_pallas": PARAMS_ATOL, "noisy_vmap": 1e-5, "noisy_pallas": 1e-5,
    "fedavg_noisy_vmap": 1e-5, "hostfed": 0.0, "pipelined": 0.0,
    "tiered": 0.0,
}
# the counters a mesh changes by construction: a padded cohort uploads
# its pad members' index plans
MESH_STATS = ("h2d_bytes_total", "h2d_bytes_per_cohort")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    with R.one_torch_thread():
        yield


# ---------------------------------------------------------------------------
# the sharding rules against the reference's, on abstract meshes
# ---------------------------------------------------------------------------

MESHES = ((4, 2), (8, 1), (2, 4))
_SHAPES = {}


def _amesh(data, model):
    try:
        return jax.sharding.AbstractMesh((data, model), ("data", "model"))
    except TypeError:
        return jax.sharding.AbstractMesh((("data", data), ("model", model)))


def _shapes(arch):
    """Both packages' param shapes of the full config (the reference's by
    ``eval_shape``, the port's on the ``meta`` device), leaf for leaf."""
    if arch not in _SHAPES:
        r_cfg, t_cfg = r_get_config(arch), t_get_config(arch)
        r_tree = jax.eval_shape(lambda: r_get_family(r_cfg.family)
                                .init_params(jax.random.PRNGKey(0), r_cfg))
        t_tree = t_get_family(t_cfg.family).init_params(
            t_cfg, seed=0, device="meta")
        r_shapes = [tuple(l.shape) for l in jax.tree_util.tree_leaves(r_tree)]
        t_shapes = [tuple(l.shape) for l in tree_leaves(t_tree)]
        assert r_shapes == t_shapes
        _SHAPES[arch] = (r_cfg, t_cfg, r_tree, t_tree, t_shapes)
    return _SHAPES[arch]


@pytest.fixture
def attn_options():
    yield
    r_sh.set_sharding_options(attn_shard="even")
    t_sh.set_sharding_options(attn_shard="even")


@pytest.mark.parametrize("attn", ["even", "heads_padded"])
@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_leaf_specs_equal_the_reference(arch, shape, attn, attn_options):
    """Every leaf's spec, roles ``master`` and ``client`` (the G-stacked
    leaves), ``tree_shardings`` of both and ``batch_spec``."""
    r_sh.set_sharding_options(attn_shard=attn)
    t_sh.set_sharding_options(attn_shard=attn)
    r_cfg, t_cfg, r_tree, t_tree, shapes = _shapes(arch)
    amesh, tmesh = _amesh(*shape), t_mesh.HostMesh.abstract(*shape)
    assert t_sh._model_candidates(t_cfg) == r_sh._model_candidates(r_cfg)
    for leaf in shapes:
        for role, s in (("master", leaf), ("client", (shape[0],) + leaf)):
            assert t_sh.leaf_spec(s, t_cfg, tmesh, role) == tuple(
                r_sh.leaf_spec(s, r_cfg, amesh, role)), (role, s)
    for role in ("master", "client"):
        r_tr = r_tree if role == "master" else jax.tree_util.tree_map(
            lambda l: jax.ShapeDtypeStruct((shape[0],) + l.shape, l.dtype),
            r_tree)
        t_tr = t_tree if role == "master" else tree_map(
            lambda l: torch.empty((shape[0],) + l.shape, device="meta"),
            t_tree)
        got = [ns.spec for ns in tree_leaves(
            t_sh.tree_shardings(t_tr, t_cfg, tmesh, role))]
        want = [tuple(ns.spec) for ns in jax.tree_util.tree_leaves(
            r_sh.tree_shardings(r_tr, r_cfg, amesh, role))]
        assert got == want
        assert all(ns.mesh is tmesh for ns in tree_leaves(
            t_sh.tree_shardings(t_tr, t_cfg, tmesh, role)))
    for extra in (1, 2):
        assert t_sh.batch_spec(tmesh, extra) == tuple(
            r_sh.batch_spec(amesh, extra))


@pytest.mark.parametrize("shape", [(8, 5, 40, 64), (16,), (4, 5), (2, 3, 3),
                                   ()], ids=str)
def test_cohort_spec_equals_the_reference(shape):
    """Divisible cohorts partition, uneven ones replicate (the reference's
    cases, ``tests/test_mesh_backend.py:43-58``)."""
    got = t_mb.cohort_spec(t_mesh.HostMesh.abstract(8, 1), shape)
    assert got == tuple(r_mb.cohort_spec(_amesh(8, 1), shape))


def test_cohort_sharding_hashable_per_mesh():
    tm = t_mesh.HostMesh.abstract(8, 1)
    a, b = t_mb.CohortSharding(tm), t_mb.CohortSharding(tm)
    assert a == b and hash(a) == hash(b) and len({a, b}) == 1
    assert a.spec((8, 3)) == ("data", None)
    assert a != t_mb.CohortSharding(t_mesh.HostMesh.abstract(4, 1))


def test_step_cache_keyed_per_mesh_with_invalidation():
    """A sharding keys its own step-cache entry; invalidation drops a
    mesh's entries only (``tests/test_mesh_backend.py:70-94``)."""
    from repro_torch.core.dp import DPConfig
    from repro_torch.engine.cohort_step import (
        cached_cohort_step, invalidate_step_cache)
    from repro_torch.optim.optimizers import Adam

    def loss(p, ex):
        return ((p["w"] - ex["x"]) ** 2).sum()

    tm = t_mesh.HostMesh.abstract(8, 1)
    args = (loss, DPConfig(clip_norm=1.0, noise_multiplier=0.0), Adam(lr=0.1))
    sh = t_mb.CohortSharding(tm)
    invalidate_step_cache(tm)
    s1 = cached_cohort_step(*args, client_axis="vmap", sharding=sh)
    s2 = cached_cohort_step(*args, client_axis="vmap",
                            sharding=t_mb.CohortSharding(tm))
    assert s1 is s2
    s3 = cached_cohort_step(*args, client_axis="vmap")
    assert s3 is not s1
    assert invalidate_step_cache(tm) == 1
    assert cached_cohort_step(*args, client_axis="vmap", sharding=sh) \
        is not s1
    assert cached_cohort_step(*args, client_axis="vmap") is s3
    invalidate_step_cache(tm)


def test_largest_divisor_equals_the_reference():
    for n, k, want in ((6, 4, 3), (8, 6, 4), (8, 8, 8), (7, 3, 1), (6, 0, 1),
                       (6, 100, 6)):
        assert t_mesh.largest_divisor(n, k) == want
        assert r_mesh.largest_divisor(n, k) == want


@pytest.fixture
def six_rank_group():
    """A six-rank fake process group in this process (no peers, no
    communication): what ``make_host_mesh`` clamps against."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=6)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_make_host_mesh_clamps_on_a_six_rank_group(six_rank_group):
    """The reference's cases on six forced devices
    (``tests/test_mesh_backend.py:108-140``), on six ranks; a mesh over
    fewer ranks than the group is built but refuses to run."""
    for (data, model), want in (((4, 1), (3, 1)), ((6, 4), (6, 1)),
                                ((2, 3), (2, 3)), ((2, 2), (2, 1)),
                                ((0, 1), (1, 1))):
        m = t_mesh.make_host_mesh(data=data, model=model)
        assert m.shape == {"data": want[0], "model": want[1]}
        assert m.size == want[0] * want[1] and m.world == 6
    m = t_mesh.make_host_mesh(data=6)
    assert t_mesh.require_runnable(m) is m and m.group is not None
    assert t_mb.cohort_mesh(max_cohort=4).shape == {"data": 3, "model": 1}
    with pytest.raises(ValueError, match="spans 3 of the process group's 6"):
        t_mesh.require_runnable(t_mesh.make_host_mesh(data=4))
    # a model axis runs (the cohort engine and every family's round)
    m = t_mesh.make_host_mesh(data=2, model=3)
    assert t_mesh.require_runnable(m) is m


def test_make_host_mesh_without_a_group_is_one_by_one():
    for data, model in ((1, 1), (8, 1), (0, 4)):
        m = t_mesh.make_host_mesh(data=data, model=model)
        assert m.shape == {"data": 1, "model": 1} and m.group is None
        assert m == t_mesh.make_host_mesh() and hash(m) == hash(
            t_mesh.make_host_mesh())
    assert t_mb.cohort_mesh().shape == {"data": 1, "model": 1}
    assert t_mesh.data_axes(m) == ("data",) and t_mesh.model_axis(m) == \
        "model" and t_mesh.num_client_groups(m) == 1


# ---------------------------------------------------------------------------
# ROADMAP.md queue 1 item 19: the model axis, every part of it run,
# the reference's dry-run knobs included
# ---------------------------------------------------------------------------

def test_the_model_axis_runs_every_dry_run_knob():
    from repro_torch.launch import dryrun
    # the production meshes run: abstract outside a group of their size
    # (launch/dryrun.py makes one; tests/test_torch_dryrun.py runs it)
    m = t_mesh.make_production_mesh()
    assert m.shape == {"data": 16, "model": 16} and m.world is None
    pod = t_mesh.make_production_mesh(multi_pod=True)
    assert pod.shape == {"pod": 2, "data": 16, "model": 16}
    assert t_mesh.data_axes(pod) == ("pod", "data")
    assert t_mesh.num_client_groups(pod) == 32 and pod.size == 512
    # cache_shardings runs (its specs against the JAX package's:
    # tests/test_torch_dryrun.py)
    cfg = t_get_config("smollm-360m")
    cache = t_get_family(cfg.family).init_cache(cfg, 8, 64, device="meta")
    sh = t_sh.cache_shardings(cache, cfg, t_mesh.HostMesh.abstract(2, 2),
                              batch_size=8)
    assert sh["k"].spec == (None, "data", None, None, "model")
    # the reference's training knobs run (a reduced combination: the
    # one-client-per-rank placement traces one row per client)
    res = dryrun.run_one("smollm-360m", "train_4k", "single",
                         remat_policy="dots", client_placement="dp")
    assert res["status"] == "ok", res.get("error")
    assert (res["remat_policy"], res["client_placement"],
            res["n_micro"]) == ("dots", "dp", 1)
    # and the padded uneven heads (tests/test_torch_heads_padded*.py): the
    # CLI takes the knob, and gemma2-2b's 8/4 heads pad over 16 ranks
    args = dryrun.build_parser().parse_args(
        ["--arch", "gemma2-2b", "--shape", "decode_32k", "--attn-shard",
         "heads_padded"])
    assert args.attn_shard == "heads_padded"
    res = dryrun.run_one("gemma2-2b", "decode_32k", "single",
                         attn_shard="heads_padded")
    assert res["status"] == "ok", res.get("error")
    assert res["attn_shard"] == "heads_padded"
    assert t_sh._OPTS["attn_shard"] == "even"
    assert not hasattr(t_mesh, "not_ported")
    # a model axis passes, and then wants the mesh's ranks
    # (test_torch_model_axis, test_torch_model_axis_zoo run on them)
    with pytest.raises(ValueError,
                       match="spans 2 of the process group's 1") as e:
        t_mesh.require_runnable(t_mesh.HostMesh(1, 2, world=2))
    assert not re.search(ROADMAP_19, str(e.value))
    sh = t_sh.NamedSharding(t_mesh.HostMesh.abstract(1, 2), ("model", None))
    assert t_sh.data_dim(sh) is None and t_sh.model_dim(sh) == 0
    one = t_sh.NamedSharding(t_mesh.HostMesh.abstract(2, 1),
                             ("model", "data"))
    assert t_sh.data_dim(one) == 1          # "model" of size 1 is a no-op
    assert t_sh.model_dim(one) is None


# ---------------------------------------------------------------------------
# the cohort engine on two gloo ranks
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref_runs(tmp_path_factory):
    return R.run_reference(tmp_path_factory.mktemp("ref_runs"), REF_ENTRIES)


def _init(ref_runs):
    return {case: ref_runs[entry]["init"]
            for case, (entry, _, _, from_ref) in M.ENGINE_CASES.items()
            if from_ref}


@pytest.fixture(scope="module")
def ranks(ref_runs, tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh_ranks")
    return out, M.spawn("engine_ranks", out, init=_init(ref_runs))


_ONE = {}


def _one_process(ref_runs, case):
    if case not in _ONE:
        _, params, log, calls = M.run_case(case, _init(ref_runs))
        _ONE[case] = M.summary(params, log, calls)
    return _ONE[case]


def _result(ranks, case, rank=0):
    res = ranks[1][rank][case]
    assert "error" not in res, res.get("error")
    return res


def _same_logs(a, b, mesh_vs_one=False):
    for f in R.LOG_FIELDS + ("counters", "screen_calls"):
        assert a[f] == b[f], f
    drop = MESH_STATS if mesh_vs_one else ()
    sa = {k: v for k, v in a["engine_stats"].items() if k not in drop}
    sb = {k: v for k, v in b["engine_stats"].items() if k not in drop}
    assert sa == sb


def _max_diff(a, b):
    return max(float(np.abs(x - y).max()) for x, y in zip(a, b))


def test_a_model_axis_runs_for_the_production_families(ranks, ref_runs):
    """On the two ranks a (1, 2) mesh is runnable: rank r is model coordinate r of one model group,
    whose tensor-parallel collectives sum and gather over both ranks.
    The cohort engine runs on it too, its members replicated over the
    model axis: on each rank bit for bit the one-process run (a data axis
    of 1)."""
    one = _one_process(ref_runs, "async_window")
    for r in range(M.WORLD):
        res = _result(ranks, "model_axis", r)
        assert res["runnable"] is True
        assert res["coords"] == (0, r) and res["sizes"] == (1, 2)
        assert res["reduced"] == [3.0]
        assert res["gathered"] == [[0.0, 1.0]]
        _same_logs(res["engine"]["log"], one["log"], mesh_vs_one=True)
        for a, b in zip(res["engine"]["params"], one["params"]):
            assert np.array_equal(a, b)


def test_ranks_ran_on_a_two_rank_mesh(ranks):
    r0, r1 = ranks[1]
    assert r0["mesh"] == r1["mesh"] == {"data": 2, "model": 1}
    assert (r0["rank"], r1["rank"]) == (0, 1)
    for r in (r0, r1):
        st = r["collectives"]
        assert st["all_gather"]["calls"] > 0 and st["all_gather"]["bytes"] > 0
        assert st["all_gather"]["host_staged"] == 0      # CPU tensors


def test_collectives_on_known_values(ranks):
    """Shards, their all-gather back to whole leaves, the reduce-scatter
    of whole leaves onto shards (all-reduce where replicated), the member
    gather in rank order, a broadcast and an all-reduce."""
    whole_a = np.arange(24.0, dtype=np.float32).reshape(2, 4, 3)
    whole_b = np.arange(5.0, dtype=np.float32)
    for r in (0, 1):
        got = _result(ranks, "collective_cases", r)
        np.testing.assert_array_equal(got["shard"][0],
                                      whole_a[:, 2 * r:2 * r + 2])
        np.testing.assert_array_equal(got["shard"][1], whole_b)
        np.testing.assert_array_equal(got["gathered"][0], whole_a)
        np.testing.assert_array_equal(got["gathered"][1], whole_b)
        np.testing.assert_array_equal(got["summed"][0],
                                      3 * whole_a[:, 2 * r:2 * r + 2])
        np.testing.assert_array_equal(got["summed"][1], 3 * whole_b)
        np.testing.assert_array_equal(got["members"][0], np.repeat(
            np.arange(2, dtype=np.int32), 2)[:, None] * np.ones(3, np.int32))
        np.testing.assert_array_equal(got["members"][1], [0, 0, 1, 1])
        assert got["broadcast"] == [11.0] and got["all_reduce"] == [3.0]
        assert got["mesh_equal"]


CASES = tuple(M.ENGINE_CASES) + ("resume", "session")


@pytest.mark.parametrize("case", CASES)
def test_ranks_agree(ranks, case):
    """Every rank ran the same host bookkeeping and holds the same
    globals, bit for bit."""
    a, b = _result(ranks, case, 0), _result(ranks, case, 1)
    _same_logs(a["log"], b["log"])
    for x, y in zip(a["params"], b["params"]):
        assert np.array_equal(x, y)


@pytest.mark.parametrize("case", tuple(M.ENGINE_CASES))
def test_matches_the_one_process_run(ranks, ref_runs, case):
    got, want = _result(ranks, case), _one_process(ref_runs, case)
    _same_logs(got["log"], want["log"], mesh_vs_one=True)
    assert max(got["log"]["cohort_sizes"]) > 1
    for x, y in zip(got["params"], want["params"]):
        assert np.isfinite(x).all()
    tol = ONE_PROCESS_TOL[case]
    if tol == 0.0:
        for x, y in zip(got["params"], want["params"]):
            assert np.array_equal(x, y)
    else:
        assert _max_diff(got["params"], want["params"]) <= tol


@pytest.mark.parametrize("case", [c for c, v in M.ENGINE_CASES.items()
                                  if v[3]])
def test_matches_the_reference_run(ranks, ref_runs, case):
    """The W = 2 run against the JAX package's single-device run of the
    same configuration from the same initial params."""
    got = _result(ranks, case)
    entry = M.ENGINE_CASES[case][0]
    want = ref_runs[entry]
    for f in EXACT_FIELDS:
        assert got["log"][f] == want["log"][f], f
    tol = 1e-5 if case == "fl_step" else PARAMS_ATOL
    for a, b in zip(want["final"], got["params"]):
        np.testing.assert_allclose(b, a, rtol=0, atol=tol)


def test_crash_resume_equals_the_uninterrupted_run(ranks):
    """Rank 0 wrote the snapshot, both ranks restored it: the resumed
    run's RunLog and params equal the uninterrupted W = 2 run's."""
    got, want = _result(ranks, "resume"), _result(ranks, "async_window")
    _same_logs(got["log"], want["log"])
    for x, y in zip(got["params"], want["params"]):
        assert np.array_equal(x, y)
    assert sorted(p.name for p in (ranks[0] / "ckpt").iterdir()) == [
        "step_00000004.npz"]


def test_resume_in_one_process_from_the_two_rank_snapshot(ranks, ref_runs):
    """A resume at another data-axis size works: one process (no mesh)
    resumes the snapshot the W = 2 run crashed after and ends where the
    uninterrupted run ends."""
    _, params, log, calls = M.run_case("async_window", _init(ref_runs),
                                       resume_from=str(ranks[0] / "ckpt"))
    got = M.summary(params, log, calls)
    want = _one_process(ref_runs, "async_window")
    _same_logs(got["log"], want["log"])
    for x, y in zip(got["params"], want["params"]):
        assert np.array_equal(x, y)


def test_cohorts_are_partitioned(ranks):
    part = _result(ranks, "partition")
    other = _result(ranks, "partition", 1)
    for tag in ("full", "padded"):
        rep = part[tag]["report"]
        assert "error" not in rep, rep
        assert len(rep) == 12 and set(rep.values()) == {2}
        assert part[tag]["rows"] == 4          # 3 members pad to 4
        for x, y in zip(part[tag]["upload"], other[tag]["upload"]):
            assert np.array_equal(x, y)
    assert "cohort size 3 is not a multiple" in part["host"]["report"][
        "error"]
    assert part["host"]["rows"] == 3


def test_a_spec_mesh_runs_on_the_ranks(ranks):
    """``__mesh__`` decodes to the (2, 1) mesh on the ranks and to (1, 1)
    in one process; both runs end bit for bit equal."""
    from repro_torch.api import ExperimentSpec, Session
    got = _result(ranks, "session")
    assert got["mesh"] == {"data": 2, "model": 1}
    spec = ExperimentSpec.from_dict(M.session_spec_dict())
    assert spec.engine.mesh.shape == {"data": 1, "model": 1}
    params, log = Session("cpu").run(spec)
    want = M.summary(params, log, [])
    _same_logs(got["log"], want["log"], mesh_vs_one=True)
    for x, y in zip(got["params"], want["params"]):
        assert np.array_equal(x, y)
