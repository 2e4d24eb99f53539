"""The production meshes' dry run (``repro_torch.launch.dryrun``) and its
sharding rules, on the CPU.

* Specs, on JAX ``AbstractMesh``es of (16, 16), (2, 16, 16), (1, 2) and
  (2, 2) and the port's abstract meshes of the same shapes:
  ``cache_shardings`` equals the JAX package's for all ten configs'
  caches (the JAX side from ``jax.eval_shape(init_cache)``) at
  ``decode_32k`` and ``long_500k`` (B = 1: the rows stay replicated);
  ``tree_shardings`` of the params, roles serve, master and client,
  equals the JAX package's on the 2x16x16 mesh.
* Fixed runs of ``run_one`` (a fake process group of 256 or 512 ranks,
  rank 0's program on ``meta``): every config at ``decode_32k`` on the
  single pod, ``train_4k`` for zamba2-1.2b and olmoe-1b-7b,
  ``prefill_32k`` for zamba2-1.2b and phi-3-vision-4.2b, ``long_500k``
  for xlstm-350m, and on the two pods smollm-360m ``train_4k`` and
  zamba2-1.2b ``decode_32k``: each ends ``"ok"`` with the JSON's fields;
  smollm-360m ``train_4k`` under ``--remat-policy dots`` on the model
  axis (the ``tp`` placement), held to the full policy's run.
* The JSON's ``walk`` (``analysis/hlo.py``): its counts are the
  collectives' and its FLOPs ``cost.flops``; on the single pod, where
  every group has 16 ranks, its link traffic is the JAX package's walk
  of the same collectives.
* Two pinned counts: the reduced configs' one-rank decode step on a fake
  (1, 2) group makes the collectives (calls and bytes) the same step
  makes on 2 real gloo ranks; reduced smollm-360m's step costs the FLOPs
  written out below.
"""
import json
import pathlib
import sys

import jax
import pytest
import torch

import repro.launch.shardings as r_sh
from repro.configs import ARCH_IDS
from repro.configs import get_config as r_get_config
from repro.models.base import INPUT_SHAPES as R_SHAPES
from repro.models.base import get_family as r_get_family

from repro_torch.configs import get_config as t_get_config
from repro_torch.launch import dryrun
from repro_torch.launch import shardings as t_sh
from repro_torch.launch.mesh import HostMesh, make_host_mesh
from repro_torch.models.base import get_family as t_get_family
from repro_torch.pytree import tree_leaves, tree_map

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
import _torch_mesh_ranks as M  # noqa: E402
import _torch_ref_hlo as H  # noqa: E402

MESHES = {"16x16": (None, 16, 16), "2x16x16": (2, 16, 16),
          "1x2": (None, 1, 2), "2x2": (None, 2, 2)}


def _amesh(pod, data, model):
    sizes = (data, model) if pod is None else (pod, data, model)
    names = ("data", "model") if pod is None else ("pod", "data", "model")
    try:
        return jax.sharding.AbstractMesh(sizes, names)
    except TypeError:
        return jax.sharding.AbstractMesh(tuple(zip(names, sizes)))


def _tmesh(pod, data, model):
    return HostMesh.abstract(data, model, pod=pod)


def _specs_r(tree):
    return [tuple(ns.spec) for ns in jax.tree_util.tree_leaves(tree)]


def _specs_t(tree):
    return [ns.spec for ns in tree_leaves(tree)]


@pytest.mark.parametrize("shape_name", ["decode_32k", "long_500k"])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_shardings_equal_the_reference(arch, mesh, shape_name):
    long = shape_name == "long_500k"
    shape = R_SHAPES[shape_name]
    B, S = shape.global_batch, shape.seq_len
    r_cfg = r_get_config(arch, long_variant=long)
    t_cfg = t_get_config(arch, long_variant=long)
    r_cache = jax.eval_shape(
        lambda: r_get_family(r_cfg.family).init_cache(r_cfg, B, S))
    t_cache = t_get_family(t_cfg.family).init_cache(t_cfg, B, S,
                                                    device="meta")
    assert [tuple(l.shape) for l in jax.tree_util.tree_leaves(r_cache)] == \
        [tuple(l.shape) for l in tree_leaves(t_cache)]
    want = _specs_r(r_sh.cache_shardings(r_cache, r_cfg,
                                         _amesh(*MESHES[mesh]), B))
    got = _specs_t(t_sh.cache_shardings(t_cache, t_cfg,
                                        _tmesh(*MESHES[mesh]), B))
    assert got == want
    pod, data, _ = MESHES[mesh]
    if B == 1 and data * (pod or 1) > 1:      # rows replicated over data
        assert not any("data" in str(s) for s in got)


@pytest.mark.parametrize("role", ["serve", "master", "client"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_shardings_equal_the_reference_on_two_pods(arch, role):
    r_cfg, t_cfg = r_get_config(arch), t_get_config(arch)
    r_tree = jax.eval_shape(lambda: r_get_family(r_cfg.family).init_params(
        jax.random.PRNGKey(0), r_cfg))
    t_tree = t_get_family(t_cfg.family).init_params(t_cfg, 0, device="meta")
    amesh, tmesh = _amesh(2, 16, 16), _tmesh(2, 16, 16)
    if role == "client":
        r_tree = jax.tree_util.tree_map(
            lambda l: jax.ShapeDtypeStruct((32,) + l.shape, l.dtype), r_tree)
        t_tree = tree_map(lambda l: torch.empty(
            (32,) + tuple(l.shape), device="meta"), t_tree)
    want = _specs_r(r_sh.tree_shardings(r_tree, r_cfg, amesh, role))
    got = _specs_t(t_sh.tree_shardings(t_tree, t_cfg, tmesh, role))
    assert got == want


RUNS = ([(arch, "decode_32k", "single") for arch in ARCH_IDS]
        + [("zamba2-1.2b", "train_4k", "single"),
           ("olmoe-1b-7b", "train_4k", "single"),
           ("zamba2-1.2b", "prefill_32k", "single"),
           ("phi-3-vision-4.2b", "prefill_32k", "single"),
           ("xlstm-350m", "long_500k", "single"),
           ("smollm-360m", "train_4k", "multipod"),
           ("zamba2-1.2b", "decode_32k", "multipod")])


_RESULTS = {}


def _run_one(arch, shape, mesh):
    """``run_one``, once per combination in this process."""
    key = (arch, shape, mesh)
    if key not in _RESULTS:
        _RESULTS[key] = dryrun.run_one(arch, shape, mesh)
    return _RESULTS[key]


@pytest.mark.parametrize("arch,shape,mesh", RUNS,
                         ids=["-".join(r) for r in RUNS])
def test_run_one_is_ok(arch, shape, mesh):
    res = _run_one(arch, shape, mesh)
    assert res["status"] == "ok", res.get("error")
    assert res["mesh_shape"] == ({"data": 16, "model": 16} if mesh ==
                                 "single" else
                                 {"pod": 2, "data": 16, "model": 16})
    mem = res["memory"]
    for k in ("argument_size_bytes", "output_size_bytes", "temp_size_bytes"):
        assert isinstance(mem[k], int) and mem[k] > 0, k
    assert res["cost"]["flops"] > 0
    coll = res["collectives"]
    assert set(coll) == {"bytes", "counts"}
    assert coll["counts"]["all-gather"] > 0 and coll["bytes"]["all-gather"] > 0
    walk = res["walk"]
    assert walk["collective_counts"] == coll["counts"]
    assert walk["dot_flops"] == res["cost"]["flops"]
    assert set(walk["collective_traffic_bytes"]) == set(coll["bytes"])
    assert walk["total_collective_bytes"] > 0
    assert walk["hbm_bytes"] is None and res["hlo_ops"] is None
    assert set(res["not_ported"]) == {"walk.hbm_bytes", "hlo_ops"}
    if shape == "train_4k":
        assert coll["counts"]["reduce-scatter"] == 1


@pytest.mark.parametrize("arch,shape", [("zamba2-1.2b", "decode_32k"),
                                        ("zamba2-1.2b", "train_4k")])
def test_walk_traffic_follows_the_ring_multipliers(arch, shape):
    """On the single pod's fake group every collective runs over a group
    of 16 ranks (a data or a model axis of 16): the walk's per-kind link
    traffic is the JAX package's walk (``repro.analysis.hlo.analyze``) of
    an HLO module moving the same input bytes per kind over
    ``replica_groups=[1,16]`` (``tests/_torch_ref_hlo.py``)."""
    res = _run_one(arch, shape, "single")
    assert res["status"] == "ok", res.get("error")
    got = res["walk"]["collective_traffic_bytes"]
    nbytes = res["collectives"]["bytes"]
    assert got and set(got) == set(nbytes)
    ref = H.reference_walk(sorted(nbytes.items()), g=16)
    assert set(ref["collective_traffic_bytes"]) == set(got)
    for kind, t in ref["collective_traffic_bytes"].items():
        assert got[kind] == pytest.approx(t, rel=1e-12), kind
    assert res["walk"]["total_collective_bytes"] == pytest.approx(
        ref["total_collective_bytes"], rel=1e-12)


def test_dots_policy_runs_on_the_model_axis():
    """``--remat-policy dots`` with the default ``tp`` placement (the
    reference's main use of the policy): smollm-360m x train_4k on the
    single pod, the fake group's collectives recomputed inside the
    selective checkpoint.  Against the full policy: the same collectives
    (every unit's collectives run again under both), fewer FLOPs (the
    saved 2-D products are not run again) and a temp peak no smaller
    (those products are held)."""
    full, dots = (dryrun.run_one("smollm-360m", "train_4k", "single",
                                 remat_policy=p) for p in ("", "dots"))
    for res in (full, dots):
        assert res["status"] == "ok", res.get("error")
        assert res["client_placement"] == "tp"
    assert (full["remat_policy"], dots["remat_policy"]) == (None, "dots")
    assert dots["collectives"] == full["collectives"]
    assert dots["collectives"]["counts"]["all-reduce"] > 0
    assert dots["cost"]["flops"] < full["cost"]["flops"]
    assert (dots["memory"]["temp_size_bytes"]
            >= full["memory"]["temp_size_bytes"])


def test_main_writes_the_reference_naming(tmp_path, monkeypatch, capsys):
    """The CLI writes ``<arch>__<shape>__<mesh>.json``; ``--resume`` skips
    an ok result; ``--no-batch-constraints`` and ``--expert-pad`` are
    taken."""
    monkeypatch.setattr(dryrun, "RESULTS_DIR", str(tmp_path))
    argv = ["--arch", "xlstm-350m", "--shape", "long_500k", "--mesh",
            "single", "--no-batch-constraints", "--expert-pad", "4"]
    assert dryrun.main(argv) == 0
    with open(tmp_path / "xlstm-350m__long_500k__single.json") as f:
        assert json.load(f)["status"] == "ok"
    assert dryrun.main(argv + ["--resume"]) == 0
    assert "skip (done)" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# the pinned counts
# ---------------------------------------------------------------------------

STEP_CASES = {"smollm": ("smollm-360m", None),
              "smollm_kv5": ("smollm-360m", {"n_heads": 5, "n_kv_heads": 5,
                                             "d_head": 64}),
              "zamba2": ("zamba2-1.2b", None),
              "olmoe": ("olmoe-1b-7b", None)}


@pytest.fixture(scope="module")
def gloo_steps(tmp_path_factory):
    return M.spawn("serve_step_ranks", tmp_path_factory.mktemp("steps"),
                   world=2, data=1, cases=STEP_CASES)


@pytest.fixture(scope="module")
def fake_steps():
    with dryrun.fake_group(2, 0):
        mesh = make_host_mesh(data=1, model=2)
        return {name: M.serve_step(mesh, M.serve_config(arch, ov), "meta")
                for name, (arch, ov) in STEP_CASES.items()}


@pytest.mark.parametrize("name", list(STEP_CASES))
def test_fake_group_counts_the_collectives_of_real_ranks(gloo_steps,
                                                         fake_steps, name):
    for res in gloo_steps:
        assert "error" not in res[name], res[name].get("error")
        assert res[name]["collectives"] == fake_steps[name]["collectives"]
        assert res[name]["flops"] == fake_steps[name]["flops"]


def test_decode_step_flops_are_the_products_written_out(fake_steps):
    """Reduced smollm-360m (D 256, 4 heads and 4 kv heads of 64, d_ff 512,
    vocab 512 tied, 2 layers), one decode step of B = 4 rows over a cache
    of 24 positions, on rank 0 of a model axis of 2: wq/wk/wv and wo are
    cut on head_dim, w_gate/w_up on d_ff's columns and w_down on its
    rows, the embedding on the vocab; ``flash_decode`` runs on 2 of the 4
    kv heads."""
    B, D, Dh, F, V, L, S = 4, 256, 64, 512, 512, 2, 24
    qkv = 3 * 2 * B * D * (4 * Dh // 2)
    attn = 2 * (2 * B * 2 * Dh * S)          # q.K and p.V on 2 heads
    wo = 2 * B * (4 * Dh // 2) * D
    mlp = 2 * (2 * B * D * F // 2) + 2 * B * (F // 2) * D
    unembed = 2 * B * D * (V // 2)
    assert fake_steps["smollm"]["flops"] == L * (qkv + attn + wo + mlp) \
        + unembed == 5865472
