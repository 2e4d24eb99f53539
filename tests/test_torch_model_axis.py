"""The production round (``core/fl_step.py``) on a mesh whose model axis
is 2, on gloo ranks on the CPU: tensor parallelism for the dense
(smollm-360m) and hybrid (zamba2-1.2b) families, reduced, in f32.

* Two meshes: 2 ranks (data 1 x model 2) and 4 ranks (data 2 x model 2),
  each running two rounds of every case with the JAX package's noise
  injected (``tests/test_torch_spmd.py``'s draws) and the clip binding
  (clip 1, the first microbatch gradient's norm above it).
* The first SGD round at ``server_lr=1`` (master + Delta) within 1e-5 of
  the JAX package's one-device round (``tests/test_torch_train_zoo.py``'s
  harness); each round of every noisy case within 1e-5 of the port's
  one-process (W = 1) round from the same master; ``delta_norm`` within
  1e-5 relative, and it and ``weight_sum`` equal on every rank.
* The ranks of a model group hold bit-identical blocks of the leaves the
  model axis leaves whole; the plain ``ssd_intra_chunk`` receives H / M
  of the hybrid's SSM heads on each rank.
* The gated RMSNorm over a cut d_inner, the vocab-cut embedding, the
  vocab-parallel loss and the Mamba2 mixer (with and without a state),
  values and gradients, against the whole functions.
* At sigma = 0 FedAdam's first step is about +-lr wherever Delta's sign
  is stable; the spread from W = 1 (1.1e-4 on a few entries) is held as
  ``tests/test_torch_fl_step.py`` holds the FedAdam round.
"""
import pathlib
import sys

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
import _torch_mesh_ranks as M  # noqa: E402
import test_torch_train_zoo as Z  # noqa: E402

# name -> (arch, granularity, server_opt, server_lr, sigma)
ROUNDS = {
    "zamba2_micro": ("zamba2-1.2b", "per_microbatch", "sgd", 1.0, 0.5),
    "zamba2_client": ("zamba2-1.2b", "client_level", "sgd", 1.0, 0.5),
    "smollm_micro": ("smollm-360m", "per_microbatch", "sgd", 1.0, 0.5),
    "smollm_client": ("smollm-360m", "client_level", "sgd", 1.0, 0.5),
    "zamba2_adam": ("zamba2-1.2b", "per_microbatch", "adam", 1e-3, 0.5),
    "smollm_adam": ("smollm-360m", "client_level", "adam", 1e-3, 0.5),
    "zamba2_adam_sigma0": ("zamba2-1.2b", "per_microbatch", "adam", 1e-3,
                           0.0),
    "smollm_adam_sigma0": ("smollm-360m", "per_microbatch", "adam", 1e-3,
                           0.0),
}
NOISY = [n for n, r in ROUNDS.items() if r[4] > 0]
SGD = [n for n, r in ROUNDS.items() if r[2] == "sgd"]
SIGMA0 = [n for n, r in ROUNDS.items() if r[4] == 0]
DOTS = ("smollm_micro",)       # run again under set_remat_policy("dots")
MESHES = {2: 1, 4: 2}          # world -> data axis (model axis 2)
TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _noise(arch, granularity):
    """The JAX round's draws (``Z.reference_noise`` of key 1) at every
    (client, leaf) the round reads, as numpy."""
    _, _, r_params, _, _, _ = Z.setup_arch(arch)
    source = Z.reference_noise(jax.random.PRNGKey(1), M.G, 1, r_params)
    shapes = [tuple(l.shape) for l in jax.tree_util.tree_leaves(r_params)]
    out = {f"{c}_{j}": source(c, 0, j, s)
           for c in range(M.G) for j, s in enumerate(shapes)}
    if granularity == "client_level":
        out.update({f"{M.G}_{j}": source(M.G, 0, j, (M.G,) + s)
                    for j, s in enumerate(shapes)})
    return out


@pytest.fixture(scope="module")
def noise():
    draws = {}
    for arch, gran, _, _, _ in ROUNDS.values():
        if (arch, gran) not in draws:
            draws[arch, gran] = _noise(arch, gran)
    return {name: draws[r[0], r[1]] for name, r in ROUNDS.items()}


@pytest.fixture(scope="module")
def ranks(noise, tmp_path_factory):
    return {world: M.spawn("model_axis_ranks",
                           tmp_path_factory.mktemp(f"model_axis_{world}"),
                           world=world, data=data, rounds=ROUNDS, noise=noise,
                           dots=DOTS)
            for world, data in MESHES.items()}


@pytest.fixture(scope="module")
def one(noise):
    """The port's one-process rounds (W = 1, no mesh)."""
    return {name: M.rounds_on(None, a, g, o, lr, noise[name], sigma=s)
            for name, (a, g, o, lr, s) in ROUNDS.items()}


def _result(ranks, world, name, rank=0):
    res = ranks[world][rank][name]
    assert "error" not in res, res["error"]
    return res


@pytest.mark.parametrize("world", list(MESHES))
def test_the_production_families_run_on_a_model_axis(ranks, world):
    """The mesh is data x 2 and ``require_runnable`` passes it; rank r
    sits at (r // 2, r % 2)."""
    for r, res in enumerate(ranks[world]):
        assert res["mesh"] == {"data": MESHES[world], "model": 2}
        assert res["coords"] == (r // 2, r % 2)
        assert res["runnable"] is True, res["runnable"]


@pytest.mark.parametrize("case", ["gated_norm", "embed", "loss", "mamba2",
                                  "mamba2_state"])
@pytest.mark.parametrize("world", list(MESHES))
def test_layers_on_blocks_match_the_whole_functions(ranks, world, case):
    """The gated RMSNorm's mean of squares covers the whole d_inner; the
    vocab-cut embedding and the vocab-parallel cross entropy equal the
    whole ones; the Mamba2 mixer on its blocks equals the whole mixer,
    from no state and from a state whose ssm part holds this rank's
    heads; each one's gradients on this rank's blocks too."""
    for res in ranks[world]:
        layers = res["layers"]
        assert "error" not in layers, layers["error"]
        value, grad = layers[case]
        assert value <= TOL and grad <= TOL, (value, grad)


@pytest.mark.parametrize("name", SGD)
@pytest.mark.parametrize("world", list(MESHES))
def test_first_round_matches_the_reference_round(ranks, world, name):
    """Master + Delta within 1e-5 of the JAX package's single-device round
    from the same params, batch and noise."""
    arch, gran, opt, lr, _ = ROUNDS[name]
    r_master, _, r_met, _, _ = Z.run_both(arch, gran, opt, lr)
    got = _result(ranks, world, name)["rounds"][0]
    r_leaves = jax.tree_util.tree_leaves(r_master)
    assert len(r_leaves) == len(got["master"])
    for a, b in zip(r_leaves, got["master"]):
        np.testing.assert_allclose(b, np.asarray(a), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got["delta_norm"], float(r_met["delta_norm"]),
                               rtol=TOL)


@pytest.mark.parametrize("name", NOISY)
@pytest.mark.parametrize("world", list(MESHES))
def test_rounds_match_the_one_process_rounds(ranks, one, world, name):
    """Each round within 1e-5 of the port's round without a mesh from the
    same master (the FedAdam state updated block by block as the whole
    state would be).  FedAdam's rounds run on from one start; an SGD
    round at ``server_lr=1`` adds its noise (0.35 per entry) to the
    master, whose next gradient then magnifies the first round's ~1e-7
    differences (to 3.1e-5 end to end for zamba2's client-level round),
    so its second round is held from the mesh's own first master."""
    arch, gran, opt, lr, sigma = ROUNDS[name]
    got = _result(ranks, world, name)["rounds"]
    ref = list(one[name]["rounds"])
    if opt == "sgd":
        ref[1] = M.rounds_on(None, arch, gran, opt, lr, _noise(arch, gran),
                             n_rounds=1, sigma=sigma,
                             start=got[0]["master"])["rounds"][0]
    for g, r in zip(got, ref):
        for a, b in zip(r["master"], g["master"]):
            np.testing.assert_allclose(b, a, rtol=0, atol=TOL)
        np.testing.assert_allclose(g["delta_norm"], r["delta_norm"],
                                   rtol=TOL)
        assert g["weight_sum"] == pytest.approx(r["weight_sum"], rel=TOL)


@pytest.mark.parametrize("name", DOTS)
@pytest.mark.parametrize("world", list(MESHES))
def test_dots_policy_recomputes_the_model_axis(ranks, one, world, name):
    """Under ``set_remat_policy("dots")`` the dense layers save their 2-D
    products and recompute the rest, the model axis's ``tp_*``
    collectives included, in the same order on every rank: each round's
    master and metrics are bit-identical to the full policy's on the same
    mesh, on every rank, and within 1e-5 of the one-process round
    (W = 1)."""
    for r in range(world):
        full = _result(ranks, world, name, r)
        dots = _result(ranks, world, f"{name}_dots", r)
        assert dots["dots_units"] > 0
        for a, b in zip(full["rounds"], dots["rounds"]):
            assert a["delta_norm"] == b["delta_norm"]
            assert a["weight_sum"] == b["weight_sum"]
            for x, y in zip(a["master"], b["master"]):
                assert np.array_equal(x, y)
    got = _result(ranks, world, f"{name}_dots")["rounds"][0]
    ref = one[name]["rounds"][0]
    for a, b in zip(ref["master"], got["master"]):
        np.testing.assert_allclose(b, a, rtol=0, atol=TOL)
    np.testing.assert_allclose(got["delta_norm"], ref["delta_norm"],
                               rtol=TOL)


@pytest.mark.parametrize("world", list(MESHES))
def test_metrics_and_masters_equal_on_every_rank(ranks, world):
    for name in ROUNDS:
        first = _result(ranks, world, name)
        for r in range(1, world):
            res = _result(ranks, world, name, r)
            for a, b in zip(first["rounds"], res["rounds"]):
                assert a["delta_norm"] == b["delta_norm"]
                assert a["weight_sum"] == b["weight_sum"] == \
                    pytest.approx(1.0)
                for x, y in zip(a["master"], b["master"]):
                    assert np.array_equal(x, y)


@pytest.mark.parametrize("world", list(MESHES))
def test_model_group_holds_blocks_and_equal_whole_leaves(ranks, world):
    """Each rank holds half of every leaf the model axis cuts, and the
    ranks of one model group hold bit-identical whole leaves."""
    for name in ROUNDS:
        res = [_result(ranks, world, name, r) for r in range(world)]
        dims = res[0]["model_dims"]
        assert sum(d is not None for d in dims) >= 8
        whole = res[0]["rounds"][-1]["master"]
        for lead in range(0, world, 2):
            a, b = res[lead], res[lead + 1]
            for j, d in enumerate(dims):
                if d is None:
                    assert np.array_equal(a["blocks"][j], b["blocks"][j])
                else:
                    assert a["blocks"][j].shape[d] * 2 == whole[j].shape[d]


@pytest.mark.parametrize("world", list(MESHES))
def test_ssd_intra_chunk_gets_each_ranks_heads(ranks, world):
    """The hybrid's Mamba2 layers hand ``ssd_intra_chunk`` H / 2 heads on
    every rank (H / 1 in one process)."""
    for name in ROUNDS:
        if not name.startswith("zamba2"):
            continue
        for r in range(world):
            res = _result(ranks, world, name, r)
            assert res["heads"] == [res["n_ssd_heads"] // 2]


def test_one_process_round_scans_every_head(one):
    res = one["zamba2_micro"]
    assert res["heads"] == [res["n_ssd_heads"]] and res["n_ssd_heads"] > 2


@pytest.mark.parametrize("name", ["zamba2_micro", "smollm_micro"])
def test_the_clip_binds(one, name):
    """The clip (1.0) binds: the first microbatch gradient is longer."""
    assert one[name]["grad0_norm"] > 1.0


@pytest.mark.parametrize("name", SIGMA0)
@pytest.mark.parametrize("world", list(MESHES))
def test_sigma0_adam_rounds(ranks, one, world, name):
    """Without noise FedAdam's first step is about +-lr wherever Delta's
    sign holds, and a ~1e-7 difference may flip a near-zero Delta (the
    measured spread from W = 1 is 1.1e-4 on 14-29 of 1.4-1.7 M entries).
    As ``tests/test_torch_fl_step.py`` holds the FedAdam round: within
    1e-6 on every entry whose one-process Delta (the SGD round at lr 1)
    exceeds 1e-4, at least 99% of them, ``delta_norm`` within 1e-5."""
    arch, gran, _, _, _ = ROUNDS[name]
    sgd = M.rounds_on(None, arch, gran, "sgd", 1.0, {}, n_rounds=1,
                      sigma=0.0)["rounds"][0]["master"]
    _, params, _ = M.setup_arch(arch)
    p0 = M.leaves_np(params)
    got = _result(ranks, world, name)["rounds"][0]
    ref = one[name]["rounds"][0]
    n_stable = kept = 0
    for g, r, d in zip(got["master"], ref["master"],
                       (a - b for a, b in zip(sgd, p0))):
        stable = np.abs(d) > 1e-4
        n_stable += int(stable.sum())
        kept += int((np.abs(g - r)[stable] <= 1e-6).sum())
    assert n_stable > 0 and kept >= 0.99 * n_stable, (kept, n_stable)
    np.testing.assert_allclose(got["delta_norm"], ref["delta_norm"],
                               rtol=TOL)


@pytest.mark.parametrize("name", [n for n in SGD if "client" in n])
@pytest.mark.parametrize("world", list(MESHES))
def test_second_sgd_round_drift_is_the_rounds_conditioning(ranks, one,
                                                           world, name):
    """End to end, the mesh's second SGD round sits no farther from the
    one-process second round than that round itself moves when its
    starting master is perturbed by 6e-8 relative (about one f32 ulp, the
    size of the first round's differences)."""
    arch, gran, opt, lr, sigma = ROUNDS[name]
    got = _result(ranks, world, name)["rounds"]
    ref = one[name]["rounds"]
    rng = np.random.default_rng(0)
    nudged = [x + np.abs(x) * np.float32(6e-8) * rng.choice(
        [-1.0, 1.0], x.shape).astype(np.float32) for x in ref[0]["master"]]
    moved = M.rounds_on(None, arch, gran, opt, lr, _noise(arch, gran),
                        n_rounds=1, sigma=sigma, start=nudged)["rounds"][0]
    drift = max(float(np.abs(a - b).max())
                for a, b in zip(got[1]["master"], ref[1]["master"]))
    sensitivity = max(float(np.abs(a - b).max())
                      for a, b in zip(moved["master"], ref[1]["master"]))
    print(f"{name} W={world}: second-round drift {drift:.3e}, one-process "
          f"sensitivity {sensitivity:.3e}")
    assert drift <= sensitivity
