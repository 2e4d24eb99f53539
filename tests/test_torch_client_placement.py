"""The production round's one-client-per-rank placement (``core/fl_step.py``
with ``role="client_all_axes"`` client shardings: the JAX dry run's
``--client-placement dp``) on gloo ranks on the CPU.

* On (1, 2) and (2, 2) meshes, G = the mesh's ranks: each rank runs one
  client with its model whole (no model group; the layers' mesh context,
  installed as the launcher installs it, is set aside for the local
  phase), gathers the compute-dtype master whole over both axes and leaves
  the weighted delta sum on its master blocks.
* On (1, 2) the new master is bit-identical to the port's one-process
  round of the same G: the two ranks' weighted deltas are added once, as
  the one-process sum adds them.  On (2, 2) the four ranks' deltas are
  added pairwise (over the data group, then the model group) where the
  one process adds them in client order, so the master is held within
  1e-5 of it instead.
* Both within 1e-5 of the JAX package's single-device round from the
  same params, batch and noise (``tests/test_torch_train_zoo.py``'s
  rounds; the reference's Explicit-axis meshes fail on this JAX).
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

# name -> (arch, granularity, server_opt, server_lr)
ROUNDS = {
    "smollm_micro": ("smollm-360m", "per_microbatch", "sgd", 1.0),
    "zamba2_client": ("zamba2-1.2b", "client_level", "sgd", 1.0),
}
MESHES = {"1x2": (1, 2), "2x2": (2, 4)}         # name -> (data, world)
CASES = [(m, n) for m in MESHES for n in ROUNDS]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _noise(arch, granularity, clients):
    """The JAX round's draws for ``clients`` clients at every (client,
    leaf) the round reads, as numpy."""
    _, _, r_params, _, _, _ = Z.setup_arch(arch, clients=clients)
    source = Z.reference_noise(jax.random.PRNGKey(1), clients, 1, r_params)
    shapes = [tuple(l.shape) for l in jax.tree_util.tree_leaves(r_params)]
    out = {f"{c}_{j}": source(c, 0, j, s)
           for c in range(clients) for j, s in enumerate(shapes)}
    if granularity == "client_level":
        for j, s in enumerate(shapes):
            out[f"{clients}_{j}"] = source(clients, 0, j, (clients,) + s)
    return out


@pytest.fixture(scope="module")
def noise():
    return {(mesh, name): _noise(ROUNDS[name][0], ROUNDS[name][1], world)
            for mesh, (_, world) in MESHES.items() for name in ROUNDS}


@pytest.fixture(scope="module")
def ranks(noise, tmp_path_factory):
    return {mesh: M.spawn("placement_ranks",
                          tmp_path_factory.mktemp(f"placement_{mesh}"),
                          world=world, data=data, rounds=ROUNDS,
                          noise={n: noise[mesh, n] for n in ROUNDS})
            for mesh, (data, world) in MESHES.items()}


def _result(ranks, mesh, name, rank=0):
    res = ranks[mesh][rank][name]
    assert "error" not in res, res.get("error")
    return res


@pytest.mark.parametrize("mesh,name", CASES)
def test_each_rank_runs_one_whole_client(ranks, mesh, name):
    """One client per rank, its loss seen with no model group; the master
    blocks cut over the model axis; every rank ends with the same whole
    master and metrics."""
    first = _result(ranks, mesh, name)
    cut = sum(a != b for a, b in zip(first["local_shapes"],
                                     first["whole_shapes"]))
    assert cut > 0
    for r in range(len(ranks[mesh])):
        res = _result(ranks, mesh, name, r)
        assert res["losses"] == M.N_MICRO and res["no_context"]
        for a, b in zip(res["master"], first["master"]):
            assert np.array_equal(a, b)
        assert res["delta_norm"] == first["delta_norm"]
        assert res["weight_sum"] == pytest.approx(1.0)


@pytest.mark.parametrize("mesh,name", CASES)
def test_round_matches_the_one_process_round(ranks, noise, mesh, name):
    """Against the port's round of the same G in one process: bit for bit
    on (1, 2), within 1e-5 on (2, 2) (module docstring)."""
    world = MESHES[mesh][1]
    one = M.placement_round(None, *ROUNDS[name], world, noise[mesh, name])
    got = _result(ranks, mesh, name)
    for a, b in zip(one["master"], got["master"]):
        if mesh == "1x2":
            assert np.array_equal(b, a)
        else:
            np.testing.assert_allclose(b, a, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["delta_norm"], one["delta_norm"],
                               rtol=1e-5)


@pytest.mark.parametrize("mesh,name", CASES)
def test_round_matches_the_reference_round(ranks, mesh, name):
    """Master + Delta within 1e-5 of the JAX package's single-device round
    of the same G from the same params, batch and noise."""
    arch, gran, opt, lr = ROUNDS[name]
    r_master, _, r_met, _, _ = Z.run_both(arch, gran, opt, lr,
                                          clients=MESHES[mesh][1])
    got = _result(ranks, mesh, name)
    r_leaves = jax.tree_util.tree_leaves(r_master)
    assert len(r_leaves) == len(got["master"])
    for a, b in zip(r_leaves, got["master"]):
        np.testing.assert_allclose(b, np.asarray(a), rtol=Z.TOL, atol=Z.TOL)
    np.testing.assert_allclose(got["delta_norm"], float(r_met["delta_norm"]),
                               rtol=1e-5)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_clients_must_fill_every_rank(ranks, mesh):
    """G must be a multiple of all the mesh's ranks, not of the data-axis
    product alone."""
    world = MESHES[mesh][1]
    for res in ranks[mesh]:
        assert res["refusal"] == (
            f"num_clients G={world + 1} is not a multiple of all the "
            f"mesh's ranks {world}: the clients cannot split over it")
