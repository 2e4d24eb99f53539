"""The production round (``core/fl_step.py``) and ``launch/train.py
spmd`` on a two-rank gloo mesh on the CPU.

* ``fl_train_step`` on the reduced zamba2 (hybrid) and smollm (dense)
  configs at W = 2: each rank runs one of the G = 2 clients, the f32
  master is ZeRO-sharded by ``leaf_spec(role="master")`` (the round
  all-gathers it, reduce-scatters the weighted delta sum onto its shards
  and updates each shard), the JAX package's own noise injected.  With
  SGD at ``server_lr=1`` the new master is master + Delta, held within
  1e-5 of the JAX package's single-device round
  (``tests/test_torch_train_zoo.py``'s rounds), per-microbatch and
  client-level, ``delta_norm`` within 1e-5; FedAdam on the sharded
  optimizer state within 1e-6 of the port's one-process round.
* ``spmd --devices 2 --data-axis 2`` end to end on a ``--reduce``d
  smollm: the launcher spawns its two ranks, rank 0 prints the
  reference's lines and writes the checkpoint, which equals the
  one-process run's (``--devices 1``) within 1e-5.
"""
import pathlib
import sys

import jax
import numpy as np
import pytest
import torch

from repro_torch.launch import train

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
import _torch_mesh_ranks as M  # noqa: E402
import test_torch_train_zoo as Z  # noqa: E402

# name -> (arch, granularity, server_opt, server_lr)
ROUNDS = {
    "zamba2_micro": ("zamba2-1.2b", "per_microbatch", "sgd", 1.0),
    "zamba2_client": ("zamba2-1.2b", "client_level", "sgd", 1.0),
    "smollm_micro": ("smollm-360m", "per_microbatch", "sgd", 1.0),
    "smollm_client": ("smollm-360m", "client_level", "sgd", 1.0),
    "zamba2_adam": ("zamba2-1.2b", "client_level", "adam", 1e-3),
    "smollm_adam": ("smollm-360m", "per_microbatch", "adam", 1e-3),
}
SGD = [n for n, r in ROUNDS.items() if r[2] == "sgd"]
# the launcher's ranks compute with PyTorch's default thread count; the
# one-process run it is compared with must too (a different count sums
# in another order, which FedAdam's first step can turn into +-lr)
DEFAULT_THREADS = torch.get_num_threads()


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _noise(arch, granularity):
    """The JAX round's draws (``Z.reference_noise`` of key 1) at every
    (client, leaf) the round reads, as numpy."""
    _, _, r_params, t_params, _, _ = Z.setup_arch(arch)
    source = Z.reference_noise(jax.random.PRNGKey(1), M.G, 1, r_params)
    shapes = [tuple(l.shape) for l in jax.tree_util.tree_leaves(r_params)]
    out = {}
    for c in range(M.G):
        for j, s in enumerate(shapes):
            out[f"{c}_{j}"] = source(c, 0, j, s)
    if granularity == "client_level":
        for j, s in enumerate(shapes):
            out[f"{M.G}_{j}"] = source(M.G, 0, j, (M.G,) + s)
    return out


@pytest.fixture(scope="module")
def noise():
    draws = {}
    for arch, gran, _, _ in ROUNDS.values():
        if (arch, gran) not in draws:
            draws[arch, gran] = _noise(arch, gran)
    return {name: draws[arch, gran]
            for name, (arch, gran, _, _) in ROUNDS.items()}


@pytest.fixture(scope="module")
def ranks(noise, tmp_path_factory):
    return M.spawn("spmd_ranks", tmp_path_factory.mktemp("spmd_ranks"),
                   rounds=ROUNDS, noise=noise)


def _result(ranks, name, rank=0):
    res = ranks[rank][name]
    assert "error" not in res, res.get("error")
    return res


@pytest.mark.parametrize("name", list(ROUNDS))
def test_master_is_sharded_and_ranks_agree(ranks, name):
    """The master's d_model leaves were split over the two ranks (each
    held half of them), and both ranks end with the same whole master and
    metrics."""
    a, b = _result(ranks, name, 0), _result(ranks, name, 1)
    assert a["split"] > 0
    halved = sum(la != tuple(w.shape) for la, w in zip(a["local_shapes"],
                                                      a["master"]))
    assert halved == a["split"]
    for x, y in zip(a["master"], b["master"]):
        assert np.array_equal(x, y)
    assert a["delta_norm"] == b["delta_norm"]
    assert a["weight_sum"] == b["weight_sum"] == pytest.approx(1.0)


@pytest.mark.parametrize("name", SGD)
def test_round_matches_the_reference_round(ranks, name):
    """Master + Delta within 1e-5 of the JAX package's single-device round
    from the same params, batch and noise."""
    arch, gran, opt, lr = ROUNDS[name]
    r_master, _, r_met, _, _ = Z.run_both(arch, gran, opt, lr)
    got = _result(ranks, name)
    r_leaves = jax.tree_util.tree_leaves(r_master)
    assert len(r_leaves) == len(got["master"])
    for a, b in zip(r_leaves, got["master"]):
        np.testing.assert_allclose(b, np.asarray(a), rtol=Z.TOL, atol=Z.TOL)
    np.testing.assert_allclose(got["delta_norm"], float(r_met["delta_norm"]),
                               rtol=1e-5)


@pytest.mark.parametrize("name", list(ROUNDS))
def test_round_matches_the_one_process_round(ranks, noise, name):
    """Against the port's round without a mesh, same noise: the sharded
    FedAdam state updates its shards as the whole state would."""
    one = M.round_on(None, *ROUNDS[name], noise[name])
    got = _result(ranks, name)
    for a, b in zip(one["master"], got["master"]):
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got["delta_norm"], one["delta_norm"],
                               rtol=1e-5)


SPMD = ["spmd", "--device", "cpu", "--arch", "smollm-360m", "--steps", "2",
        "--log-every", "1", "--seq", "32", "--data-axis", "2",
        "--n-micro", "2", "--per-micro", "1",
        "--reduce", "d_model=64,n_layers=2,vocab=256"]


def test_spmd_two_ranks_end_to_end(tmp_path, capfd):
    """``spmd --devices 2 --data-axis 2``: rank 0's lines are the
    reference's (plus the mesh line) and its checkpoint equals the
    one-process run's within 1e-5."""
    from repro_torch.checkpoint import checkpoint as ckpt
    assert train.main(SPMD + ["--devices", "2",
                              "--ckpt-dir", str(tmp_path / "two")]) == 0
    lines = [ln for ln in capfd.readouterr().out.splitlines()
             if ln.startswith("[train:spmd]")]
    assert lines[0].startswith("[train:spmd] mesh {'data': 2, 'model': 1} "
                               "over 2 ranks: backend gloo")
    assert [ln.split()[1] for ln in lines[1:]] == [
        "round", "round", "final", "checkpoint"]
    torch.set_num_threads(DEFAULT_THREADS)
    try:
        train.main(SPMD + ["--ckpt-dir", str(tmp_path / "one")])
    finally:
        torch.set_num_threads(1)
    two, meta2 = ckpt.load_flat(str(tmp_path / "two"))
    one, meta1 = ckpt.load_flat(str(tmp_path / "one"))
    assert sorted(two) == sorted(one) and len(one) > 5
    for k in one:
        np.testing.assert_allclose(two[k], one[k], rtol=0, atol=1e-5)
    assert meta2["loss"] == pytest.approx(meta1["loss"], abs=1e-5)
