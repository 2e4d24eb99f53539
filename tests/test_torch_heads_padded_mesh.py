"""Padded uneven heads on the model axis (``attn_shard="heads_padded"``):
the production round and serving on gloo ranks on the CPU, reduced, in
f32.

* Three meshes: (1, 2), (2, 2) and (1, 4), each rank running every case
  once (``tests/_torch_mesh_ranks.py::heads_padded_ranks``).
* smollm-360m with 15 query and 5 kv heads (the full width's counts) on
  every mesh: on a model axis of 2 the heads pad (15 -> 16, 5 -> 6) and
  rank 1's query heads 8-14 read kv head 2, which rank 0 holds; on 4,
  rank 3 holds no real kv head.  Its first SGD round (``server_lr=1``)
  is within 1e-5 of the JAX package's one-device round
  (``tests/test_torch_train_zoo.py``'s harness, its noise injected); two
  FedAdam rounds are within 1e-5 of the port's one-process rounds.
* zamba2-1.2b's shared attention (4 heads on 2 ranks: they divide),
  Whisper with 5 heads (its cross-attention; on (1, 4) rank 3 holds
  padding only) and olmoe-1b-7b (its experts cut on the expert dim) on
  (1, 2), held to the one-process rounds.
* After each round the padded slots of every rank's master blocks, its
  update and its optimizer state are exactly zero; the attention
  all-gathers k/v only where a GQA group or the kv padding crosses
  ranks.
* Serving smollm-360m at 15/5 on model axes of 2 and 4: prefill and
  decode logits within 1e-5 of the one-process run and of the JAX
  package's, greedy tokens equal, and the plain ``flash_decode``
  receives whole GQA groups (its query heads a multiple of its kv
  heads, three per kv head).
"""
import pathlib
import sys
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as r_get_config
from repro.models.base import get_family as r_get_family

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
import _torch_mesh_ranks as M  # noqa: E402
import test_torch_train_zoo as Z  # noqa: E402

HEADS = {"n_heads": 15, "n_kv_heads": 5}
# name -> (arch, granularity, server_opt, server_lr, overrides)
ROUNDS = {
    "smollm_sgd": ("smollm-360m", "per_microbatch", "sgd", 1.0, HEADS),
    "smollm_adam": ("smollm-360m", "client_level", "adam", 1e-3, HEADS),
}
ROUNDS_12 = {
    "zamba2_adam": ("zamba2-1.2b", "per_microbatch", "adam", 1e-3, None),
    "whisper_adam": ("whisper-large-v3", "per_microbatch", "adam", 1e-3,
                     {"n_heads": 5, "n_kv_heads": 5}),
    "olmoe_adam": ("olmoe-1b-7b", "per_microbatch", "adam", 1e-3, None),
}
ROUNDS_14 = {"whisper_adam": ROUNDS_12["whisper_adam"]}
SERVE = {"smollm_serve": ("smollm-360m", HEADS)}
# world, data -> the cases the mesh runs
MESHES = {(2, 1): {**ROUNDS, **ROUNDS_12}, (4, 2): ROUNDS,
          (4, 1): {**ROUNDS, **ROUNDS_14}}
ALL = {**ROUNDS, **ROUNDS_12}
TOL = 1e-5
STEPS = ["prefill"] + [f"decode{t}" for t in range(M.SERVE_STEPS)]


@pytest.fixture(scope="module")
def noise():
    out = {}
    for name, (arch, gran, _, _, ov) in ALL.items():
        _, _, r_params, _, _, _ = Z.setup_arch(arch, overrides=ov)
        src = Z.reference_noise(jax.random.PRNGKey(1), M.G, 1, r_params)
        shapes = [tuple(l.shape) for l in jax.tree_util.tree_leaves(r_params)]
        draws = {f"{c}_{j}": src(c, 0, j, s)
                 for c in range(M.G) for j, s in enumerate(shapes)}
        if gran == "client_level":
            draws.update({f"{M.G}_{j}": src(M.G, 0, j, (M.G,) + s)
                          for j, s in enumerate(shapes)})
        out[name] = draws
    return out


def _jax_serve(arch, ov, params_np, batch_np, steps_np):
    cfg = r_get_config(arch).reduced().replace(param_dtype="float32",
                                               **(ov or {}))
    fam = r_get_family(cfg.family)
    rp = jax.tree_util.tree_map(jnp.asarray, params_np)
    B, S = M.SERVE_B, M.SERVE_S
    cache = fam.init_cache(cfg, B, S + steps_np.shape[1])
    lg, cache = jax.jit(fam.prefill, static_argnums=2)(
        rp, {k: jnp.asarray(v) for k, v in batch_np.items()}, cfg, cache)
    out = {"prefill": np.asarray(lg)}
    decode = jax.jit(fam.decode_step, static_argnums=4)
    for t in range(steps_np.shape[1]):
        lg, cache = decode(rp, cache, jnp.asarray(steps_np[:, t:t + 1]),
                           jnp.full((B,), S + t, jnp.int32), cfg)
        out[f"decode{t}"] = np.asarray(lg)
    return out


@pytest.fixture(scope="module")
def runs(noise, tmp_path_factory):
    """The three meshes' ranks (spawned side by side) while this process
    runs the port's one-process rounds and serving and the JAX package's
    serving."""
    params, inputs = {}, {}
    for name, (arch, ov) in SERVE.items():
        cfg = r_get_config(arch).reduced().replace(param_dtype="float32",
                                                   **ov)
        rp = r_get_family(cfg.family).init_params(jax.random.PRNGKey(0), cfg)
        params[name] = jax.tree_util.tree_map(np.asarray, rp)
        inputs[name] = M.serve_inputs(M.serve_config(arch, ov))
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with ThreadPoolExecutor(len(MESHES)) as pool:
            spawned = {key: pool.submit(
                M.spawn, "heads_padded_ranks",
                tmp_path_factory.mktemp(f"heads_padded_{key[0]}_{key[1]}"),
                world=key[0], data=key[1], rounds=cases,
                noise={n: noise[n] for n in cases},
                serve_cases=SERVE if key[1] == 1 else {}, params=params,
                inputs=inputs) for key, cases in MESHES.items()}
            one = {name: M.rounds_on(None, a, g, o, lr, noise[name],
                                     overrides=ov)
                   for name, (a, g, o, lr, ov) in ALL.items()}
            one_serve = {name: M.serve_on(None, M.serve_config(a, ov),
                                          params[name], *inputs[name])
                         for name, (a, ov) in SERVE.items()}
            ref_serve = {name: _jax_serve(a, ov, params[name],
                                          *inputs[name])
                         for name, (a, ov) in SERVE.items()}
            ranks = {key: f.result() for key, f in spawned.items()}
    finally:
        torch.set_num_threads(old)
    return {"ranks": ranks, "one": one, "one_serve": one_serve,
            "ref_serve": ref_serve}


RUNS = [(key, name) for key, cases in MESHES.items() for name in cases]
IDS = [f"{name}-{key[1]}x{key[0] // key[1]}" for key, name in RUNS]


def _got(runs, key, name):
    out = []
    for res in runs["ranks"][key]:
        got = res[name]
        assert "error" not in got, got["error"]
        out.append((res["coords"], got))
    return out


@pytest.mark.parametrize("key", list(MESHES), ids=lambda k: f"{k[1]}x"
                         f"{k[0] // k[1]}")
def test_smollm_first_round_matches_the_reference_round(runs, key):
    """Master + Delta within 1e-5 of the JAX package's single-device round
    from the same params, batch and noise, on every rank."""
    arch, gran, opt, lr, ov = ROUNDS["smollm_sgd"]
    r_master, _, r_met, _, _ = Z.run_both(arch, gran, opt, lr, overrides=ov)
    r_leaves = jax.tree_util.tree_leaves(r_master)
    for _, got in _got(runs, key, "smollm_sgd"):
        first = got["rounds"][0]
        assert len(r_leaves) == len(first["master"])
        for a, b in zip(r_leaves, first["master"]):
            np.testing.assert_allclose(b, np.asarray(a), rtol=TOL, atol=TOL)
        np.testing.assert_allclose(first["delta_norm"],
                                   float(r_met["delta_norm"]), rtol=TOL)


@pytest.mark.parametrize("key,name", RUNS, ids=IDS)
def test_rounds_match_the_one_process_rounds(runs, key, name):
    """Each FedAdam round (an SGD round at ``server_lr=1``: its first,
    tests/test_torch_model_axis.py says why) within 1e-5 of the port's
    one-process round, ``delta_norm`` and ``weight_sum`` too, on every
    rank."""
    ref = runs["one"][name]["rounds"]
    n = 1 if ALL[name][2] == "sgd" else len(ref)
    for _, got in _got(runs, key, name):
        for g, r in zip(got["rounds"][:n], ref[:n]):
            for a, b in zip(r["master"], g["master"]):
                np.testing.assert_allclose(b, a, rtol=0, atol=TOL)
            np.testing.assert_allclose(g["delta_norm"], r["delta_norm"],
                                       rtol=TOL)
            assert g["weight_sum"] == pytest.approx(r["weight_sum"], rel=TOL)


@pytest.mark.parametrize("key,name", RUNS, ids=IDS)
def test_padded_slots_stay_zero(runs, key, name):
    """After each of two rounds every rank's padded slots of its master
    blocks, its update and its optimizer state are exactly zero; the
    blocks are GSPMD's padded ones (``ceil(n / M)`` slots)."""
    model = key[0] // key[1]
    arch, _, _, _, ov = ALL[name]
    cfg = M.serve_config(arch, ov)
    for _, got in _got(runs, key, name):
        for r in got["rounds"]:
            assert (r["pad_master"], r["pad_update"], r["pad_opt"]) == (
                0.0, 0.0, 0.0)
        one = runs["one"][name]["rounds"][0]["master"]
        for whole, shape, d in zip(one, got["local_shapes"],
                                   got["model_dims"]):
            if d is not None:
                assert shape[d] == -(-whole.shape[d] // model)
    if cfg.n_heads % model:
        assert any(d is not None and whole.shape[d] == cfg.n_heads
                   for whole, d in zip(one, got["model_dims"]))


@pytest.mark.parametrize("key,name", RUNS, ids=IDS)
def test_attention_gathers_only_across_ranks(runs, key, name):
    """The attention all-gathers its k/v (``_head_projs``) exactly where a
    rank's query heads read a kv head another rank holds: smollm's 15/5
    on every mesh; not zamba2's 4 heads on 2 ranks, Whisper's 5/5 or
    olmoe's 4/4."""
    from repro_torch.models.layers import straddles
    arch, _, _, _, ov = ALL[name]
    cfg = M.serve_config(arch, ov)
    model = key[0] // key[1]
    crossing = straddles(cfg.n_heads, cfg.n_kv_heads, model)
    assert crossing == (arch == "smollm-360m")
    for _, got in _got(runs, key, name):
        assert ("_head_projs" in got["callers"]) == crossing


SERVE_KEYS = [key for key in MESHES if key[1] == 1]


@pytest.mark.parametrize("key", SERVE_KEYS, ids=lambda k: f"1x{k[0]}")
def test_serve_matches_one_process_and_jax(runs, key):
    """Prefill and every decode step's logits within 1e-5 of the port's
    one-process run and of the JAX package's, greedy tokens equal."""
    one, ref = runs["one_serve"]["smollm_serve"], runs["ref_serve"][
        "smollm_serve"]
    for _, got in _got(runs, key, "smollm_serve"):
        for k in STEPS:
            np.testing.assert_allclose(got[k], one[k], rtol=0, atol=TOL)
            np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=TOL)
            assert np.array_equal(got[k].argmax(-1), one[k].argmax(-1))
            assert np.array_equal(got[k].argmax(-1), ref[k].argmax(-1))


@pytest.mark.parametrize("key", SERVE_KEYS, ids=lambda k: f"1x{k[0]}")
def test_flash_decode_takes_whole_gqa_groups(runs, key):
    """Each rank's plain ``flash_decode`` gets the whole GQA groups of the
    kv heads its real query heads read: 15/5 on 2 ranks is 9/3 on both
    (query heads 0-7 and 8-14, zero-filled to kv heads 0-2 and 2-4); on 4
    ranks 6/2, 6/2, 6/2 and 3/1.  One launch per layer per step."""
    want = {2: [(9, 3, 64)] * 2, 4: [(6, 2, 64)] * 3 + [(3, 1, 64)]}
    model = key[0]
    got = [g for _, g in sorted(_got(runs, key, "smollm_serve"),
                                key=lambda cg: cg[0][1])]
    assert [tuple(g["flash_calls"][0]) for g in got] == want[model]
    for g in got:
        assert len(g["flash_calls"]) == 1
        q, kv, _ = g["flash_calls"][0]
        assert q == 3 * kv
        assert g["n_flash"] == 2 * M.SERVE_STEPS
