"""Serving on the mesh's model axis (``repro_torch.launch.serve``), on gloo
ranks on the CPU, for every family of the zoo, reduced, in f32.

* Two meshes: 2 ranks (data 1 x model 2) and 4 ranks (data 2 x model 2:
  the batch's 4 rows split 2 per data coordinate), each rank running
  every case (``tests/_torch_mesh_ranks.py::serve_mesh_ranks``): the
  params' blocks of the serve role, the cache's blocks of the served
  placement, a prefill of 16 tokens and 4 teacher-forced decode steps.
* Each step's logits within 1e-5 of the port's one-process (W = 1) run
  and within 1e-4 of the JAX package's ``prefill`` / ``decode_step``
  (``tests/test_torch_zoo.py``'s tolerance), from the same params; the
  greedy tokens equal both.
* Each rank's cache leaves, after the prefill and after the last step,
  are the placement's blocks of W = 1's cache (shapes exactly, values
  within 1e-5), and hold 1/M of each leaf's bytes on a model axis of M
  (the sLSTM's small state, whole on every rank, aside), 1/data of its
  rows where the rows split.
* ``flash_decode`` (its plain version here) runs on this rank's kv heads
  and their query heads where the model axis divides the kv heads, and
  on all heads of the layer's gathered K/V where it does not: the
  ``smollm_kv5`` case (5 kv heads on 2 ranks) takes that branch.
  ``xlstm_h1`` (one mLSTM head) runs the mLSTM whole with its state cut
  on the key dim; ``olmoe`` (capacity 0.5) drops tokens in a routing
  group that spans the split rows.
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

from repro_torch.launch import serve
from repro_torch.launch.mesh import HostMesh
from repro_torch.launch.shardings import block
from repro_torch.pytree import tree_flatten_with_path, tree_leaves

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
import _torch_mesh_ranks as M  # noqa: E402

# name -> (arch, overrides of the reduced config)
CASES = {
    "zamba2": ("zamba2-1.2b", None),
    "smollm": ("smollm-360m", None),
    "smollm_kv5": ("smollm-360m", {"n_heads": 5, "n_kv_heads": 5,
                                   "d_head": 64}),
    "gemma2": ("gemma2-2b", {"sliding_window": 12}),
    "llama": ("llama3.2-3b", None),
    "deepseek": ("deepseek-coder-33b", None),
    "phi3": ("phi-3-vision-4.2b", None),
    "olmoe": ("olmoe-1b-7b", {"capacity_factor": 0.5}),
    "qwen2_moe": ("qwen2-moe-a2.7b", None),
    "whisper": ("whisper-large-v3", None),
    "xlstm": ("xlstm-350m", None),
    "xlstm_h1": ("xlstm-350m", {"n_heads": 1, "n_kv_heads": 1}),
}
MESHES = {2: 1, 4: 2}          # world -> data axis (model axis 2)
MODEL = 2
TOL_ONE = 1e-5
TOL_JAX = 1e-4
STEP_KEYS = ["prefill"] + [f"decode{t}" for t in range(M.SERVE_STEPS)]
RUNS = [(name, world) for name in CASES for world in MESHES]
IDS = [f"{name}-w{world}" for name, world in RUNS]


def _jax_run(name, params_np, batch_np, steps_np):
    """The JAX package's prefill and decode steps of the case."""
    arch, ov = CASES[name]
    cfg = r_get_config(arch).reduced().replace(param_dtype="float32",
                                               **(ov or {}))
    fam = r_get_family(cfg.family)
    rp = jax.tree_util.tree_map(jnp.asarray, params_np)
    B, S = M.SERVE_B, M.SERVE_S
    off = cfg.n_patches if cfg.family == "vlm" else 0
    cache = fam.init_cache(cfg, B, S + steps_np.shape[1])
    lg, cache = jax.jit(fam.prefill, static_argnums=2)(
        rp, {k: jnp.asarray(v) for k, v in batch_np.items()}, cfg, cache)
    out = {"prefill": np.asarray(lg)}
    decode = jax.jit(fam.decode_step, static_argnums=4)
    for t in range(steps_np.shape[1]):
        lg, cache = decode(rp, cache, jnp.asarray(steps_np[:, t:t + 1]),
                           jnp.full((B,), off + S + t, jnp.int32), cfg)
        out[f"decode{t}"] = np.asarray(lg)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX-initialised params of every case, then both meshes' ranks
    (spawned side by side, in the background) while this process runs
    the port's one-process runs and the JAX package's."""
    params, inputs = {}, {}
    for name, (arch, ov) in CASES.items():
        cfg = r_get_config(arch).reduced().replace(param_dtype="float32",
                                                   **(ov or {}))
        rp = r_get_family(cfg.family).init_params(jax.random.PRNGKey(0), cfg)
        params[name] = jax.tree_util.tree_map(np.asarray, rp)
        inputs[name] = M.serve_inputs(M.serve_config(arch, ov))
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with ThreadPoolExecutor(len(MESHES)) as pool:
            spawned = {world: pool.submit(
                M.spawn, "serve_mesh_ranks",
                tmp_path_factory.mktemp(f"serve_mesh_{world}"), world=world,
                data=data, cases=CASES, params=params, inputs=inputs)
                for world, data in MESHES.items()}
            one = {name: M.serve_on(None, M.serve_config(*CASES[name]),
                                    params[name], *inputs[name])
                   for name in CASES}
            ref = {name: _jax_run(name, params[name], *inputs[name])
                   for name in CASES}
            ranks = {world: f.result() for world, f in spawned.items()}
    finally:
        torch.set_num_threads(old)
    return {"ranks": ranks, "one": one, "ref": ref}


def _rank_runs(runs, name, world):
    out = []
    for res in runs["ranks"][world]:
        got = res[name]
        assert "error" not in got, got.get("error")
        out.append((res["coords"], got))
    return out


def _rows(a, data, dr):
    b = M.SERVE_B // data
    return a[dr * b:(dr + 1) * b]


@pytest.mark.parametrize("name,world", RUNS, ids=IDS)
def test_serve_logits_match_one_process_and_jax(runs, name, world):
    data = MESHES[world]
    for (dr, _), got in _rank_runs(runs, name, world):
        for key in STEP_KEYS:
            want = _rows(runs["one"][name][key], data, dr)
            assert got[key].shape == want.shape, key
            np.testing.assert_allclose(got[key], want, rtol=TOL_ONE,
                                       atol=TOL_ONE, err_msg=key)
            np.testing.assert_allclose(
                got[key], _rows(runs["ref"][name][key], data, dr),
                rtol=TOL_JAX, atol=TOL_JAX, err_msg=key)


@pytest.mark.parametrize("name,world", RUNS, ids=IDS)
def test_serve_greedy_tokens_match(runs, name, world):
    data = MESHES[world]
    for (dr, _), got in _rank_runs(runs, name, world):
        for key in STEP_KEYS:
            tok = got[key].argmax(-1)
            assert np.array_equal(
                tok, _rows(runs["one"][name][key], data, dr).argmax(-1)), key
            assert np.array_equal(
                tok, _rows(runs["ref"][name][key], data, dr).argmax(-1)), key


def _placement(name, world):
    cfg = M.serve_config(*CASES[name])
    from repro_torch.models.base import get_family
    whole = get_family(cfg.family).init_cache(
        cfg, M.SERVE_B, M.SERVE_S + M.SERVE_STEPS, device="meta")
    mesh = HostMesh.abstract(MESHES[world], MODEL)
    return whole, serve.cache_placement(whole, cfg, mesh, M.SERVE_B)


@pytest.mark.parametrize("name,world", RUNS, ids=IDS)
def test_cache_blocks_are_the_placement(runs, name, world):
    """After the prefill and after the last step, each rank's leaves are
    its blocks of W = 1's cache; each holds 1/M of the leaf (1/(M x data)
    where the rows split), the sLSTM state 1/data."""
    data = MESHES[world]
    whole, placement = _placement(name, world)
    paths = [p for p, _ in tree_flatten_with_path(whole)]
    shs = tree_leaves(placement)
    for (dr, mr), got in _rank_runs(runs, name, world):
        for key in ("cache_prefill", "cache"):
            want = runs["one"][name][key]
            assert len(got[key]) == len(want) == len(shs)
            for path, a, w, sh in zip(paths, got[key], want, shs):
                wb = block(torch.from_numpy(w), sh, dr, mr).numpy()
                assert a.shape == wb.shape, (key, path)
                np.testing.assert_allclose(a, wb, rtol=TOL_ONE, atol=TOL_ONE,
                                           err_msg=f"{key} {path}")
                cut = MODEL if path[0] != "s_seg" else 1
                assert a.size * cut * data == w.size, (key, path)


# where each case's KV cache is cut (None: it has none) and its
# flash_decode calls' (query heads, kv heads, head_dim) per rank
KV_CUT = {name: -2 for name in CASES}
KV_CUT.update(smollm_kv5=-1, xlstm=None, xlstm_h1=None)


@pytest.mark.parametrize("name,world", RUNS, ids=IDS)
def test_flash_decode_runs_on_the_ranks_kv_heads(runs, name, world):
    cfg = M.serve_config(*CASES[name])
    one = runs["one"][name]
    for _, got in _rank_runs(runs, name, world):
        assert got["n_flash"] == one["n_flash"]
        if KV_CUT[name] is None:
            assert got["flash_calls"] == one["flash_calls"] == []
            continue
        H, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        want = ((H // MODEL, Hkv // MODEL, Dh) if KV_CUT[name] == -2
                else (H, Hkv, Dh))
        assert got["flash_calls"] == [want]
        assert one["flash_calls"] == [(H, Hkv, Dh)]


@pytest.mark.parametrize("name", list(CASES))
def test_served_placement_cuts_each_leaf_where_its_compute_is_cut(name):
    """The placement's model-axis dim per cache leaf (launch/serve.py's
    table) and its rows over the data axes."""
    cfg = M.serve_config(*CASES[name])
    kv = KV_CUT[name]
    want = {"k": kv, "v": kv, "xk": kv, "xv": kv, "attn_k": kv,
            "attn_v": kv, "seg_conv": -1, "tail_conv": -1, "seg_ssm": -3,
            "tail_ssm": -3, "m_seg": -3 if cfg.n_heads % MODEL == 0 else -2,
            "m_tail": -3 if cfg.n_heads % MODEL == 0 else -2,
            "s_seg": None}
    for world in MESHES:
        whole, placement = _placement(name, world)
        for (path, leaf), sh in zip(tree_flatten_with_path(whole),
                                    tree_leaves(placement)):
            n = leaf.dim()
            model = [i - n for i, e in enumerate(sh.spec) if e == "model"]
            assert model == ([] if want[path[0]] is None
                             else [want[path[0]]]), path
            rows = [i - n for i, e in enumerate(sh.spec) if e == "data"]
            lead = -3 if path[0] in ("seg_conv", "tail_conv", "s_seg") \
                else -4
            assert rows == ([lead] if MESHES[world] > 1 else []), path
