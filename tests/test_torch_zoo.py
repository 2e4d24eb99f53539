"""The port's architecture zoo on the CPU against the JAX package: the
nine architectures beside zamba2 (dense, MoE, xLSTM, Whisper, VLM), each
at its ``reduced()`` config in f32 with the JAX params carried across by
``params_from_numpy``; the layers they add; their init trees at the
reduced and the full configs; ``input_specs``.

Inputs are made with numpy from a seed.  Tolerance 1e-4 for whole models
(f32 sums over the layers in another order; the measured gap is below
2e-5) and 1e-5 for single layers; greedy tokens, MoE top-k indices and
keep masks exactly equal.  The reference runs jitted, in this process:
each family's prefill agrees with itself between ``jax.jit`` and
``jax.disable_jit()`` (checked below), so no family needs the
subprocess with the ``algsimp`` flag that the DP engine's tests use.
"""
import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as R_ARCH_IDS
from repro.configs import get_config as r_get_config
from repro.models import base as r_base
from repro.models import layers as r_layers
from repro.models import moe as r_moe
from repro.models import vlm as r_vlm
from repro.models import whisper as r_whisper
from repro.models import xlstm as r_xlstm

from repro_torch.configs import get_config as t_get_config
from repro_torch.models import base as t_base
from repro_torch.models import convert
from repro_torch.models import layers as t_layers
from repro_torch.models import moe as t_moe
from repro_torch.models import vlm as t_vlm
from repro_torch.models import whisper as t_whisper
from repro_torch.models import xlstm as t_xlstm
from repro_torch.pytree import tree_leaves

B, S, STEPS = 2, 64, 4
ZOO = [a for a in R_ARCH_IDS if a != "zamba2-1.2b"]      # nine
# the reduced configs never reach gemma2's 4096 window or an expert's
# capacity at S = 64: one case each where they do
VARIANTS = {"gemma2-2b/window24": ("gemma2-2b", dict(sliding_window=24)),
            "olmoe-1b-7b/cap0.5": ("olmoe-1b-7b",
                                   dict(capacity_factor=0.5))}
CASES = ZOO + list(VARIANTS)


def _cfgs(case):
    arch, kw = VARIANTS.get(case, (case, {}))
    kw = dict(kw, param_dtype="float32")
    return (r_get_config(arch).reduced().replace(**kw),
            t_get_config(arch).reduced().replace(**kw))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, want, tol):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else got
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _r(a):
    return jnp.asarray(a)


def _t(a):
    return torch.from_numpy(np.array(a))


def _batches(cfg, toks, rng):
    """The same batch for both packages: tokens, labels and the stub
    modality embeddings."""
    arrays = {"tokens": toks[:, :S], "labels": toks[:, 1:S + 1]}
    if cfg.family == "audio":
        arrays["frames"] = rng.standard_normal(
            (B, cfg.enc_frames, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        arrays["patches"] = rng.standard_normal(
            (B, cfg.n_patches, cfg.d_model)).astype(np.float32)
    return ({k: _r(v) for k, v in arrays.items()},
            {k: _t(v) for k, v in arrays.items()})


# ---------------------------------------------------------------------------
# each architecture as a whole: logits_fn, loss, prefill + cache, decode
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=CASES)
def serve_run(request):
    """logits_fn and loss over B x S tokens, a prefill of them, then STEPS
    decode steps on given tokens, in both packages from the same
    (JAX-initialised) params."""
    r_cfg, t_cfg = _cfgs(request.param)
    r_fam, t_fam = (r_base.get_family(r_cfg.family),
                    t_base.get_family(t_cfg.family))
    rp = r_fam.init_params(jax.random.PRNGKey(0), r_cfg)
    tp = convert.params_from_numpy(_np_tree(rp))
    rng = np.random.default_rng(0)
    toks = rng.integers(0, r_cfg.vocab, size=(B, S + STEPS)).astype(np.int32)
    r_batch, t_batch = _batches(r_cfg, toks, rng)
    off = r_cfg.n_patches if r_cfg.family == "vlm" else 0   # global pos

    prefill = jax.jit(r_fam.prefill, static_argnums=2)
    decode = jax.jit(r_fam.decode_step, static_argnums=4)
    r_out = {"logits_fn": np.asarray(jax.jit(r_fam.forward, static_argnums=2)(
                 rp, r_batch, r_cfg)),
             "loss": np.asarray(jax.jit(r_fam.loss, static_argnums=2)(
                 rp, r_batch, r_cfg))}
    r_cache = r_fam.init_cache(r_cfg, B, S + STEPS)
    lg, r_cache = prefill(rp, r_batch, r_cfg, r_cache)
    r_out["prefill"], r_out["cache"] = np.asarray(lg), _np_tree(r_cache)
    for t in range(STEPS):
        lg, r_cache = decode(rp, r_cache, _r(toks[:, S + t:S + t + 1]),
                             jnp.full((B,), off + S + t, jnp.int32), r_cfg)
        r_out[f"decode{t}"] = np.asarray(lg)

    t_out = {"logits_fn": t_fam.forward(tp, t_batch, t_cfg),
             "loss": t_fam.loss(tp, t_batch, t_cfg)}
    t_cache = t_fam.init_cache(t_cfg, B, S + STEPS, device="cpu")
    lg, t_cache = t_fam.prefill(tp, t_batch, t_cfg, t_cache)
    t_out["prefill"] = lg
    # a copy: the decode steps below write into the cache in place
    t_out["cache"] = copy.deepcopy(convert.params_to_numpy(t_cache))
    for t in range(STEPS):
        lg, t_cache = t_fam.decode_step(
            tp, t_cache, _t(toks[:, S + t:S + t + 1]),
            torch.full((B,), off + S + t, dtype=torch.int32), t_cfg)
        t_out[f"decode{t}"] = lg
    return dict(r=r_out, t=t_out, rp=rp, r_cfg=r_cfg, r_batch=r_batch,
                r_fam=r_fam, case=request.param)


STEP_KEYS = ["prefill"] + [f"decode{t}" for t in range(STEPS)]


@pytest.mark.parametrize("what", ["logits_fn", "loss"] + STEP_KEYS)
def test_zoo_outputs_match_jax(serve_run, what):
    got, want = serve_run["t"][what], serve_run["r"][what]
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    _close(got, want, 1e-4)


def test_zoo_prefill_cache_matches_jax(serve_run):
    """Every cache leaf the reference's prefill returns (the KV caches,
    Whisper's cross K/V, the xLSTM block states)."""
    want = jax.tree_util.tree_leaves_with_path(serve_run["r"]["cache"])
    got = dict(jax.tree_util.tree_leaves_with_path(serve_run["t"]["cache"]))
    assert want
    for path, leaf in want:
        assert got[path].shape == leaf.shape, path
        _close(got[path], leaf, 1e-4)


def test_zoo_greedy_tokens_match_jax(serve_run):
    for what in STEP_KEYS:
        assert np.array_equal(serve_run["t"][what].argmax(-1).numpy(),
                              serve_run["r"][what].argmax(-1)), what


def test_reference_prefill_agrees_with_itself_eager_and_jitted(serve_run):
    """The check for the XLA:CPU ``algsimp`` miscompile found in the DP
    engine: every family's jitted prefill equals its eager one, so the
    reference runs in this process."""
    r_cfg, r_fam = serve_run["r_cfg"], serve_run["r_fam"]
    with jax.disable_jit():
        lg, _ = r_fam.prefill(serve_run["rp"], serve_run["r_batch"], r_cfg,
                              r_fam.init_cache(r_cfg, B, S + STEPS))
    np.testing.assert_allclose(np.asarray(lg), serve_run["r"]["prefill"],
                               rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# the layers the zoo adds (1e-5)
# ---------------------------------------------------------------------------

def test_layer_norm_and_cross_entropy_match_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 9, 48)).astype(np.float32) * 3 + 1
    scale, bias = (rng.standard_normal(48).astype(np.float32)
                   for _ in range(2))
    _close(t_layers.layer_norm(_t(x), _t(scale), _t(bias)),
           r_layers.layer_norm(_r(x), _r(scale), _r(bias)), 1e-5)
    logits = rng.standard_normal((2, 9, 40)).astype(np.float32) * 4
    labels = rng.integers(0, 40, size=(2, 9)).astype(np.int32)
    _close(t_layers.cross_entropy_loss(_t(logits), _t(labels), 40),
           r_layers.cross_entropy_loss(_r(logits), _r(labels), 40), 1e-5)


def test_attention_without_rope_matches_jax():
    """Whisper's attention: ``rope=False``, bidirectional, and a
    cross-attention ``kv_override`` over other positions."""
    kw = dict(arch_id="t", family="audio", source="t", n_layers=1,
              d_model=64, n_heads=4, n_kv_heads=4, d_ff=96, vocab=40,
              param_dtype="float32")
    r_cfg, t_cfg = r_base.ArchConfig(**kw), t_base.ArchConfig(**kw)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 24, 64)).astype(np.float32)
    rp = r_layers.init_attention(jax.random.PRNGKey(0), r_cfg)
    tp = convert.params_from_numpy(_np_tree(rp))
    _close(t_layers.attention(_t(x), tp, t_cfg, causal=False, rope=False),
           r_layers.attention(_r(x), rp, r_cfg, causal=False, rope=False),
           1e-5)
    enc = rng.standard_normal((2, 37, 4, 16)).astype(np.float32)
    epos = np.broadcast_to(np.arange(37), (2, 37))
    _close(t_layers.attention(_t(x), tp, t_cfg, causal=False, rope=False,
                              kv_override=(_t(enc), _t(enc[::-1]),
                                           _t(epos))),
           r_layers.attention(_r(x), rp, r_cfg, causal=False, rope=False,
                              kv_override=(_r(enc), _r(enc[::-1]),
                                           _r(epos))), 1e-5)


def _r_routing(xg, router, cfg):
    """The routing decisions of ``repro/models/moe.py::moe_mlp`` (its
    lines from the router logits to ``keep``), which the JAX package
    computes inside the function and does not return."""
    E, K = cfg.n_experts, cfg.top_k
    g, s, _ = xg.shape
    probs = jax.nn.softmax(jnp.einsum("gsd,de->gse", xg.astype(jnp.float32),
                                      router), axis=-1)
    top_p, top_e = jax.lax.top_k(probs, K)
    cap = int(max(4, (s * K / E) * cfg.capacity_factor))
    flat = jax.nn.one_hot(top_e, E, dtype=jnp.int32).reshape(g, s * K, E)
    pos = ((jnp.cumsum(flat, axis=1) - flat) * flat).sum(-1).reshape(g, s, K)
    return np.asarray(top_e), np.asarray(pos), np.asarray(pos < cap), cap


@pytest.mark.parametrize("arch,kw,group", [
    ("olmoe-1b-7b", {}, 2048),
    ("olmoe-1b-7b", dict(capacity_factor=0.5), 2048),
    ("olmoe-1b-7b", dict(capacity_factor=0.5), 32),    # 4 groups
    ("qwen2-moe-a2.7b", dict(capacity_factor=0.25), 64),  # + shared expert
    ("qwen2-moe-a2.7b", dict(expert_pad=2), 2048),
], ids=["olmoe", "olmoe_drops", "olmoe_groups", "qwen2_shared_drops",
        "qwen2_padded"])
def test_moe_mlp_and_routing_match_jax(arch, kw, group):
    r_cfg = r_get_config(arch).reduced().replace(param_dtype="float32", **kw)
    t_cfg = t_get_config(arch).reduced().replace(param_dtype="float32", **kw)
    rp = r_moe.init_moe_mlp(jax.random.PRNGKey(3), r_cfg)
    tp = convert.params_from_numpy(_np_tree(rp))
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 64, r_cfg.d_model)).astype(np.float32)
    out_r, aux_r = r_moe.moe_mlp(_r(x), rp, r_cfg, group_size=group)
    out_t, aux_t = t_moe.moe_mlp(_t(x), tp, t_cfg, group_size=group)
    _close(out_t, out_r, 1e-5)
    _close(aux_t, aux_r, 1e-5)
    g = max(1, 128 // group)
    xg = x.reshape(g, 128 // g, -1)
    top_e, pos, keep, cap = _r_routing(_r(xg), rp["router"], r_cfg)
    _, te, kp, ps, cp, _ = t_moe.route(_t(xg), tp["router"], t_cfg)
    assert cp == cap
    np.testing.assert_array_equal(te.numpy(), top_e)
    np.testing.assert_array_equal(ps.numpy(), pos)
    np.testing.assert_array_equal(kp.numpy(), keep)
    if kw.get("capacity_factor", 1.25) < 1:
        assert not keep.all()                     # tokens were dropped


@pytest.fixture(scope="module")
def xlstm_cfgs():
    return (r_get_config("xlstm-350m").reduced().replace(
                param_dtype="float32"),
            t_get_config("xlstm-350m").reduced().replace(
                param_dtype="float32"))


@pytest.mark.parametrize("from_state", [False, True])
def test_mlstm_chunked_matches_jax(from_state):
    rng = np.random.default_rng(4)
    b, s, h, d = 2, 48, 3, 16
    q, k, v = (rng.standard_normal((b, s, h, d)).astype(np.float32)
               for _ in range(3))
    logf = np.log(1 / (1 + np.exp(-rng.standard_normal((b, s, h)) - 2))) \
        .astype(np.float32)
    logi = np.minimum(rng.standard_normal((b, s, h)), 10.0).astype(np.float32)
    st = (rng.standard_normal((b, h, d, d + 1)).astype(np.float32)
          if from_state else None)
    y_r, c_r = r_xlstm.mlstm_chunked(_r(q), _r(k), _r(v), _r(logf), _r(logi),
                                     16, None if st is None else _r(st))
    y_t, c_t = t_xlstm.mlstm_chunked(_t(q), _t(k), _t(v), _t(logf), _t(logi),
                                     16, None if st is None else _t(st))
    _close(y_t, y_r, 1e-5)
    _close(c_t, c_r, 1e-5)


@pytest.mark.parametrize("from_state", [False, True])
def test_slstm_scan_matches_jax(xlstm_cfgs, from_state):
    r_cfg, t_cfg = xlstm_cfgs
    rp = r_xlstm.init_slstm(jax.random.PRNGKey(5), r_cfg)
    tp = convert.params_from_numpy(_np_tree(rp))
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 24, r_cfg.d_model)).astype(np.float32)
    H, dh = r_cfg.n_heads, r_cfg.d_model // r_cfg.n_heads
    init = ({g: rng.standard_normal((2, H, dh)).astype(np.float32)
             for g in "cnhm"} if from_state else None)
    y_r, f_r = r_xlstm.slstm_scan(
        _r(x), rp, r_cfg, None if init is None else
        {k: _r(v) for k, v in init.items()})
    y_t, f_t = t_xlstm.slstm_scan(
        _t(x), tp, t_cfg, None if init is None else
        {k: _t(v) for k, v in init.items()})
    _close(y_t, y_r, 1e-5)
    for key in "cnhm":
        _close(f_t[key], f_r[key], 1e-5)


def test_whisper_encode_matches_jax():
    r_cfg, t_cfg = _cfgs("whisper-large-v3")
    rp = r_whisper.init_params(jax.random.PRNGKey(6), r_cfg)
    tp = convert.params_from_numpy(_np_tree(rp))
    frames = np.random.default_rng(6).standard_normal(
        (2, r_cfg.enc_frames, r_cfg.d_model)).astype(np.float32)
    _close(t_whisper._sinusoidal(64, 32), r_whisper._sinusoidal(64, 32),
           1e-6)
    _close(t_whisper.encode(tp, _t(frames), t_cfg),
           r_whisper.encode(rp, _r(frames), r_cfg), 1e-5)


def test_vlm_prefix_embedding_matches_jax():
    r_cfg, t_cfg = _cfgs("phi-3-vision-4.2b")
    rp = r_vlm.init_params(jax.random.PRNGKey(7), r_cfg)
    tp = convert.params_from_numpy(_np_tree(rp))
    rng = np.random.default_rng(7)
    r_batch, t_batch = _batches(
        r_cfg, rng.integers(0, r_cfg.vocab, (B, S + 1)).astype(np.int32), rng)
    x_r, pos_r, p_r = r_vlm._prefix_embed(rp, r_batch, r_cfg)
    x_t, pos_t, p_t = t_vlm._prefix_embed(tp, t_batch, t_cfg)
    assert p_t == p_r == r_cfg.n_patches
    assert torch.equal(x_t, _t(np.asarray(x_r)))
    np.testing.assert_array_equal(pos_t.numpy(), np.asarray(pos_r))


# ---------------------------------------------------------------------------
# init trees, caches and input specs
# ---------------------------------------------------------------------------

def _structure(tree):
    if isinstance(tree, dict):
        return {k: _structure(v) for k, v in tree.items()}
    if tree is None:
        return None
    return (tuple(tree.shape), str(tree.dtype).split(".")[-1])


@pytest.mark.parametrize("arch", ZOO)
def test_init_tree_matches_jax_reduced(arch):
    """Keys, shapes and dtypes of a drawn init (bf16, the configs' own
    dtype) and its cache, against the JAX package's."""
    r_cfg = r_get_config(arch).reduced()
    t_cfg = t_get_config(arch).reduced()
    r_fam, t_fam = (r_base.get_family(r_cfg.family),
                    t_base.get_family(t_cfg.family))
    tp = t_fam.init_params(t_cfg, seed=0, device="cpu")
    assert _structure(tp) == _structure(
        r_fam.init_params(jax.random.PRNGKey(0), r_cfg))
    assert _structure(t_fam.init_cache(t_cfg, B, 80, device="cpu")) == \
        _structure(r_fam.init_cache(r_cfg, B, 80))
    again = t_fam.init_params(t_cfg, seed=0, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(tp),
                                                 tree_leaves(again)))


@pytest.mark.parametrize("arch", ZOO)
def test_init_tree_matches_jax_full(arch):
    """At full width, shapes only: the port's init and cache on the
    ``meta`` device against ``jax.eval_shape``."""
    r_cfg, t_cfg = r_get_config(arch), t_get_config(arch)
    r_fam, t_fam = (r_base.get_family(r_cfg.family),
                    t_base.get_family(t_cfg.family))
    tp = t_fam.init_params(t_cfg, seed=0, device="meta")
    assert _structure(tp) == _structure(jax.eval_shape(
        lambda k: r_fam.init_params(k, r_cfg), jax.random.PRNGKey(0)))
    assert _structure(t_fam.init_cache(t_cfg, 8, 2048, device="meta")) == \
        _structure(jax.eval_shape(lambda: r_fam.init_cache(r_cfg, 8, 2048)))


@pytest.mark.parametrize("arch", R_ARCH_IDS)
def test_input_specs_match_jax(arch):
    r_cfg, t_cfg = r_get_config(arch), t_get_config(arch)
    for name, shape in t_base.INPUT_SHAPES.items():
        want = r_base.input_specs(r_cfg, r_base.INPUT_SHAPES[name])
        got = t_base.input_specs(t_cfg, shape)
        assert set(got) == set(want)
        for k, spec in got.items():
            assert spec.device.type == "meta"
            assert (tuple(spec.shape), str(spec.dtype).split(".")[-1]) == \
                (want[k].shape, str(want[k].dtype)), (name, k)


def test_init_is_seeded_and_scaled():
    t_cfg = t_get_config("llama3.2-3b").reduced()
    fam = t_base.get_family("dense")
    a = fam.init_params(t_cfg, seed=3, device="cpu")
    c = fam.init_params(t_cfg, seed=4, device="cpu")
    w = a["blocks"]["mlp"]["w_up"].float()          # fan_in d_model
    assert abs(float(w.std()) * t_cfg.d_model ** 0.5 - 1.0) < 0.02
    assert not torch.equal(w[0], w[1])             # layers drawn one by one
    assert not torch.equal(a["embedding"], c["embedding"])


@pytest.mark.parametrize("arch", ZOO)
def test_serving_entry_points_default_to_the_card(monkeypatch, arch):
    """No silent CPU fallback: without device="cpu" they need CUDA."""
    t_cfg = t_get_config(arch).reduced()
    fam = t_base.get_family(t_cfg.family)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fam.init_params(t_cfg, seed=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fam.init_cache(t_cfg, 1, 8)


def test_layer_windows_are_python_ints():
    from repro_torch.models import transformer as t_transformer
    from repro.models import transformer as r_transformer
    for long in (False, True):
        r_cfg = r_get_config("gemma2-2b", long_variant=long)
        t_cfg = t_get_config("gemma2-2b", long_variant=long)
        got = t_transformer.layer_windows(t_cfg)
        assert all(type(w) is int for w in got)
        assert got == np.asarray(r_transformer.layer_windows(r_cfg)).tolist()
    assert dataclasses.asdict(t_get_config("gemma2-2b", True)) == \
        dataclasses.asdict(r_get_config("gemma2-2b", True))
