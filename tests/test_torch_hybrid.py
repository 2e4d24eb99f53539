"""The port's hybrid (zamba2) serving path on the CPU against the JAX
package: the layers it runs, the Mamba2 block, and the slice as a whole
(prefill, cache, decode steps, ``logits_fn``, ``loss``) on a reduced
zamba2 config with the JAX params carried across.  Also the config and
family registries of the whole zoo, the token pipeline (bit for bit) and
the param converter.

Inputs are made with numpy from a seed.  Tolerances: 1e-5 for the single
layers, 1e-4 for the Mamba2 block and the whole model (f32 sums over the
chunk and the layers run in another order; the measured gap is ~5e-5).
On this config the JAX reference agrees with itself between ``jax.jit``
and eager execution (checked below), so unlike the DP engine's parity
tests it runs in this process, with no XLA flag.
"""
import dataclasses
import importlib
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as r_configs
from repro.configs import get_config as r_get_config
from repro.data import tokens as r_tokens
from repro.models import base as r_base
from repro.models import hybrid as r_hybrid
from repro.models import layers as r_layers
from repro.models import mamba2 as r_mamba2

from repro_torch import configs as t_configs
from repro_torch.configs import get_config as t_get_config
from repro_torch.data import tokens as t_tokens
from repro_torch.models import base as t_base
from repro_torch.models import convert
from repro_torch.models import hybrid as t_hybrid
from repro_torch.models import layers as t_layers
from repro_torch.models import mamba2 as t_mamba2

B, S, STEPS = 2, 64, 4


def _cfgs(**kw):
    """The same reduced zamba2 config in both packages (f32)."""
    kw = dict(dict(param_dtype="float32", n_layers=3), **kw)
    return (r_get_config("zamba2-1.2b").reduced().replace(**kw),
            t_get_config("zamba2-1.2b").reduced().replace(**kw))


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


# ---------------------------------------------------------------------------
# layers (1e-5)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def attn_cfgs():
    kw = dict(arch_id="t", family="dense", source="t", n_layers=1,
              d_model=64, n_heads=4, n_kv_heads=2, d_ff=96, vocab=40,
              param_dtype="float32")
    return r_base.ArchConfig(**kw), t_base.ArchConfig(**kw)


def test_rms_norm_and_rope_match_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 9, 3, 32)).astype(np.float32)
    scale = (0.1 * rng.standard_normal(32)).astype(np.float32)
    _close(t_layers.rms_norm(_t(x), _t(scale), 1e-6),
           r_layers.rms_norm(_r(x), _r(scale), 1e-6), 1e-5)
    pos = rng.integers(0, 500, size=(2, 9))
    _close(t_layers.apply_rope(_t(x), _t(pos), 10000.0),
           r_layers.apply_rope(_r(x), _r(pos), 10000.0), 1e-5)


@pytest.mark.parametrize("case", ["one_chunk", "q_chunked", "window",
                                  "kv_override", "softcap_noncausal"])
def test_attention_matches_jax(attn_cfgs, case):
    """Including S > q_chunk (the loop over query chunks) and the
    kv_override route the hybrid prefill uses."""
    r_cfg, t_cfg = attn_cfgs
    if case == "softcap_noncausal":
        r_cfg = r_cfg.replace(attn_logit_softcap=5.0)
        t_cfg = t_cfg.replace(attn_logit_softcap=5.0)
    rng = np.random.default_rng(2)
    s = 256 if case in ("q_chunked", "window") else 40
    x = rng.standard_normal((2, s, 64)).astype(np.float32)
    rp = r_layers.init_attention(jax.random.PRNGKey(0), r_cfg)
    tp = convert.params_from_numpy(_np_tree(rp))
    kw = dict(q_chunk=64 if s == 256 else 1024,
              window=50 if case == "window" else 0,
              causal=case != "softcap_noncausal")
    r_kw, t_kw = dict(kw), dict(kw)
    if case == "kv_override":
        pos = np.broadcast_to(np.arange(s), (2, s))
        _, k, v = r_layers._qkv(_r(x), rp, r_cfg, _r(pos))
        r_kw["kv_override"] = (k, v, _r(pos))
        t_kw["kv_override"] = (_t(k), _t(v), _t(pos))
    _close(t_layers.attention(_t(x), tp, t_cfg, **t_kw),
           r_layers.attention(_r(x), rp, r_cfg, **r_kw), 1e-5)


@pytest.mark.parametrize("window", [0, 20])
def test_decode_attention_matches_jax(attn_cfgs, window):
    r_cfg, t_cfg = attn_cfgs
    rng = np.random.default_rng(3)
    L_, Dh = 48, r_cfg.head_dim
    q = rng.standard_normal((2, 1, 4, Dh)).astype(np.float32)
    ck = rng.standard_normal((2, L_, 2, Dh)).astype(np.float32)
    cv = rng.standard_normal((2, L_, 2, Dh)).astype(np.float32)
    pos = np.array([30, 47], np.int32)
    rp = r_layers.init_attention(jax.random.PRNGKey(1), r_cfg)
    tp = convert.params_from_numpy(_np_tree(rp))
    _close(t_layers.decode_attention(_t(q), tp, _t(ck), _t(cv), _t(pos),
                                     t_cfg, window=window),
           r_layers.decode_attention(_r(q), rp, _r(ck), _r(cv), _r(pos),
                                     r_cfg, window=window), 1e-5)


@pytest.mark.parametrize("variant", ["swiglu", "geglu", "gelu"])
def test_mlp_and_embeddings_match_jax(variant):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 7, 32)).astype(np.float32)
    rp = r_layers.init_mlp(jax.random.PRNGKey(2), 32, 48, jnp.float32,
                           variant)
    tp = convert.params_from_numpy(_np_tree(rp))
    _close(t_layers.mlp(_t(x), tp, variant),
           r_layers.mlp(_r(x), rp, variant), 1e-5)
    emb = rng.standard_normal((40, 32)).astype(np.float32)
    toks = rng.integers(0, 40, size=(2, 7)).astype(np.int32)
    assert torch.equal(t_layers.embed(_t(toks), _t(emb)),
                       _t(np.asarray(r_layers.embed(_r(toks), _r(emb)))))
    _close(t_layers.unembed(_t(x), _t(emb), softcap=3.0),
           r_layers.unembed(_r(x), _r(emb), softcap=3.0), 1e-5)


# ---------------------------------------------------------------------------
# Mamba2 block (1e-4)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mamba_setup():
    kw = dict(arch_id="t", family="hybrid", source="t", n_layers=1,
              d_model=32, n_heads=4, n_kv_heads=4, d_ff=64, vocab=16,
              ssm_state=16, ssm_head_dim=16, ssm_chunk=16,
              param_dtype="float32")
    r_cfg, t_cfg = r_base.ArchConfig(**kw), t_base.ArchConfig(**kw)
    rp = r_mamba2.init_mamba2(jax.random.PRNGKey(0), r_cfg)
    # non-trivial decay and dt bias (init leaves both 0)
    rng = np.random.default_rng(5)
    rp = dict(rp, A_log=_r(0.5 * rng.standard_normal(rp["A_log"].shape)
                           .astype(np.float32)),
              dt_bias=_r(0.5 * rng.standard_normal(rp["dt_bias"].shape)
                         .astype(np.float32)))
    x = rng.standard_normal((2, 64, 32)).astype(np.float32)
    return r_cfg, t_cfg, rp, convert.params_from_numpy(_np_tree(rp)), x


@pytest.mark.parametrize("use_kernel", [False, True])
def test_mamba2_forward_matches_jax(mamba_setup, use_kernel):
    """The port has no ``use_kernel`` flag (the device picks the route);
    both of the JAX package's branches are its reference."""
    r_cfg, t_cfg, rp, tp, x = mamba_setup
    y_r, (tail_r, st_r) = r_mamba2.mamba2_forward(_r(x), rp, r_cfg,
                                                  use_kernel=use_kernel)
    y_t, (tail_t, st_t) = t_mamba2.mamba2_forward(_t(x), tp, t_cfg)
    _close(y_t, y_r, 1e-4)
    _close(tail_t, tail_r, 1e-4)
    _close(st_t, st_r, 1e-4)


def test_mamba2_forward_from_a_state_and_decode_match_jax(mamba_setup):
    """A continued prefill (``state`` given) and one recurrent decode
    step from the prefill's state."""
    r_cfg, t_cfg, rp, tp, x = mamba_setup
    _, st_r = r_mamba2.mamba2_forward(_r(x[:, :32]), rp, r_cfg)
    _, st_t = t_mamba2.mamba2_forward(_t(x[:, :32]), tp, t_cfg)
    y_r, st2_r = r_mamba2.mamba2_forward(_r(x[:, 32:]), rp, r_cfg, st_r)
    y_t, st2_t = t_mamba2.mamba2_forward(_t(x[:, 32:]), tp, t_cfg, st_t)
    _close(y_t, y_r, 1e-4)
    _close(st2_t[1], st2_r[1], 1e-4)
    d_r, (c_r, s_r) = r_mamba2.mamba2_decode(_r(x[:, :1]), rp, r_cfg, st2_r)
    d_t, (c_t, s_t) = t_mamba2.mamba2_decode(_t(x[:, :1]), tp, t_cfg, st2_t)
    _close(d_t, d_r, 1e-4)
    _close(c_t, c_r, 1e-4)
    _close(s_t, s_r, 1e-4)


def test_segsum_and_causal_conv_match_jax():
    rng = np.random.default_rng(6)
    a = (-np.abs(rng.standard_normal((2, 3, 8)))).astype(np.float32)
    _close(torch.exp(t_mamba2._segsum(_t(a))),
           jnp.exp(r_mamba2._segsum(_r(a))), 1e-5)
    xbc = rng.standard_normal((2, 10, 6)).astype(np.float32)
    w = rng.standard_normal((4, 6)).astype(np.float32)
    bias = rng.standard_normal(6).astype(np.float32)
    _close(t_mamba2._causal_conv(_t(xbc), _t(w), _t(bias)),
           r_mamba2._causal_conv(_r(xbc), _r(w), _r(bias)), 1e-5)


# ---------------------------------------------------------------------------
# the slice as a whole: reduced zamba2, one segment + one trailing layer
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def serve_run():
    """Prefill of B x S tokens, then STEPS decode steps on given tokens,
    in both packages from the same (JAX-initialised) params."""
    r_cfg, t_cfg = _cfgs(attn_every=2)
    assert t_hybrid.segment_plan(t_cfg) == (1, 2, 1)
    rp = r_hybrid.init_params(jax.random.PRNGKey(0), r_cfg)
    tp = convert.params_from_numpy(_np_tree(rp))
    rng = np.random.default_rng(0)
    toks = rng.integers(0, r_cfg.vocab, size=(B, S + STEPS)).astype(np.int32)

    prefill = jax.jit(r_hybrid.prefill, static_argnums=2)
    decode = jax.jit(r_hybrid.decode_step, static_argnums=4)
    r_cache = r_hybrid.init_cache(r_cfg, B, S + STEPS)
    lg, r_cache = prefill(rp, {"tokens": _r(toks[:, :S])}, r_cfg, r_cache)
    r_out = {"prefill": np.asarray(lg), "cache": _np_tree(r_cache)}
    for t in range(STEPS):
        lg, r_cache = decode(rp, r_cache, _r(toks[:, S + t:S + t + 1]),
                             jnp.full((B,), S + t, jnp.int32), r_cfg)
        r_out[f"decode{t}"] = np.asarray(lg)
    r_out["logits_fn"] = np.asarray(jax.jit(
        r_hybrid.logits_fn, static_argnums=2)(
            rp, {"tokens": _r(toks[:, :S])}, r_cfg))

    t_cache = t_hybrid.init_cache(t_cfg, B, S + STEPS, device="cpu")
    lg, t_cache = t_hybrid.prefill(tp, {"tokens": _t(toks[:, :S])}, t_cfg,
                                   t_cache)
    t_out = {"prefill": lg, "cache": {k: None if v is None else v.clone()
                                      for k, v in t_cache.items()}}
    for t in range(STEPS):
        lg, t_cache = t_hybrid.decode_step(
            tp, t_cache, _t(toks[:, S + t:S + t + 1]),
            torch.full((B,), S + t, dtype=torch.int32), t_cfg)
        t_out[f"decode{t}"] = lg
    t_out["logits_fn"] = t_hybrid.logits_fn(tp, {"tokens": _t(toks[:, :S])},
                                            t_cfg)
    return dict(r=r_out, t=t_out, rp=rp, r_cfg=r_cfg, toks=toks)


@pytest.mark.parametrize("what", ["prefill", "logits_fn"] +
                         [f"decode{t}" for t in range(STEPS)])
def test_hybrid_logits_match_jax(serve_run, what):
    got, want = serve_run["t"][what], serve_run["r"][what]
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    _close(got, want, 1e-4)


@pytest.mark.parametrize("leaf", ["seg_conv", "seg_ssm", "tail_conv",
                                  "tail_ssm", "attn_k", "attn_v"])
def test_hybrid_prefill_cache_matches_jax(serve_run, leaf):
    got, want = serve_run["t"]["cache"][leaf], serve_run["r"]["cache"][leaf]
    assert tuple(got.shape) == want.shape
    _close(got, want, 1e-4)


def test_reference_prefill_agrees_with_itself_eager_and_jitted(serve_run):
    """The check for the XLA:CPU ``algsimp`` miscompile found in the DP
    engine: here ``jax.jit`` and eager execution agree (~4e-6), so the
    reference needs no subprocess with the pass disabled."""
    r_cfg, rp, toks = serve_run["r_cfg"], serve_run["rp"], serve_run["toks"]
    with jax.disable_jit():
        lg, _ = r_hybrid.prefill(rp, {"tokens": _r(toks[:, :S])}, r_cfg,
                                 r_hybrid.init_cache(r_cfg, B, S + STEPS))
    np.testing.assert_allclose(np.asarray(lg), serve_run["r"]["prefill"],
                               rtol=1e-4, atol=1e-4)


def test_hybrid_greedy_tokens_match_jax(serve_run):
    for what in ["prefill"] + [f"decode{t}" for t in range(STEPS)]:
        assert np.array_equal(serve_run["t"][what].argmax(-1).numpy(),
                              serve_run["r"][what].argmax(-1))


# ---------------------------------------------------------------------------
# params, configs, registry
# ---------------------------------------------------------------------------

def _structure(tree):
    if isinstance(tree, dict):
        return {k: _structure(v) for k, v in tree.items()}
    if tree is None:
        return None
    return (tuple(tree.shape), str(tree.dtype).split(".")[-1])


@pytest.mark.parametrize("kw", [dict(n_layers=3),
                                dict(n_layers=2),      # no trailing layer
                                dict(n_layers=3, param_dtype="bfloat16")],
                         ids=["trailing", "no_trailing", "bf16"])
def test_init_params_has_the_jax_tree(kw):
    r_cfg, t_cfg = _cfgs(**kw)
    r_shapes = jax.eval_shape(lambda k: r_hybrid.init_params(k, r_cfg),
                              jax.random.PRNGKey(0))
    tp = t_hybrid.init_params(t_cfg, seed=0, device="cpu")
    assert _structure(tp) == _structure(r_shapes)
    if kw["n_layers"] == 2:
        assert tp["mamba_tail"] == {"mix": None, "ln": None}
    t_cache = t_hybrid.init_cache(t_cfg, B, 80, device="cpu")
    r_cache = jax.eval_shape(lambda: r_hybrid.init_cache(r_cfg, B, 80))
    assert _structure(t_cache) == _structure(r_cache)


def test_init_params_is_seeded_and_scaled():
    _, t_cfg = _cfgs()
    a = t_hybrid.init_params(t_cfg, seed=3, device="cpu")
    b = t_hybrid.init_params(t_cfg, seed=3, device="cpu")
    c = t_hybrid.init_params(t_cfg, seed=4, device="cpu")
    assert torch.equal(a["mamba_seg"]["mix"]["in_proj"],
                       b["mamba_seg"]["mix"]["in_proj"])
    assert not torch.equal(a["embedding"], c["embedding"])
    w = a["mamba_seg"]["mix"]["in_proj"]            # fan_in d_model
    assert abs(float(w.std()) * t_cfg.d_model ** 0.5 - 1.0) < 0.02
    # stacked layers are drawn one by one: no two are equal
    assert not torch.equal(w[0, 0], w[0, 1])
    assert torch.equal(a["mamba_seg"]["mix"]["D"],
                       torch.ones_like(a["mamba_seg"]["mix"]["D"]))


def test_serving_entry_points_default_to_the_card(monkeypatch):
    """No silent CPU fallback: without device="cpu" they need CUDA."""
    _, t_cfg = _cfgs()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_hybrid.init_params(t_cfg, seed=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_hybrid.init_cache(t_cfg, 1, 8)


def test_configs_match_jax():
    r_cfg, t_cfg = r_get_config("zamba2-1.2b"), t_get_config("zamba2-1.2b")
    assert dataclasses.asdict(t_cfg) == dataclasses.asdict(r_cfg)
    assert dataclasses.asdict(t_cfg.reduced()) == \
        dataclasses.asdict(r_cfg.reduced())
    assert t_cfg.pdtype == torch.bfloat16 and t_cfg.head_dim == 64
    assert t_hybrid.segment_plan(t_cfg) == r_hybrid.segment_plan(r_cfg) \
        == (6, 6, 2)
    assert {k: dataclasses.asdict(v) for k, v in t_base.INPUT_SHAPES.items()} \
        == {k: dataclasses.asdict(v) for k, v in r_base.INPUT_SHAPES.items()}


@pytest.mark.parametrize("module", sorted(
    p.stem for p in pathlib.Path(r_configs.__file__).parent.glob("*.py")
    if p.stem != "__init__"))
def test_every_config_matches_jax(module):
    """Each of the JAX package's ten config modules and the port's: the
    config and its ``reduced()`` (and gemma2's long variant) field for
    field; the registry resolves every id of the JAX package's."""
    r_mod = importlib.import_module(f"repro.configs.{module}")
    t_mod = importlib.import_module(f"repro_torch.configs.{module}")
    for name in ("CONFIG", "CONFIG_LONG"):
        if not hasattr(r_mod, name):
            assert not hasattr(t_mod, name)
            continue
        r_cfg, t_cfg = getattr(r_mod, name), getattr(t_mod, name)
        assert dataclasses.asdict(t_cfg) == dataclasses.asdict(r_cfg)
        if hasattr(r_cfg, "reduced"):
            assert dataclasses.asdict(t_cfg.reduced()) == \
                dataclasses.asdict(r_cfg.reduced())
    assert t_configs.ARCH_IDS == r_configs.ARCH_IDS
    assert t_configs.LONG_CONTEXT_ARCHS == r_configs.LONG_CONTEXT_ARCHS
    for arch in r_configs.ARCH_IDS:
        for long in (False, True):
            assert dataclasses.asdict(t_get_config(arch, long)) == \
                dataclasses.asdict(r_get_config(arch, long))


def test_family_registry():
    """Every family of the JAX package resolves, with the functions of
    its module; an unknown name raises."""
    from repro_torch.models import moe, transformer, vlm, whisper, xlstm
    modules = {"dense": transformer, "moe": moe, "hybrid": t_hybrid,
               "ssm": xlstm, "audio": whisper, "vlm": vlm}
    for name, mod in modules.items():
        fam = t_base.get_family(name)
        assert fam.name == name == r_base.get_family(name).name
        assert fam.prefill is mod.prefill
        assert fam.forward is mod.logits_fn
        assert fam.loss is mod.loss
    with pytest.raises(KeyError, match="unknown model family"):
        t_base.get_family("rnn")


def test_hybrid_loss_matches_jax(serve_run):
    """The hybrid family's chunked CE loss (its value), on the serve run's
    params and prompt."""
    r_cfg, rp, toks = serve_run["r_cfg"], serve_run["rp"], serve_run["toks"]
    _, t_cfg = _cfgs(attn_every=2)
    batch = {"tokens": toks[:, :S], "labels": toks[:, 1:S + 1]}
    want = r_hybrid.loss(rp, {k: _r(v) for k, v in batch.items()}, r_cfg)
    got = t_hybrid.loss(convert.params_from_numpy(_np_tree(rp)),
                        {k: _t(v) for k, v in batch.items()}, t_cfg)
    _close(got, want, 1e-4)


@pytest.mark.parametrize("cfg_kw", [dict(vocab=32000, seq_len=64, seed=0),
                                    dict(vocab=512, seq_len=33, seed=9,
                                         noise=0.5, effective_vocab=100)])
def test_token_batches_bitwise(cfg_kw):
    r_b = list(r_tokens.make_batches(r_tokens.TokenDataConfig(**cfg_kw), 3, 4))
    t_b = list(t_tokens.make_batches(t_tokens.TokenDataConfig(**cfg_kw), 3, 4))
    for a, b in zip(r_b, t_b):
        for k in ("tokens", "labels"):
            assert a[k].dtype == b[k].dtype == np.int32
            np.testing.assert_array_equal(a[k], b[k])


# ---------------------------------------------------------------------------
# converter
# ---------------------------------------------------------------------------

def test_converter_keeps_bf16_and_none_leaves():
    rng = np.random.default_rng(8)
    w = jnp.asarray(rng.standard_normal((2, 3, 5)), jnp.bfloat16)
    tree = {"stack": np.asarray(w), "tail": {"mix": None, "ln": None},
            "f32": np.ones(4, np.float32), "f64": np.zeros(2)}
    out = convert.params_from_numpy(tree)
    assert out["stack"].dtype == torch.bfloat16
    assert tuple(out["stack"].shape) == (2, 3, 5)
    np.testing.assert_array_equal(out["stack"].float().numpy(),
                                  np.asarray(w, np.float32))   # exact
    assert out["tail"] == {"mix": None, "ln": None}
    assert out["f32"].dtype == torch.float32
    assert out["f64"].dtype == torch.float32
    back = convert.params_to_numpy(out)
    assert back["tail"] == {"mix": None, "ln": None}
    np.testing.assert_array_equal(back["stack"], np.asarray(w, np.float32))


def test_converter_carries_a_bf16_hybrid_tree():
    r_cfg, _ = _cfgs(n_layers=2, param_dtype="bfloat16")
    rp = r_hybrid.init_params(jax.random.PRNGKey(1), r_cfg)
    tp = convert.params_from_numpy(_np_tree(rp))
    assert _structure(tp) == _structure(rp)
    np.testing.assert_array_equal(
        tp["mamba_seg"]["mix"]["in_proj"].float().numpy(),
        np.asarray(rp["mamba_seg"]["mix"]["in_proj"], np.float32))
