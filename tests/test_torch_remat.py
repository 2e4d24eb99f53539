"""Rematerialization in every family's training forward and in the
chunked loss (``models.layers.remat``, the JAX package's
``jax.checkpoint``), on the CPU at the reduced configs of
``tests/test_torch_train_zoo.py``.

* The loss gradient of all ten configs within 1e-5 of the JAX package's
  ``jax.grad``, and for the dense and VLM families under both policies
  (``set_remat_policy(None)`` and ``"dots"`` in both packages).
* The checkpointed units are the reference's: each layer (dense, VLM,
  MoE), each segment of Mamba2 layers with the shared block and each
  trailing Mamba2 layer (hybrid), each encoder and each decoder layer
  (Whisper), each period and each trailing mLSTM layer (xLSTM), and each
  loss chunk.
* The gradient equals, bit for bit, the one of the same layers composed
  from the family's own block functions with no checkpointing, and
  ``"dots"`` equals full rematerialization bit for bit.
* The dry run's temp bytes on ``meta`` (``launch/dryrun.py::measure``)
  grow with depth by about one residual stream per added unit, beside
  the gradient of the unit's params (held twice while a stacked leaf's
  per-layer gradients are added), where without checkpointing they grow
  by tens of residual streams; and with the number of loss chunks by
  less than one chunk's logits.
* Serving (prefill and decode steps, under ``no_grad`` or with params
  that need no gradient) takes no checkpoint: the same outputs and the
  same kernel launch counts as with rematerialization switched off.
"""
import pathlib
import sys

import jax
import numpy as np
import pytest
import torch

import repro.models.transformer as r_transformer
from repro.configs import ARCH_IDS
from repro.models.base import get_family as r_get_family

from repro_torch.configs import get_config as t_get_config
from repro_torch.core.fl_step import loss_grad
from repro_torch.kernels.flash_attn import flash_attn
from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.launch import dryrun
from repro_torch.models import layers as L
from repro_torch.models import transformer as t_transformer
from repro_torch.models.base import get_family as t_get_family
from repro_torch.pytree import tree_leaves

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
import test_torch_train_zoo as Z  # noqa: E402

CHUNK = 8                     # Z.SEQ = 16 tokens: two loss chunks
TOL = 1e-5
DOTS_ARCHS = [a for a in ARCH_IDS
              if t_get_config(a).family in ("dense", "vlm")]
GRAD_CASES = ([(a, None) for a in ARCH_IDS]
              + [(a, "dots") for a in DOTS_ARCHS])


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture
def policy():
    """Sets both packages' remat policy; restores None after."""
    def set_(name):
        r_transformer.set_remat_policy(name)
        t_transformer.set_remat_policy(name)
    yield set_
    set_(None)


def _plain_remat(fn, *args, policy=None):
    return fn(*args)


def _port_grad(t_cfg, t_params, t_batch):
    fam = t_get_family(t_cfg.family)
    return tree_leaves(loss_grad(
        lambda p, b: fam.loss(p, b, t_cfg, loss_chunk=CHUNK), t_params,
        t_batch))


class _Counted:
    """``torch.utils.checkpoint.checkpoint`` as the layers call it,
    counting its calls."""

    def __init__(self):
        self.calls, self.real = 0, L._ckpt.checkpoint

    def __call__(self, *a, **kw):
        self.calls += 1
        return self.real(*a, **kw)


@pytest.mark.parametrize("arch,name", GRAD_CASES,
                         ids=[f"{a}-{n or 'full'}" for a, n in GRAD_CASES])
def test_gradient_matches_the_reference(arch, name, policy):
    policy(name)
    r_cfg, t_cfg, r_params, t_params, r_batch, t_batch = Z.setup_arch(arch)
    r_fam = r_get_family(r_cfg.family)
    r_grad = jax.jit(jax.grad(lambda p: r_fam.loss(
        p, r_batch, r_cfg, loss_chunk=CHUNK)))(r_params)
    got = _port_grad(t_cfg, t_params, t_batch)
    want = jax.tree_util.tree_leaves(r_grad)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=TOL,
                                   atol=TOL)


# a third layer gives the hybrid and xLSTM families a trailing unit
UNIT_OVERRIDES = {"n_layers": 3}


def _units(cfg, S):
    """The checkpointed units of one training forward and loss."""
    from repro_torch.models import hybrid, xlstm
    fam = cfg.family
    if fam == "hybrid":
        n_seg, _, trailing = hybrid.segment_plan(cfg)
        layers = n_seg + trailing
    elif fam == "ssm":
        n_per, _, trailing = xlstm.layer_plan(cfg)
        layers = n_per + trailing
    elif fam == "audio":
        layers = cfg.n_enc_layers + cfg.n_layers
    else:
        layers = cfg.n_layers
    return layers + S // CHUNK


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_the_checkpointed_units_are_the_references(arch, monkeypatch):
    _, t_cfg, _, t_params, _, t_batch = Z.setup_arch(arch, overrides=(
        UNIT_OVERRIDES if t_get_config(arch).family in ("hybrid", "ssm")
        else None))
    counted = _Counted()
    monkeypatch.setattr(L._ckpt, "checkpoint", counted)
    _port_grad(t_cfg, t_params, t_batch)
    assert counted.calls == _units(t_cfg, Z.SEQ)
    if t_cfg.family in ("hybrid", "ssm"):
        assert t_cfg.n_layers == 3          # a segment and a trailing unit


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_gradient_equals_the_uncheckpointed_layers_bit_for_bit(
        arch, monkeypatch, policy):
    _, t_cfg, _, t_params, _, t_batch = Z.setup_arch(arch)
    full = _port_grad(t_cfg, t_params, t_batch)
    if arch in DOTS_ARCHS:
        policy("dots")
        dots = _port_grad(t_cfg, t_params, t_batch)
        assert all(torch.equal(a, b) for a, b in zip(dots, full))
        policy(None)
    monkeypatch.setattr(L, "remat", _plain_remat)
    plain = _port_grad(t_cfg, t_params, t_batch)
    assert all(torch.equal(a, b) for a, b in zip(full, plain))


# ---------------------------------------------------------------------------
# memory on meta (the dry run's measure)
# ---------------------------------------------------------------------------

# one config per family; widths reduced, the sequence long enough that a
# residual stream outweighs a layer's params (Whisper's decoder table holds
# 512 positions; the sLSTM steps one token at a time)
MEM_ARCHS = {"smollm-360m": 2048, "olmoe-1b-7b": 2048, "zamba2-1.2b": 2048,
             "whisper-large-v3": 512, "xlstm-350m": 256,
             "phi-3-vision-4.2b": 2048}
MEM_B = 2


def _meta_cfg(arch, units, **over):
    """The reduced f32 config of ``arch`` with ``units`` checkpointed units
    in its trunk (layers, segments, periods; Whisper's encoder and
    decoder layers each)."""
    cfg = t_get_config(arch).reduced().replace(param_dtype="float32",
                                               ssm_chunk=256, **over)
    if cfg.family == "hybrid":
        return cfg.replace(n_layers=units * cfg.attn_every)
    if cfg.family == "ssm":
        return cfg.replace(n_layers=units * cfg.slstm_every)
    if cfg.family == "audio":
        return cfg.replace(n_layers=units, n_enc_layers=units)
    return cfg.replace(n_layers=units)


def _meta_temp(cfg, S, loss_chunk, plain=False, monkeypatch=None):
    """(temp bytes of one loss gradient on ``meta``, param bytes)."""
    fam = t_get_family(cfg.family)
    params = fam.init_params(cfg, 0, device="meta")

    def meta(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device="meta")

    batch = {"tokens": meta(MEM_B, S, dtype=torch.int32),
             "labels": meta(MEM_B, S, dtype=torch.int32)}
    if cfg.family == "audio":
        batch["frames"] = meta(MEM_B, cfg.enc_frames, cfg.d_model)
    if cfg.family == "vlm":
        batch["patches"] = meta(MEM_B, cfg.n_patches, cfg.d_model)
    if plain:
        monkeypatch.setattr(L, "remat", _plain_remat)
    try:
        _, temp, _, _ = dryrun.measure(
            lambda: loss_grad(lambda p, b: fam.loss(
                p, b, cfg, loss_chunk=loss_chunk), params, batch), (), True)
    finally:
        if plain:
            monkeypatch.undo()
    return temp, sum(l.numel() * 4 for l in tree_leaves(params))


def _residual(cfg, S):
    """The bytes of one unit's residual stream(s): (B, S, D) f32, with
    Whisper's encoder frames beside its decoder tokens, the VLM's patches
    before its text."""
    if cfg.family == "audio":
        return MEM_B * (S + cfg.enc_frames) * cfg.d_model * 4
    if cfg.family == "vlm":
        return MEM_B * (S + cfg.n_patches) * cfg.d_model * 4
    return MEM_B * S * cfg.d_model * 4


@pytest.mark.parametrize("arch", list(MEM_ARCHS))
def test_temp_grows_by_one_residual_stream_per_unit(arch, monkeypatch):
    S, n = MEM_ARCHS[arch], 2
    (t1, p1), (t2, p2) = (_meta_temp(_meta_cfg(arch, u), S, S)
                          for u in (n, 2 * n))
    (q1, _), (q2, _) = (_meta_temp(_meta_cfg(arch, u), S, S, plain=True,
                                   monkeypatch=monkeypatch)
                        for u in (n, 2 * n))
    res = _residual(_meta_cfg(arch, n), S)
    grown, grads = t2 - t1, 2 * (p2 - p1)
    assert grown <= n * 1.1 * res + grads, (grown, res, grads)
    # without checkpointing every layer's activations stay
    assert q2 - q1 >= 10 * n * res


@pytest.mark.parametrize("arch", ["smollm-360m", "zamba2-1.2b"])
def test_temp_grows_by_no_chunk_logits_per_chunk(arch, monkeypatch):
    c = 32
    cfg = _meta_cfg(arch, 1, vocab=65536)
    logits = MEM_B * c * cfg.vocab * 4          # one chunk's f32 logits
    two, _ = _meta_temp(cfg, 2 * c, c)
    four, _ = _meta_temp(cfg, 4 * c, c)
    assert four - two < logits, (four - two, logits)
    p2, _ = _meta_temp(cfg, 2 * c, c, plain=True, monkeypatch=monkeypatch)
    p4, _ = _meta_temp(cfg, 4 * c, c, plain=True, monkeypatch=monkeypatch)
    assert p4 - p2 >= 2 * logits               # each chunk's logits kept


# ---------------------------------------------------------------------------
# serving takes no checkpoint
# ---------------------------------------------------------------------------

def _serve(fam, cfg, params, batch, grad):
    B, S = batch["tokens"].shape
    extra = cfg.n_patches if cfg.family == "vlm" else 0
    with torch.enable_grad() if grad else torch.no_grad():
        cache = fam.init_cache(cfg, B, S + 2, device="cpu")
        logits, cache = fam.prefill(params, batch, cfg, cache)
        tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
        pos = torch.full((B,), S + extra, dtype=torch.int32)
        step, _ = fam.decode_step(params, cache, tok, pos, cfg)
    return [logits, step] + tree_leaves(cache)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_serving_takes_no_checkpoint(arch, monkeypatch):
    _, t_cfg, _, t_params, _, t_batch = Z.setup_arch(arch)
    fam = t_get_family(t_cfg.family)
    batch = {k: v for k, v in t_batch.items() if k != "labels"}
    counted = _Counted()
    monkeypatch.setattr(L._ckpt, "checkpoint", counted)
    n_ssd, n_flash = ssd_scan.launches(), flash_attn.launches()
    got = [_serve(fam, t_cfg, t_params, batch, grad)
           for grad in (False, True)]
    assert counted.calls == 0
    assert (ssd_scan.launches(), flash_attn.launches()) == (n_ssd, n_flash)
    monkeypatch.setattr(L, "remat", _plain_remat)
    want = _serve(fam, t_cfg, t_params, batch, False)
    for outs in got:
        assert all(torch.equal(a, b) for a, b in zip(outs, want))


@pytest.mark.parametrize("arch", ["smollm-360m", "phi-3-vision-4.2b"])
def test_dry_run_flops_count_the_recompute(arch, monkeypatch, policy):
    """On ``meta`` (the dry run's count): full rematerialization adds one
    forward's products to the gradient's (every product of these
    families' loss lies in a unit) but each layer's MLP down projection:
    the recompute stops once it has rebuilt the last tensor the backward
    saved, and no backward saves that product's output.  ``"dots"`` adds
    less, its layers' 2-D products saved."""
    cfg = _meta_cfg(arch, 2)
    fam = t_get_family(cfg.family)
    params = fam.init_params(cfg, 0, device="meta")
    batch = {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
             for k, v in Z.setup_arch(arch)[5].items()}

    def grad_flops():
        return dryrun.measure(lambda: loss_grad(
            lambda p, b: fam.loss(p, b, cfg, loss_chunk=CHUNK), params,
            batch), (), True)[2]

    full = grad_flops()
    policy("dots")
    dots = grad_flops()
    policy(None)
    forward = dryrun.measure(lambda: fam.loss(params, batch, cfg,
                                              loss_chunk=CHUNK), (), False)[2]
    monkeypatch.setattr(L, "remat", _plain_remat)
    plain = grad_flops()
    rows = batch["tokens"].numel() + (batch["patches"].shape[:2].numel()
                                      if "patches" in batch else 0)
    down = 2 * rows * cfg.d_ff * cfg.d_model
    assert full == plain + forward - cfg.n_layers * down
    assert plain < dots < full
