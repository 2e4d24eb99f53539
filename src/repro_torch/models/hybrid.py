"""zamba2-style hybrid family (port of ``repro/models/hybrid.py``): Mamba2
backbone with a SHARED attention+MLP block applied every
``cfg.attn_every`` layers (one parameter set, reused — the zamba2
weight-sharing trick, arXiv:2411.15242).

Layer layout for n_layers=38, attn_every=6:
  6 segments of [6 x mamba2, shared_attn], then 2 trailing mamba2 layers.
Params keep the JAX package's stacked leaves: ``mamba_seg`` leaves are
(n_seg, seg_len, ...) and ``mamba_tail`` leaves (n_trailing, ...); the
JAX package's nested ``lax.scan``s over them are Python loops here.

Decode carries per-layer (conv_state, ssm_state) plus a KV cache for the
shared attention block applications (one cache slot per application).
Serving runs both of the port's CUDA kernels: every Mamba2 layer of
``prefill`` launches ``ssd_intra_chunk`` once, and every shared-block
application of ``decode_step`` launches ``flash_decode`` once.  On the
model axis (``launch/serve.py``) the cache holds this rank's blocks:
prefill writes this rank's block of each state and K/V it computes, and
decode steps them where they lie (``mamba2.mamba2_decode``,
``layers.decode_attention``).
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M
from repro_torch.models.base import Family, register_family


def segment_plan(cfg):
    """(n_segments, seg_len, n_trailing)."""
    if cfg.attn_every <= 0:
        return 0, 0, cfg.n_layers
    n_seg = cfg.n_layers // cfg.attn_every
    trailing = cfg.n_layers - n_seg * cfg.attn_every
    return n_seg, cfg.attn_every, trailing


def init_params(cfg, seed: int, device=None):
    """Random init from ``seed`` with a ``torch.Generator`` on the target
    device: the JAX package's shapes, dtypes and scales (``normal *
    fan_in**-0.5``, zeros, ones), each dict's leaves in sorted-key order
    and stacked layers one at a time."""
    gen = L.generator(seed, device)
    dev, dtype, D = gen.device, cfg.pdtype, cfg.d_model
    n_seg, seg_len, trailing = segment_plan(cfg)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=dev)

    makers = dict(
        embedding=lambda: L.init_embedding(gen, cfg.vocab, D, dtype),
        mamba_seg=lambda: L.draw_sorted(
            mix=lambda: L.stack_layers(lambda: M.init_mamba2(gen, cfg),
                                       (n_seg, seg_len))
            if n_seg else None,
            ln=lambda: zeros(n_seg, seg_len, D) if n_seg else None),
        # ONE shared attention+MLP block (zamba2 weight sharing)
        shared_attn=lambda: L.draw_sorted(
            attn=lambda: L.init_attention(gen, cfg),
            mlp=lambda: L.init_mlp(gen, D, cfg.d_ff, dtype, cfg.mlp_variant),
            ln_attn=lambda: zeros(D),
            ln_mlp=lambda: zeros(D)),
        mamba_tail=lambda: L.draw_sorted(
            mix=lambda: L.stack_layers(lambda: M.init_mamba2(gen, cfg),
                                       (trailing,))
            if trailing else None,
            ln=lambda: zeros(trailing, D) if trailing else None),
        ln_final=lambda: zeros(D),
    )
    if not cfg.tie_embeddings:
        makers["lm_head"] = lambda: L.init_embedding(gen, cfg.vocab, D, dtype)
    return L.draw_sorted(**makers)


def _mamba_layer(x, mix, ln, cfg):
    h = L.rms_norm(x, ln, cfg.norm_eps)
    out, new_state = M.mamba2_forward(h, mix, cfg)
    return x + out, new_state


def _shared_block(x, sp, cfg, positions, kv=None):
    h = L.rms_norm(x, sp["ln_attn"], cfg.norm_eps)
    x = x + L.attention(h, sp["attn"], cfg, positions, causal=True,
                        kv_override=kv)
    h = L.rms_norm(x, sp["ln_mlp"], cfg.norm_eps)
    return x + L.mlp(h, sp["mlp"], cfg.mlp_variant)


def _mamba_layers(params, cfg):
    """(segment or None, index, layer params, ln) in network order; the
    segment index is None for the trailing layers."""
    n_seg, seg_len, trailing = segment_plan(cfg)
    seg = L.whole_stack(params["mamba_seg"], (n_seg, seg_len))
    tail = L.whole_stack(params["mamba_tail"], (trailing,))
    for si in range(n_seg):
        for li in range(seg_len):
            yield (si, li, L.layer_slice(seg["mix"], si, li),
                   seg["ln"][si, li])
    for ti in range(trailing):
        yield (None, ti, L.layer_slice(tail["mix"], ti), tail["ln"][ti])


def _segment(x, layers, sp, cfg, positions):
    """One segment: its Mamba2 layers ((mix, ln) pairs), then the shared
    block."""
    for mix, ln in layers:
        x, _ = _mamba_layer(x, mix, ln, cfg)
    return _shared_block(x, sp, cfg, positions)


def _trailing(x, mix, ln, cfg):
    return _mamba_layer(x, mix, ln, cfg)[0]


def forward_hidden(params, batch, cfg):
    """The training forward (no cache): each segment (its Mamba2 layers
    and the shared block) and each trailing layer is a rematerialized unit
    under autograd (the JAX package's ``jax.checkpoint`` of its scan
    bodies)."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    positions = torch.arange(S, device=tokens.device).expand(B, S)
    x = L.embed(tokens, params["embedding"])
    n_seg, seg_len, _ = segment_plan(cfg)
    layers = [(mix, ln) for _, _, mix, ln in _mamba_layers(params, cfg)]
    for si in range(n_seg):
        x = L.remat(_segment, x, layers[si * seg_len:(si + 1) * seg_len],
                    params["shared_attn"], cfg, positions)
    for mix, ln in layers[n_seg * seg_len:]:
        x = L.remat(_trailing, x, mix, ln, cfg)
    return L.rms_norm(x, params["ln_final"], cfg.norm_eps)


def _head(params):
    return params.get("lm_head", params["embedding"])


def logits_fn(params, batch, cfg):
    h = forward_hidden(params, batch, cfg)
    return L.unembed(h, _head(params))


def loss(params, batch, cfg, *, loss_chunk: int = 512):
    """Mean next-token CE with sequence-chunked logits; trained through
    autograd (on the card the Mamba2 layers' ``ssd_intra_chunk`` is an
    ``autograd.Function``, :mod:`repro_torch.kernels.ssd_scan.ops`, which
    the backward's recompute of each unit launches again)."""
    h = forward_hidden(params, batch, cfg)
    return L.chunked_lm_loss(h, batch["labels"], _head(params),
                             loss_chunk=loss_chunk)


# ---------------------------------------------------------------------------
# decode: per-layer SSM states + KV cache per shared-attn application
# ---------------------------------------------------------------------------


def init_cache(cfg, batch_size, max_len, device=None):
    dev = resolve_device(device)
    n_seg, seg_len, trailing = segment_plan(cfg)
    conv, ssm = M.init_decode_state(cfg, batch_size, dev)

    def rep(x, *lead):
        return x.new_zeros(lead + tuple(x.shape))

    kv_shape = (n_seg, batch_size, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {
        "seg_conv": rep(conv, n_seg, seg_len) if n_seg else None,
        "seg_ssm": rep(ssm, n_seg, seg_len) if n_seg else None,
        "tail_conv": rep(conv, trailing) if trailing else None,
        "tail_ssm": rep(ssm, trailing) if trailing else None,
        # KV cache: one slot per shared-attention application
        "attn_k": torch.zeros(kv_shape, dtype=cfg.pdtype, device=dev)
        if n_seg else None,
        "attn_v": torch.zeros(kv_shape, dtype=cfg.pdtype, device=dev)
        if n_seg else None,
    }


def _state_slots(cache, si, li):
    """The (conv, ssm) cache leaves' slot of one Mamba2 layer (views)."""
    if si is None:
        return cache["tail_conv"][li], cache["tail_ssm"][li]
    return cache["seg_conv"][si, li], cache["seg_ssm"][si, li]


def prefill(params, batch, cfg, cache):
    """Prefill via the parallel path, then capture states for decode.

    For SSM layers the final ssm/conv states come from the chunked scan;
    for the shared attention block we store K/V of the full prefix.  The
    states are written into ``cache`` in place (the JAX package returns a
    new cache); the same dict is returned.
    """
    tokens = batch["tokens"]
    B, S = tokens.shape
    positions = torch.arange(S, device=tokens.device).expand(B, S)
    x = L.embed(tokens, params["embedding"])
    _, seg_len, _ = segment_plan(cfg)
    sp = params["shared_attn"]
    for si, li, mix, ln in _mamba_layers(params, cfg):
        x, (conv, ssm) = _mamba_layer(x, mix, ln, cfg)
        for slot, new in zip(_state_slots(cache, si, li), (conv, ssm)):
            slot.copy_(L.cache_block(new, slot))
        if si is not None and li == seg_len - 1:
            h = L.rms_norm(x, sp["ln_attn"], cfg.norm_eps)
            _, k, v = L._qkv(h, sp["attn"], cfg, positions)
            cache["attn_k"][si, :, :S] = L.kv_block(k, cache["attn_k"])
            cache["attn_v"][si, :, :S] = L.kv_block(v, cache["attn_v"])
            x = _shared_block(x, sp, cfg, positions, kv=(k, v, positions))

    h = L.rms_norm(x, params["ln_final"], cfg.norm_eps)
    logits = L.unembed(h[:, -1:], _head(params))
    return logits[:, 0], cache


def decode_step(params, cache, token, pos, cfg):
    """One token per row: token (B, 1), pos (B,) int32 -> (logits (B, V),
    cache).  The cache is updated in place (the JAX package's functional
    ``ck.at[batch_idx, pos].set(...)`` is an ``index_put_`` here) and the
    same dict is returned."""
    B = token.shape[0]
    x = L.embed(token, params["embedding"])
    positions = pos[:, None]
    batch_idx = torch.arange(B, device=token.device)
    pos_idx = pos.long()
    _, seg_len, _ = segment_plan(cfg)
    sp = params["shared_attn"]
    for si, li, mix, ln in _mamba_layers(params, cfg):
        slots = _state_slots(cache, si, li)
        h = L.rms_norm(x, ln, cfg.norm_eps)
        out, new_states = M.mamba2_decode(h, mix, cfg, slots)
        x = x + out
        for slot, new in zip(slots, new_states):
            slot.copy_(new)
        if si is not None and li == seg_len - 1:
            h = L.rms_norm(x, sp["ln_attn"], cfg.norm_eps)
            q, k, v = L._qkv(h, sp["attn"], cfg, positions)
            ck, cv = cache["attn_k"][si], cache["attn_v"][si]
            L.cache_write(ck, cv, k, v, (batch_idx, pos_idx))
            x = x + L.decode_attention(q, sp["attn"], ck, cv, pos, cfg)
            h = L.rms_norm(x, sp["ln_mlp"], cfg.norm_eps)
            x = x + L.mlp(h, sp["mlp"], cfg.mlp_variant)

    h = L.rms_norm(x, params["ln_final"], cfg.norm_eps)
    logits = L.unembed(h, _head(params))
    return logits[:, 0], cache


register_family(
    Family(
        name="hybrid",
        init_params=init_params,
        forward=logits_fn,
        loss=loss,
        init_cache=init_cache,
        prefill=prefill,
        decode_step=decode_step,
    )
)
