"""Whisper-style encoder-decoder family (audio; port of
``repro/models/whisper.py``).

The mel-spectrogram + conv feature extractor is a STUB: ``input_specs``
provides precomputed frame embeddings (B, enc_frames, d_model).
Everything downstream — the bidirectional encoder, the causal decoder
with cross-attention, sinusoidal/learned positions — is implemented in
full, with the JAX package's differences from the original: RMSNorm
without biases instead of LayerNorm+bias, and a decoder position table
sized by ``cfg.max_seq``.  No attention here applies RoPE.

Decode runs ``flash_decode`` twice per decoder layer on the card: the
self-attention over the decoder's KV cache, and the cross-attention over
the encoder's cached K/V with ``pos = F - 1`` over S = F frames (every
frame visible).

On the model axis (:mod:`repro_torch.models.layers`' mesh context) the
encoder, the decoder's self-attention and its cross-attention run
:func:`repro_torch.models.layers.attention` and ``mlp`` on their blocks;
the cross-attention's K/V come whole from the encoder's output on every
rank, and a position table cut on its rows (``pos_dec`` at the reduced
sizes, where ``max_seq`` equals the vocab) is read whole.  Serving on
the model axis (``launch/serve.py``) keeps this rank's blocks of the
self and the cross K/V caches, cut as the other families' KV caches,
and decodes both through ``layers.decode_attention``.
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.base import Family, register_family


def _sinusoidal(length: int, d: int, device=None):
    pos = torch.arange(length, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(d // 2, dtype=torch.float32, device=device)[None, :]
    angle = pos / torch.pow(torch.tensor(10000.0, device=device), 2 * dim / d)
    return torch.cat([torch.sin(angle), torch.cos(angle)], -1)


def init_params(cfg, seed: int, device=None):
    gen = L.generator(seed, device)
    dev, dtype, D = gen.device, cfg.pdtype, cfg.d_model

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=dev)

    def enc_layer():
        return L.draw_sorted(
            attn=lambda: L.init_attention(gen, cfg),
            mlp=lambda: L.init_mlp(gen, D, cfg.d_ff, dtype, "gelu"),
            ln_attn=lambda: zeros(D),
            ln_mlp=lambda: zeros(D))

    def dec_layer():
        return L.draw_sorted(
            attn=lambda: L.init_attention(gen, cfg),
            xattn=lambda: L.init_attention(gen, cfg),
            mlp=lambda: L.init_mlp(gen, D, cfg.d_ff, dtype, "gelu"),
            ln_attn=lambda: zeros(D),
            ln_xattn=lambda: zeros(D),
            ln_mlp=lambda: zeros(D))

    return L.draw_sorted(
        embedding=lambda: L.init_embedding(gen, cfg.vocab, D, dtype),
        pos_dec=lambda: L.dense_init(gen, (cfg.max_seq, D), dtype, fan_in=D),
        enc=lambda: L.stack_layers(enc_layer, (cfg.n_enc_layers,)),
        dec=lambda: L.stack_layers(dec_layer, (cfg.n_layers,)),
        ln_enc_final=lambda: zeros(D),
        ln_final=lambda: zeros(D),
    )


def _positions(B, S, device):
    return torch.arange(S, device=device).expand(B, S)


def encode(params, frames, cfg):
    """frames: (B, F, D) stub embeddings -> encoder states; under autograd
    each encoder layer is a rematerialized unit."""
    B, Fr, D = frames.shape
    x = frames + _sinusoidal(Fr, D, frames.device).to(frames.dtype)
    positions = _positions(B, Fr, frames.device)
    enc = L.whole_stack(params["enc"], (cfg.n_enc_layers,))
    for i in range(cfg.n_enc_layers):
        x = L.remat(_enc_layer, x, L.layer_slice(enc, i), cfg, positions)
    return L.rms_norm(x, params["ln_enc_final"], cfg.norm_eps)


def _enc_layer(x, blk, cfg, positions):
    h = L.rms_norm(x, blk["ln_attn"], cfg.norm_eps)
    x = x + L.attention(h, blk["attn"], cfg, positions, causal=False,
                        rope=False)
    h = L.rms_norm(x, blk["ln_mlp"], cfg.norm_eps)
    return x + L.mlp(h, blk["mlp"], "gelu")


def _dec_layer(x, blk, cfg, positions, enc_out, enc_pos):
    """One decoder layer -> (x, self k, self v, cross k, cross v)."""
    h = L.rms_norm(x, blk["ln_attn"], cfg.norm_eps)
    _, k, v = L._qkv(h, blk["attn"], cfg, positions, rope=False)
    x = x + L.attention(h, blk["attn"], cfg, positions, causal=True,
                        rope=False, kv_override=(k, v, positions))
    h = L.rms_norm(x, blk["ln_xattn"], cfg.norm_eps)
    xk, xv = L._in_projs(enc_out, blk["xattn"], cfg, ("wk", "wv"))
    x = x + L.attention(h, blk["xattn"], cfg, positions, causal=False,
                        rope=False, kv_override=(xk, xv, enc_pos))
    h = L.rms_norm(x, blk["ln_mlp"], cfg.norm_eps)
    return x + L.mlp(h, blk["mlp"], "gelu"), k, v, xk, xv


def _dec_layer_x(x, blk, cfg, positions, enc_out, enc_pos):
    return _dec_layer(x, blk, cfg, positions, enc_out, enc_pos)[0]


def _dec_trunk(params, x, cfg, positions, enc_out, enc_pos, cache=None):
    """The decoder layers; with ``cache``, each layer's self K/V (positions
    0..S-1) and cross K/V are written into it in place.  Without one (the
    training forward) each layer is a rematerialized unit under autograd;
    a layer that writes the cache never is."""
    S = x.shape[1]
    dec = L.whole_stack(params["dec"], (cfg.n_layers,))
    for i in range(cfg.n_layers):
        blk = L.layer_slice(dec, i)
        if cache is None:
            x = L.remat(_dec_layer_x, x, blk, cfg, positions, enc_out,
                        enc_pos)
            continue
        x, k, v, xk, xv = _dec_layer(x, blk, cfg, positions, enc_out,
                                     enc_pos)
        cache["k"][i, :, :S] = L.kv_block(k, cache["k"])
        cache["v"][i, :, :S] = L.kv_block(v, cache["v"])
        cache["xk"][i] = L.kv_block(xk, cache["xk"])
        cache["xv"][i] = L.kv_block(xv, cache["xv"])
    return L.rms_norm(x, params["ln_final"], cfg.norm_eps)


def forward_hidden(params, batch, cfg, cache=None):
    tokens, frames = batch["tokens"], batch["frames"]
    B, S = tokens.shape
    enc_out = encode(params, frames, cfg)
    enc_pos = _positions(B, enc_out.shape[1], tokens.device)
    pos_dec = L.whole(params["pos_dec"], (cfg.max_seq, cfg.d_model))
    x = L.embed(tokens, params["embedding"]) + pos_dec[:S]
    return _dec_trunk(params, x, cfg, _positions(B, S, tokens.device),
                      enc_out, enc_pos, cache)


def logits_fn(params, batch, cfg):
    h = forward_hidden(params, batch, cfg)
    return L.unembed(h, params["embedding"])


def loss(params, batch, cfg, *, loss_chunk: int = 512):
    h = forward_hidden(params, batch, cfg)
    return L.chunked_lm_loss(h, batch["labels"], params["embedding"],
                             loss_chunk=min(loss_chunk, h.shape[1]))


def init_cache(cfg, batch_size, max_len, device=None):
    dev = resolve_device(device)
    n, H, Dh = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim

    def zeros(length):
        return torch.zeros((n, batch_size, length, H, Dh), dtype=cfg.pdtype,
                           device=dev)

    return {"k": zeros(max_len), "v": zeros(max_len),
            "xk": zeros(cfg.enc_frames), "xv": zeros(cfg.enc_frames)}


def prefill(params, batch, cfg, cache):
    """Encode the frames and run the decoder over the prompt tokens,
    filling the self and cross K/V of ``cache`` in place."""
    h = forward_hidden(params, batch, cfg, cache)
    logits = L.unembed(h[:, -1:], params["embedding"])
    return logits[:, 0], cache


def decode_step(params, cache, token, pos, cfg):
    """Decoder-only step; cross-attention reads the cached encoder KV."""
    B = token.shape[0]
    idx = (torch.arange(B, device=token.device), pos.long())
    pos_dec = L.whole(params["pos_dec"], (cfg.max_seq, cfg.d_model))
    x = L.embed(token, params["embedding"]) + pos_dec[idx[1]][:, None]
    Fr = cache["xk"].shape[2]
    last = torch.full((B,), Fr - 1, dtype=torch.int32, device=token.device)
    dec = L.whole_stack(params["dec"], (cfg.n_layers,))
    for i in range(cfg.n_layers):
        blk = L.layer_slice(dec, i)
        h = L.rms_norm(x, blk["ln_attn"], cfg.norm_eps)
        q, k, v = L._qkv(h, blk["attn"], cfg, None, rope=False)
        ck, cv = cache["k"][i], cache["v"][i]
        L.cache_write(ck, cv, k, v, idx)
        x = x + L.decode_attention(q, blk["attn"], ck, cv, pos, cfg)
        h = L.rms_norm(x, blk["ln_xattn"], cfg.norm_eps)
        (xq,) = L._in_projs(h, blk["xattn"], cfg, ("wq",))
        # cross attention: all encoder frames visible
        x = x + L.decode_attention(xq, blk["xattn"], cache["xk"][i],
                                   cache["xv"][i], last, cfg)
        h = L.rms_norm(x, blk["ln_mlp"], cfg.norm_eps)
        x = x + L.mlp(h, blk["mlp"], "gelu")
    h = L.rms_norm(x, params["ln_final"], cfg.norm_eps)
    return L.unembed(h, params["embedding"])[:, 0], cache


register_family(
    Family(
        name="audio",
        init_params=init_params,
        forward=logits_fn,
        loss=loss,
        init_cache=init_cache,
        prefill=prefill,
        decode_step=decode_step,
    )
)
