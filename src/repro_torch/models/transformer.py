"""Dense decoder-only transformer family (port of
``repro/models/transformer.py``): llama3.2 / gemma2 / smollm /
deepseek-coder, and the backbone of the VLM family.

Implementation notes
--------------------
* Params keep the JAX package's stacked leaves (leading L dim); the JAX
  package's ``lax.scan`` over layers is a Python loop over views of one
  layer each (:func:`repro_torch.models.layers.layer_slice`).  Stacked
  layers are drawn one at a time into preallocated leaves: deepseek's
  ``w_up`` stack drawn at once in f32 would be 34 GB.
* **gemma2 options**: alternating local(window)/global attention driven by
  a per-layer window list; attention-logit softcap; final-logit softcap;
  post-norms (sandwich); embedding scaled by sqrt(d_model) in the param
  dtype; tied embeddings.  The windows are a Python list of ints, never
  a tensor: ``flash_decode`` takes the window as an int, and a tensor
  would cost a host sync per layer per step.
* **Rematerialization**: each layer of :func:`trunk` is a checkpointed
  unit (``layers.remat``, the JAX package's ``jax.checkpoint`` of its scan
  body) under the policy :func:`set_remat_policy` picks: full (the
  default), or ``"dots"``, which saves the 2-D matrix products.  The
  policy applies to this trunk only (the dense and VLM families), as in
  the JAX package.
* **Chunked CE loss**: the (B, S, V) logits tensor is never materialized
  (vocab up to 256 000), each chunk rematerialized in the backward; its
  value and its gradient (autograd) are held to the JAX package's loss
  and ``jax.grad``.
* ``prefill`` fills the preallocated KV cache in place and returns (last
  logits, cache); ``decode_step`` writes one position per row in place
  and launches ``flash_decode`` once per layer on the card.  On the
  model axis the cache holds this rank's blocks (``launch/serve.py``):
  each layer writes its block of the whole K/V and attends through
  ``layers.decode_attention``.
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.base import Family, register_family

# the remat-policy knob (the JAX package's; the dry run's --remat-policy):
# None rematerializes each layer whole, "dots" saves its 2-D matrix
# products (jax.checkpoint_policies.dots_with_no_batch_dims_saveable)
_REMAT = {"policy": None}


def set_remat_policy(name):
    _REMAT["policy"] = "dots" if name == "dots" else None


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------


def init_params(cfg, seed: int, device=None):
    """Random init from ``seed`` on the target device: the JAX package's
    tree, shapes, dtypes and scales; each dict's leaves in sorted-key
    order, stacked layers one at a time."""
    gen = L.generator(seed, device)
    dev, dtype, D, n = gen.device, cfg.pdtype, cfg.d_model, cfg.n_layers

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=dev)

    blocks = dict(
        attn=lambda: L.stack_layers(lambda: L.init_attention(gen, cfg), (n,)),
        mlp=lambda: L.stack_layers(
            lambda: L.init_mlp(gen, D, cfg.d_ff, dtype, cfg.mlp_variant),
            (n,)),
        ln_attn=lambda: zeros(n, D),
        ln_mlp=lambda: zeros(n, D),
    )
    if cfg.local_global_pattern:  # gemma2 sandwich norms
        blocks["ln_attn_post"] = lambda: zeros(n, D)
        blocks["ln_mlp_post"] = lambda: zeros(n, D)
    makers = dict(
        embedding=lambda: L.init_embedding(gen, cfg.vocab, D, dtype),
        blocks=lambda: L.draw_sorted(**blocks),
        ln_final=lambda: zeros(D),
    )
    if not cfg.tie_embeddings:
        makers["lm_head"] = lambda: L.init_embedding(gen, cfg.vocab, D, dtype)
    return L.draw_sorted(**makers)


def layer_windows(cfg) -> list:
    """Per-layer sliding window sizes (Python ints). 0 = full attention.

    gemma2: even layers local (sliding_window), odd layers global — unless
    the config forces all-local (``sliding_window`` with no pattern), which
    is the long_500k variant.
    """
    if cfg.local_global_pattern:
        return [cfg.sliding_window if i % 2 == 0 else 0
                for i in range(cfg.n_layers)]
    return [cfg.sliding_window] * cfg.n_layers


def layers(params, cfg):
    """(index, layer params, window) in network order."""
    blocks = L.whole_stack(params["blocks"], (cfg.n_layers,))
    for i, window in enumerate(layer_windows(cfg)):
        yield i, L.layer_slice(blocks, i), window


# ---------------------------------------------------------------------------
# trunk
# ---------------------------------------------------------------------------


def _post(out, blk, name, cfg):
    """gemma2's sandwich norm where the block has one."""
    return L.rms_norm(out, blk[name], cfg.norm_eps) if name in blk else out


def _block(x, blk, window, cfg, positions, kv=None):
    h = L.rms_norm(x, blk["ln_attn"], cfg.norm_eps)
    attn_out = L.attention(h, blk["attn"], cfg, positions, window=window,
                           causal=True, kv_override=kv)
    x = x + _post(attn_out, blk, "ln_attn_post", cfg)
    h = L.rms_norm(x, blk["ln_mlp"], cfg.norm_eps)
    mlp_out = L.mlp(h, blk["mlp"], cfg.mlp_variant)
    return x + _post(mlp_out, blk, "ln_mlp_post", cfg)


def trunk(params, x, cfg, positions):
    """x: (B, S, D) embedded input -> final hidden states; under autograd
    each layer is rematerialized under the current policy."""
    for _, blk, window in layers(params, cfg):
        x = L.remat(_block, x, blk, window, cfg, positions,
                    policy=_REMAT["policy"])
    return L.rms_norm(x, params["ln_final"], cfg.norm_eps)


def embed_tokens(params, tokens, cfg):
    x = L.embed(tokens, params["embedding"])
    if cfg.local_global_pattern:  # gemma scales embeddings (param dtype)
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    return x


def _lm_matrix(params):
    return params.get("lm_head", params["embedding"])


def _positions(B, S, device):
    return torch.arange(S, device=device).expand(B, S)


def forward_hidden(params, batch, cfg):
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = embed_tokens(params, tokens, cfg)
    return trunk(params, x, cfg, _positions(B, S, tokens.device))


def logits_fn(params, batch, cfg):
    h = forward_hidden(params, batch, cfg)
    return L.unembed(h, _lm_matrix(params), cfg.final_logit_softcap)


def loss(params, batch, cfg, *, loss_chunk: int = 512):
    """Mean next-token CE with sequence-chunked logits."""
    h = forward_hidden(params, batch, cfg)
    return L.chunked_lm_loss(h, batch["labels"], _lm_matrix(params),
                             cfg.final_logit_softcap, loss_chunk)


# ---------------------------------------------------------------------------
# KV cache / prefill / decode
# ---------------------------------------------------------------------------


def init_cache(cfg, batch_size, max_len, device=None):
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch_size, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=cfg.pdtype, device=dev),
            "v": torch.zeros(shape, dtype=cfg.pdtype, device=dev)}


def prefill_trunk(params, x, positions, cfg, cache):
    """The layers over an embedded prompt x (B, S, D), each layer's K/V
    written into ``cache`` positions 0..S-1 in place -> final hidden
    states (the VLM family's prefill too)."""
    S = x.shape[1]
    for i, blk, window in layers(params, cfg):
        h = L.rms_norm(x, blk["ln_attn"], cfg.norm_eps)
        _, k, v = L._qkv(h, blk["attn"], cfg, positions)
        cache["k"][i, :, :S] = L.kv_block(k, cache["k"])
        cache["v"][i, :, :S] = L.kv_block(v, cache["v"])
        x = _block(x, blk, window, cfg, positions, kv=(k, v, positions))
    return L.rms_norm(x, params["ln_final"], cfg.norm_eps)


def prefill(params, batch, cfg, cache):
    """Fill the cache for tokens (B, S); return (last logits, cache).  The
    cache is written in place (the JAX package returns a new one) and the
    same dict is returned."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = embed_tokens(params, tokens, cfg)
    h = prefill_trunk(params, x, _positions(B, S, tokens.device), cfg, cache)
    logits = L.unembed(h[:, -1:], _lm_matrix(params), cfg.final_logit_softcap)
    return logits[:, 0], cache


def decode_attn(x, blk, cfg, cache, i, pos, window=0):
    """One layer's self-attention for one token per row: rotate q and k
    at ``pos``, write k and v into layer ``i``'s cache slot at ``pos`` in
    place (the JAX package's ``ck.at[batch_idx, pos].set``), attend with
    ``flash_decode``.  x is the normed input (B, 1, D)."""
    B = x.shape[0]
    q, k, v = L._qkv(x, blk["attn"], cfg, pos[:, None])
    idx = (torch.arange(B, device=x.device), pos.long())
    ck, cv = cache["k"][i], cache["v"][i]
    L.cache_write(ck, cv, k, v, idx)
    return L.decode_attention(q, blk["attn"], ck, cv, pos, cfg, window=window)


def decode_step(params, cache, token, pos, cfg):
    """One decode step: token (B, 1), pos (B,) int32.  Returns (logits,
    cache), the cache updated in place."""
    x = embed_tokens(params, token, cfg)                    # (B, 1, D)
    for i, blk, window in layers(params, cfg):
        h = L.rms_norm(x, blk["ln_attn"], cfg.norm_eps)
        attn_out = decode_attn(h, blk, cfg, cache, i, pos, window)
        x = x + _post(attn_out, blk, "ln_attn_post", cfg)
        h2 = L.rms_norm(x, blk["ln_mlp"], cfg.norm_eps)
        mlp_out = L.mlp(h2, blk["mlp"], cfg.mlp_variant)
        x = x + _post(mlp_out, blk, "ln_mlp_post", cfg)
    h = L.rms_norm(x, params["ln_final"], cfg.norm_eps)
    logits = L.unembed(h, _lm_matrix(params), cfg.final_logit_softcap)
    return logits[:, 0], cache


register_family(
    Family(
        name="dense",
        init_params=init_params,
        forward=logits_fn,
        loss=loss,
        init_cache=init_cache,
        prefill=prefill,
        decode_step=decode_step,
    )
)
