"""phi-3-vision family (port of ``repro/models/vlm.py``): the phi3-mini
language backbone consuming stubbed vision embeddings.

The ViT/CLIP encoder + projector is a STUB: ``input_specs`` provides
pre-projected patch embeddings (B, n_patches, d_model).  The LM backbone
— attention, RoPE, SwiGLU MLP, the cross-modal token interleave (patch
prefix + text) — is the dense transformer's (:mod:`.transformer`).

Sequence layout: [patch_0 .. patch_{P-1}, tok_0 .. tok_{S-1}], positions
are global (0..P+S-1); training loss is computed on text positions only.
The logits take no final softcap.  phi-3's head dim is 3072 / 32 = 96,
which ``flash_decode`` serves unpadded.
"""
from __future__ import annotations

import torch

from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.base import Family, register_family

init_params = T.init_params  # backbone only; patches arrive pre-projected


def _prefix_embed(params, batch, cfg):
    tokens, patches = batch["tokens"], batch["patches"]
    B, S = tokens.shape
    P = patches.shape[1]
    tok_emb = L.embed(tokens, params["embedding"])
    x = torch.cat([patches.to(tok_emb.dtype), tok_emb], dim=1)
    positions = torch.arange(P + S, device=tokens.device).expand(B, P + S)
    return x, positions, P


def forward_hidden(params, batch, cfg):
    x, positions, P = _prefix_embed(params, batch, cfg)
    h = T.trunk(params, x, cfg, positions)
    return h, P


def logits_fn(params, batch, cfg):
    h, P = forward_hidden(params, batch, cfg)
    return L.unembed(h[:, P:], T._lm_matrix(params))


def loss(params, batch, cfg, *, loss_chunk: int = 512):
    """CE over TEXT positions only (patch positions carry no labels); as
    in the JAX package, text past the last whole chunk of
    ``min(loss_chunk, S)`` tokens is left out."""
    h, P = forward_hidden(params, batch, cfg)
    h, labels = h[:, P:], batch["labels"]
    S = h.shape[1]
    chunk = min(loss_chunk, S)
    n = max(1, S // chunk) * chunk
    return L.chunked_lm_loss(h[:, :n], labels[:, :n], T._lm_matrix(params),
                             loss_chunk=loss_chunk)


def init_cache(cfg, batch_size, max_len, device=None):
    # cache must also hold the patch-prefix KV
    return T.init_cache(cfg, batch_size, max_len + cfg.n_patches, device)


def prefill(params, batch, cfg, cache):
    x, positions, _ = _prefix_embed(params, batch, cfg)
    h = T.prefill_trunk(params, x, positions, cfg, cache)
    logits = L.unembed(h[:, -1:], T._lm_matrix(params))
    return logits[:, 0], cache


def decode_step(params, cache, token, pos, cfg):
    """pos is the GLOBAL position (patch prefix included by the caller)."""
    return T.decode_step(params, cache, token, pos, cfg)


register_family(
    Family(
        name="vlm",
        init_params=init_params,
        forward=logits_fn,
        loss=loss,
        init_cache=init_cache,
        prefill=prefill,
        decode_step=decode_step,
    )
)
