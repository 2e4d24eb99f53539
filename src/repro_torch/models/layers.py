"""Shared model building blocks (port of ``repro/models/layers.py``):
norms, RoPE, GQA attention (sliding window + logit softcap), the one-token
decode attention, gated MLPs, embeddings and the cross-entropy losses.

Conventions (the JAX package's, kept at the public surface)
-----------------------------------------------------------
* Parameter layouts keep head / ff dims explicit: wq (D, H, Dh),
  wk/wv (D, Hkv, Dh), wo (H, Dh, D), mlp w_gate/w_up (D, F),
  w_down (F, D), embedding (V, D).
* Activations are in the param dtype; normalization and softmax
  accumulate in f32, and every matrix product rounds its output to the
  operands' dtype, as the JAX package's einsums do.
* Initializers draw from an explicit ``torch.Generator`` on the target
  device, each dict's leaves in sorted-key order (:func:`draw_sorted`),
  stacked layers one at a time (:func:`stack_layers`).  On the ``meta``
  device (shapes only) there is no generator and nothing is drawn.
  The JAX package's ``shard()`` and mesh context have no counterpart:
  there is no mesh on one card.
"""
from __future__ import annotations

import itertools

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.kernels.flash_attn import ops as flash_ops
from repro_torch.pytree import tree_map

# ---------------------------------------------------------------------------
# initializers
# ---------------------------------------------------------------------------


class MetaGenerator:
    """Stands in for a ``torch.Generator`` on the ``meta`` device, which
    has none: initializers then make shapes and dtypes only."""

    device = torch.device("meta")


def generator(seed: int, device=None):
    """The init generator of an entry point: ``seed`` on the resolved
    device (the card unless the caller passes another)."""
    dev = resolve_device(device)
    if dev.type == "meta":
        return MetaGenerator()
    return torch.Generator(dev).manual_seed(seed)


def dense_init(gen, shape, dtype, fan_in=None):
    """``normal * fan_in**-0.5`` drawn in f32 on ``gen``'s device."""
    fan_in = fan_in or shape[0]
    scale = (1.0 / fan_in) ** 0.5
    g = gen if isinstance(gen, torch.Generator) else None
    return (torch.randn(tuple(shape), generator=g, device=gen.device,
                        dtype=torch.float32) * scale).to(dtype)


def draw_sorted(**makers):
    """Build a param dict, calling each leaf's maker in sorted-key order
    (the order ``jax.tree_util`` flattens a dict in), so a seed fixes
    every leaf whatever order the caller lists them in."""
    return {k: makers[k]() for k in sorted(makers)}


def stack_layers(make, lead):
    """``make()``'s (nested) param dict stacked on the leading dims
    ``lead``: the layers are drawn one at a time, in index order, into
    preallocated leaves, so no second copy of the stack (and no f32 copy
    of a bf16 one) is ever held.  The JAX package's vmapped init of
    stacked leaves."""
    out = None
    for idx in itertools.product(*map(range, lead)):
        layer = make()
        if out is None:
            out = tree_map(lambda v: torch.empty(
                tuple(lead) + tuple(v.shape), dtype=v.dtype,
                device=v.device), layer)
        _copy_into(out, layer, idx)
    return out


def _copy_into(out, layer, idx):
    for k, v in layer.items():
        if isinstance(v, dict):
            _copy_into(out[k], v, idx)
        else:
            out[k][idx] = v


def layer_slice(tree, *idx):
    """One layer's params out of stacked leaves (views, no copies)."""
    return tree_map(lambda v: v[idx], tree)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def rms_norm(x, scale, eps=1e-6):
    x32 = x.float()
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.float())).to(x.dtype)


def layer_norm(x, scale, bias, eps=1e-5):
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = x32.var(-1, unbiased=False, keepdim=True)
    out = (x32 - mu) * torch.rsqrt(var + eps)
    return (out * scale + bias).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_freqs(d_head: int, theta: float, device=None):
    return theta ** (-torch.arange(0, d_head, 2, dtype=torch.float32,
                                   device=device) / d_head)


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, Dh); positions: (..., S)."""
    d_head = x.shape[-1]
    freqs = rope_freqs(d_head, theta, x.device)              # (Dh/2,)
    angles = positions[..., :, None].float()[..., None, :] * freqs
    # angles: (..., S, 1, Dh/2) broadcast over heads
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


def _proj(x, w):
    """x (..., D) times w (D, *out) -> (..., *out): the JAX package's
    ``einsum("bsd,d...->bs...")`` as one matrix product."""
    return torch.matmul(x, w.reshape(w.shape[0], -1)).reshape(
        x.shape[:-1] + w.shape[1:])


def _out_proj(o, wo):
    """o (B, S, H, Dh) times wo (H, Dh, D) -> (B, S, D)."""
    return torch.matmul(o.reshape(o.shape[:2] + (-1,)),
                        wo.reshape(-1, wo.shape[-1]))


def init_attention(gen, cfg):
    dtype = cfg.pdtype
    D, H, Hkv, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return draw_sorted(
        wq=lambda: dense_init(gen, (D, H, Dh), dtype, fan_in=D),
        wk=lambda: dense_init(gen, (D, Hkv, Dh), dtype, fan_in=D),
        wv=lambda: dense_init(gen, (D, Hkv, Dh), dtype, fan_in=D),
        wo=lambda: dense_init(gen, (H, Dh, D), dtype, fan_in=H * Dh),
    )


def _softcap(x, cap: float):
    return torch.tanh(x / cap) * cap if cap > 0 else x


def _qkv(x, p, cfg, positions, rope=True):
    q, k, v = _proj(x, p["wq"]), _proj(x, p["wk"]), _proj(x, p["wv"])
    if rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def attention(
    x,
    p,
    cfg,
    positions=None,
    *,
    window: int = 0,
    causal: bool = True,
    q_chunk: int = 1024,
    rope: bool = True,
    kv_override=None,          # (k, v, kv_positions) for cross-attention
):
    """Exact attention, q-chunked for memory (a loop over query chunks).

    x: (B, S, D) -> (B, S, D).  ``window`` > 0 masks keys older than
    ``window`` positions (sliding-window attention).  Plain PyTorch
    (matrix products and an f32 softmax), as the JAX package leaves it
    to XLA outside any Pallas kernel.  ``rope=False`` (Whisper) applies
    no rotary embedding; with ``kv_override`` only q is rotated.
    """
    B, S, D = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device).expand(B, S)
    if kv_override is None:
        q, k, v = _qkv(x, p, cfg, positions, rope=rope)
        kv_pos = positions
    else:
        q = _proj(x, p["wq"])
        if rope:
            q = apply_rope(q, positions, cfg.rope_theta)
        k, v, kv_pos = kv_override

    H, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    rep = H // Hkv
    scale = Dh ** -0.5
    kk = torch.repeat_interleave(k, rep, dim=2) if rep > 1 else k
    vv = torch.repeat_interleave(v, rep, dim=2) if rep > 1 else v
    k_t = kk.permute(0, 2, 3, 1)                          # (B, H, Dh, Skv)
    v_t = vv.permute(0, 2, 1, 3)                          # (B, H, Skv, Dh)
    # 0 (or any non-positive) window means "no window"
    eff_w = window if window > 0 else 1 << 30

    def attend_chunk(q_c, qpos_c):
        # q_c: (B, Cq, H, Dh)
        logits = torch.matmul(q_c.permute(0, 2, 1, 3), k_t).float() * scale
        logits = _softcap(logits, cfg.attn_logit_softcap)
        dq = qpos_c[:, :, None]           # (B, Cq, 1)
        dk = kv_pos[:, None, :]           # (B, 1, Skv)
        mask = dk > dq - eff_w
        if causal:
            mask = mask & (dk <= dq)
        logits = logits.masked_fill_(~mask[:, None], -1e30)
        probs = torch.softmax(logits, dim=-1).to(x.dtype)
        return torch.matmul(probs, v_t).permute(0, 2, 1, 3)  # (B, Cq, H, Dh)

    # pick the largest divisor of S that fits the target chunk (S=1500
    # whisper frames, S=4672 vlm patch+text, ... are not 1024-divisible)
    eff_chunk = q_chunk
    while eff_chunk > 1 and S % eff_chunk:
        eff_chunk -= 1
    if S <= q_chunk or eff_chunk < 64:
        o = attend_chunk(q, positions)
    else:
        o = torch.cat([attend_chunk(q[:, i:i + eff_chunk],
                                    positions[:, i:i + eff_chunk])
                       for i in range(0, S, eff_chunk)], dim=1)
    return _out_proj(o, p["wo"])


def decode_attention(q, p, cache_k, cache_v, pos, cfg, *, window: int = 0):
    """One-token decode: q (B, 1, H, Dh) against cache (B, L, Hkv, Dh).

    ``pos`` (B,) int32 is the current position; cache positions are
    0..L-1 and entries > pos (or outside the window) are masked.  The
    attention itself is :func:`repro_torch.kernels.flash_attn.ops.
    flash_decode`: the ``flash_decode`` CUDA kernel on the card, its plain
    version on the CPU.
    """
    o = flash_ops.flash_decode(q[:, 0], cache_k, cache_v, pos, window=window,
                               softcap=cfg.attn_logit_softcap)
    return _out_proj(o[:, None], p["wo"])


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


def init_mlp(gen, d_model, d_ff, dtype, variant="swiglu"):
    makers = dict(
        w_up=lambda: dense_init(gen, (d_model, d_ff), dtype),
        w_down=lambda: dense_init(gen, (d_ff, d_model), dtype, fan_in=d_ff),
    )
    if variant in ("swiglu", "geglu"):
        makers["w_gate"] = lambda: dense_init(gen, (d_model, d_ff), dtype)
    return draw_sorted(**makers)


def mlp(x, p, variant="swiglu"):
    up = torch.matmul(x, p["w_up"])
    if variant == "swiglu":
        h = F.silu(torch.matmul(x, p["w_gate"])) * up
    elif variant == "geglu":
        # jax.nn.gelu's default is the tanh approximation
        h = F.gelu(torch.matmul(x, p["w_gate"]), approximate="tanh") * up
    else:
        h = F.gelu(up, approximate="tanh")
    return torch.matmul(h, p["w_down"])


# ---------------------------------------------------------------------------
# embedding / unembedding
# ---------------------------------------------------------------------------


def init_embedding(gen, vocab, d_model, dtype):
    return dense_init(gen, (vocab, d_model), dtype, fan_in=d_model)


def embed(tokens, emb):
    return F.embedding(tokens, emb)


def unembed(x, emb_or_head, softcap: float = 0.0):
    logits = torch.matmul(x, emb_or_head.t()).float()
    return _softcap(logits, softcap)


def cross_entropy_loss(logits, labels, vocab: int):
    """Mean next-token CE.  logits (B,S,V) f32, labels (B,S)."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return torch.mean(logz - gold)


def chunked_lm_loss(h, labels, W, softcap: float = 0.0,
                    loss_chunk: int = 512):
    """Mean next-token CE with sequence-chunked logits, as every family of
    the JAX package writes it: ``max(1, S // loss_chunk)`` chunks of equal
    length (S must divide into them), each chunk's mean CE, then the mean
    of those.  The (B, S, V) logits are never held whole."""
    B, S, _ = h.shape
    n_chunks = max(1, S // loss_chunk)
    size = S // n_chunks
    if size * n_chunks != S:
        raise ValueError(f"sequence {S} does not split into {n_chunks} "
                         f"chunks of {size}")
    losses = [cross_entropy_loss(unembed(h[:, i:i + size], W, softcap),
                                 labels[:, i:i + size], W.shape[0])
              for i in range(0, S, size)]
    return torch.mean(torch.stack(losses))
