"""Mixture-of-Experts decoder family (port of ``repro/models/moe.py``):
qwen2-moe / olmoe.

GShard/Switch-style capacity-based top-k routing, as the JAX package
writes it, decision for decision:

  * tokens are reshaped into GROUPS of ~``group_size``; within a group,
    each (token, k) takes the next free slot of its expert in the
    flattened (s, K) order, and a slot at or past the capacity ``cap``
    drops it (its gate becomes 0);
  * dispatch and combine are one-hot products (the JAX package's
    einsums), so routing, capacity and drops are the reference's;
  * qwen2-moe additionally has ``n_shared_experts`` always-on experts
    (fused into one dense MLP of width n_shared * d_expert) and top-4 of
    60 routed experts; olmoe is pure top-8 of 64;
  * load-balance auxiliary loss (Switch style): E * sum_e f_e * p_e.

The attention, cache and decode attention are the dense family's; the
expert math is plain PyTorch (no Pallas kernel in the JAX package).

On the model axis (:mod:`repro_torch.models.layers`' mesh context) the
leaf rule cuts the router on the experts, w_gate/w_up on d_expert and
w_down on d_expert (qwen2-moe) or on d_model (olmoe, whose
``2 * d_ff == d_model``).  The router is read whole, so the logits, the
top-k, the capacity slots and the aux loss are computed whole on every
rank, the W = 1 decisions exactly; the dispatch too.  The experts'
hidden is this rank's block of d_expert and w_down is
:func:`repro_torch.models.layers.down_proj`'s: activations move over the
group, the expert weights never do.  Under ``attn_shard="heads_padded"``
(the expert count is the leaf rule's first candidate there) the three
expert weights are cut on the experts: each rank runs its experts'
capacity slots whole and their outputs are all-gathered.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.launch import collectives as coll
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.base import Family, register_family


def init_moe_mlp(gen, cfg):
    dtype = cfg.pdtype
    D, E, Fd = cfg.d_model, cfg.n_experts, cfg.d_expert or cfg.d_ff
    Ep = E + cfg.expert_pad      # padded expert count for even sharding
    makers = dict(
        router=lambda: L.dense_init(gen, (D, E), torch.float32),
        w_gate=lambda: L.dense_init(gen, (Ep, D, Fd), dtype, fan_in=D),
        w_up=lambda: L.dense_init(gen, (Ep, D, Fd), dtype, fan_in=D),
        w_down=lambda: L.dense_init(gen, (Ep, Fd, D), dtype, fan_in=Fd),
    )
    if cfg.n_shared_experts:
        makers["shared"] = lambda: L.init_mlp(
            gen, D, cfg.n_shared_experts * Fd, dtype, variant="swiglu")
    return L.draw_sorted(**makers)


def route(xg, router, cfg):
    """Top-k routing of grouped tokens xg (g, s, D).  Returns (top_p
    renormalised, top_e, keep, pos, cap, aux): the expert of each (token,
    k), its slot among the group's tokens routed to that expert (flattened
    (s, K) order), whether the slot is below the capacity, and the
    load-balance loss."""
    g, s, D = xg.shape
    E, K = cfg.n_experts, cfg.top_k
    router = L.whole(router, (D, E))      # one small gather on a model axis
    # the router is f32 at init; a bf16 round's client holds it in bf16,
    # which the JAX package's product promotes to f32
    logits = torch.matmul(xg.float(), router.float())         # (g, s, E)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.topk(probs, K, dim=-1)               # (g, s, K)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)

    # load-balance aux loss (Switch): E * mean_e( frac_tokens_e * mean_prob_e )
    frac = F.one_hot(top_e[..., 0], E).float().mean(dim=(0, 1))
    aux = E * torch.sum(frac * probs.mean(dim=(0, 1)))

    cap = int(max(4, (s * K / E) * cfg.capacity_factor))
    # position of each (token, k) among the tokens routed to the same expert
    flat = F.one_hot(top_e, E).reshape(g, s * K, E)
    pos_in_e = torch.cumsum(flat, dim=1) - flat
    pos = (pos_in_e * flat).sum(-1).reshape(g, s, K)
    keep = pos < cap
    return top_p, top_e, keep, pos, cap, aux


def moe_mlp(x, p, cfg, *, group_size: int = 2048, rows=None):
    """x: (B, S, D) -> (B, S, D); returns (out, aux_loss).  ``rows``: the
    data axes' group over which x's rows are split (serving,
    ``layers.rows_group``): the whole batch is gathered, routed in the
    one-process groups and capacities, and this rank's rows are kept."""
    if rows is not None:
        r = torch.distributed.get_rank(rows)
        out, aux = moe_mlp(coll.all_gather_rows(x, rows), p, cfg,
                           group_size=group_size)
        return out[r * x.shape[0]:(r + 1) * x.shape[0]], aux
    B, S, D = x.shape
    K, Ep = cfg.top_k, cfg.n_experts + cfg.expert_pad
    n_tok = B * S
    g = max(1, n_tok // group_size)
    s = n_tok // g                                   # tokens per group
    xg = x.reshape(g, s, D)
    top_p, top_e, keep, pos, cap, aux = route(xg, p["router"], cfg)
    gate = top_p * keep.to(top_p.dtype)

    # one-hot factors; a dropped token's slot index is ``cap``, whose
    # one-hot row is all zeros (padded experts never receive tokens)
    oh_e = F.one_hot(top_e, Ep).to(x.dtype)                    # (g,s,K,Ep)
    oh_c = F.one_hot(torch.where(keep, pos, cap), cap + 1)[..., :cap] \
        .to(x.dtype)                                           # (g,s,K,cap)
    # contract over K without materializing the (g,s,K,E,cap) product
    disp = torch.matmul(oh_e.transpose(-1, -2), oh_c)          # (g,s,Ep,cap)
    weighted = oh_e * gate.to(x.dtype)[..., None]
    comb = torch.matmul(weighted.transpose(-1, -2), oh_c)

    # xe (g, Ep, cap, D): each slot's token
    xe = torch.matmul(disp.reshape(g, s, Ep * cap).transpose(1, 2), xg)
    xe = xe.reshape(g, Ep, cap, D).transpose(0, 1)             # (Ep,g,cap,D)
    xe = xe.reshape(Ep, g * cap, D)
    # on a model axis: this rank's block of the experts' hidden, or of
    # the experts themselves
    Fd = cfg.d_expert or cfg.d_ff
    wide, tall = (Ep, D, Fd), (Ep, Fd, D)
    grp = L.model_group()
    if grp is not None and all(L.split_dim(p[n], s) == 0 for n, s in (
            ("w_gate", wide), ("w_up", wide), ("w_down", tall))):
        xb = coll.tp_scatter(xe, 0, grp)
        h = (F.silu(torch.matmul(xb, p["w_gate"]))
             * torch.matmul(xb, p["w_up"]))
        ye = coll.tp_gather(torch.matmul(h, p["w_down"]), 0, grp)
    else:
        xc = coll.tp_copy(xe, grp)
        h = (F.silu(torch.matmul(xc, L.block_of(p["w_gate"], wide, 2)))
             * torch.matmul(xc, L.block_of(p["w_up"], wide, 2)))
        ye = L.down_proj(h, p["w_down"], tall)                 # (Ep,g*cap,D)
    ye = ye.reshape(Ep, g, cap, D).transpose(0, 1).reshape(g, Ep * cap, D)
    out = torch.matmul(comb.reshape(g, s, Ep * cap), ye)       # (g, s, D)

    out = out.reshape(B, S, D)
    if "shared" in p:
        out = out + L.mlp(x, p["shared"], "swiglu",
                          d_ff=cfg.n_shared_experts * Fd)
    return out, aux


def init_params(cfg, seed: int, device=None):
    gen = L.generator(seed, device)
    dev, dtype, D, n = gen.device, cfg.pdtype, cfg.d_model, cfg.n_layers

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=dev)

    makers = dict(
        embedding=lambda: L.init_embedding(gen, cfg.vocab, D, dtype),
        blocks=lambda: L.draw_sorted(
            attn=lambda: L.stack_layers(lambda: L.init_attention(gen, cfg),
                                        (n,)),
            moe=lambda: L.stack_layers(lambda: init_moe_mlp(gen, cfg), (n,)),
            ln_attn=lambda: zeros(n, D),
            ln_mlp=lambda: zeros(n, D)),
        ln_final=lambda: zeros(D),
    )
    if not cfg.tie_embeddings:
        makers["lm_head"] = lambda: L.init_embedding(gen, cfg.vocab, D, dtype)
    return L.draw_sorted(**makers)


def _moe_block(x, blk, cfg, positions, kv=None, rows=None):
    h = L.rms_norm(x, blk["ln_attn"], cfg.norm_eps)
    x = x + L.attention(h, blk["attn"], cfg, positions, causal=True,
                        kv_override=kv)
    h = L.rms_norm(x, blk["ln_mlp"], cfg.norm_eps)
    out, aux = moe_mlp(h, blk["moe"], cfg, rows=rows)
    return x + out, aux


def _moe_layer(x, aux, blk, cfg, positions):
    """One layer with the aux loss carried: (x, aux sum so far) -> the
    next pair."""
    x, a = _moe_block(x, blk, cfg, positions)
    return x, aux + a


def trunk(params, x, cfg, positions):
    """The training forward's layers, each a rematerialized unit under
    autograd with the aux loss in its carry (the JAX package's
    ``jax.checkpoint`` of its scan body)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for _, blk, _ in T.layers(params, cfg):         # windows all 0
        x, aux = L.remat(_moe_layer, x, aux, blk, cfg, positions)
    return L.rms_norm(x, params["ln_final"], cfg.norm_eps), aux / cfg.n_layers


def forward_hidden(params, batch, cfg):
    tokens = batch["tokens"]
    B, S = tokens.shape
    positions = torch.arange(S, device=tokens.device).expand(B, S)
    x = L.embed(tokens, params["embedding"])
    return trunk(params, x, cfg, positions)


def logits_fn(params, batch, cfg):
    h, _aux = forward_hidden(params, batch, cfg)
    return L.unembed(h, T._lm_matrix(params))


def loss(params, batch, cfg, *, loss_chunk: int = 512):
    h, aux = forward_hidden(params, batch, cfg)
    ce = L.chunked_lm_loss(h, batch["labels"], T._lm_matrix(params),
                           loss_chunk=loss_chunk)
    return ce + cfg.router_aux_coef * aux


# ---------------------------------------------------------------------------
# decode path (same attention cache as dense; MoE ffn on 1-token groups)
# ---------------------------------------------------------------------------

init_cache = T.init_cache


def prefill(params, batch, cfg, cache):
    """Fill the cache in place for tokens (B, S); return (last logits,
    cache)."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    positions = torch.arange(S, device=tokens.device).expand(B, S)
    x = L.embed(tokens, params["embedding"])
    for i, blk, _ in T.layers(params, cfg):
        h = L.rms_norm(x, blk["ln_attn"], cfg.norm_eps)
        _, k, v = L._qkv(h, blk["attn"], cfg, positions)
        cache["k"][i, :, :S] = L.kv_block(k, cache["k"])
        cache["v"][i, :, :S] = L.kv_block(v, cache["v"])
        x, _ = _moe_block(x, blk, cfg, positions, kv=(k, v, positions),
                          rows=L.rows_group())
    h = L.rms_norm(x, params["ln_final"], cfg.norm_eps)
    logits = L.unembed(h[:, -1:], T._lm_matrix(params))
    return logits[:, 0], cache


def decode_step(params, cache, token, pos, cfg):
    """One token per row; the MoE ffn routes the B tokens as one group
    (on a mesh serving split rows, the whole batch's B)."""
    rows = L.rows_group()
    B = token.shape[0] * (1 if rows is None
                          else torch.distributed.get_world_size(rows))
    x = L.embed(token, params["embedding"])
    for i, blk, _ in T.layers(params, cfg):
        h = L.rms_norm(x, blk["ln_attn"], cfg.norm_eps)
        x = x + T.decode_attn(h, blk, cfg, cache, i, pos)
        h2 = L.rms_norm(x, blk["ln_mlp"], cfg.norm_eps)
        out, _aux = moe_mlp(h2, blk["moe"], cfg, group_size=B, rows=rows)
        x = x + out
    h = L.rms_norm(x, params["ln_final"], cfg.norm_eps)
    logits = L.unembed(h, T._lm_matrix(params))
    return logits[:, 0], cache


register_family(
    Family(
        name="moe",
        init_params=init_params,
        forward=logits_fn,
        loss=loss,
        init_cache=init_cache,
        prefill=prefill,
        decode_step=decode_step,
    )
)
