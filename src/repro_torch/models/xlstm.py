"""xLSTM family (arXiv:2405.04517; port of ``repro/models/xlstm.py``):
mLSTM (matrix-memory, chunkwise-parallel) and sLSTM (scalar-memory,
strictly recurrent) blocks.

Layout: sLSTM every ``cfg.slstm_every`` layers (xLSTM[a:b] notation), the
rest mLSTM — xlstm-350m uses 24 blocks with 3 sLSTM.  d_ff=0: mLSTM
blocks carry their own up/down projection (factor 2); sLSTM blocks carry
a small gated FFN (factor 4/3) per the paper.

mLSTM chunkwise form (per head, exponential-decay linear attention):
    C_t = f_t C_{t-1} + i_t k_t v_t^T ,  n_t = f_t n_{t-1} + i_t k_t
    y_t = (q_t C_t) / max(|q_t . n_t|, 1)
with the same intra/inter-chunk split as Mamba2's SSD; the normalizer n
is carried as an extra value column.  Where the JAX package mixes a
param-dtype operand with an f32 one (its einsums then compute in f32),
the port casts to f32 explicitly.

sLSTM: stabilized exponential gating with per-head block-diagonal
recurrent matrices, as a Python loop over time (the JAX package's
``lax.scan``: sequential by construction, and the JAX package has no
kernel for it).  The family attends nothing, so its decode launches no
``flash_decode``.

On the model axis (:mod:`repro_torch.models.layers`' mesh context) the
leaf rule cuts the mLSTM's w_up and q/k/v on their outputs, its gates on
the heads, ln_inner and w_down's rows on d_inner, and the sLSTM's
recurrent ``R*`` on their last dim.  An mLSTM block gathers w_up's
output whole (its z/m split crosses the cut), runs q/k/v, the gates and
the chunked recurrence on this rank's heads, normalizes over the whole
d_inner and adds the ranks' rows of w_down; an sLSTM block gathers its
``R*`` whole once, before the time loop, and runs the recurrence whole
on every rank (no collective inside the loop).  Heads that do not
divide the model axis run the mLSTM whole on every rank.  Serving on the
model axis (``launch/serve.py``) keeps the mLSTM states of this rank's
heads (or, with heads that do not divide the axis, its block of their
key dim) and the sLSTM states whole.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.launch import collectives as coll
from repro_torch.models import layers as L
from repro_torch.models.base import Family, register_family
from repro_torch.models.mamba2 import _segsum

_GATES = "zifo"


def d_inner(cfg) -> int:
    return 2 * cfg.d_model


def mlstm_heads(cfg) -> int:
    return cfg.n_heads


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


def init_mlstm(gen, cfg):
    dtype, dev = cfg.pdtype, gen.device
    D, di, H = cfg.d_model, d_inner(cfg), mlstm_heads(cfg)
    f32 = torch.float32
    return L.draw_sorted(
        ln=lambda: torch.zeros((D,), dtype=dtype, device=dev),
        w_up=lambda: L.dense_init(gen, (D, 2 * di), dtype, fan_in=D),
        wq=lambda: L.dense_init(gen, (di, di), dtype),
        wk=lambda: L.dense_init(gen, (di, di), dtype),
        wv=lambda: L.dense_init(gen, (di, di), dtype),
        w_i=lambda: L.dense_init(gen, (di, H), f32),
        w_f=lambda: L.dense_init(gen, (di, H), f32),
        b_i=lambda: torch.zeros((H,), dtype=f32, device=dev),
        b_f=lambda: torch.full((H,), 3.0, dtype=f32, device=dev),  # remember
        ln_inner=lambda: torch.zeros((di,), dtype=dtype, device=dev),
        w_down=lambda: L.dense_init(gen, (di, D), dtype, fan_in=di),
    )


def mlstm_chunked(q, k, v, logf, logi, chunk: int, init_state=None):
    """q,k,v: (b,s,h,d); logf,logi: (b,s,h).  Returns (y, final_C).

    The normalizer is appended as an extra column of v, so state C is
    (b, h, dk, dv+1), f32.  y is f32.
    """
    b, s, h, dk = q.shape
    dv = v.shape[-1]
    ones = torch.ones(v.shape[:-1] + (1,), dtype=v.dtype, device=v.device)
    v_ext = torch.cat([v, ones], -1)                       # (b,s,h,dv+1)
    # fold the input gate into the value contribution
    v_ext = v_ext * torch.exp(logi)[..., None].to(v.dtype)

    c = s // chunk
    qr = q.reshape(b, c, chunk, h, dk)
    kr = k.reshape(b, c, chunk, h, dk)
    vr = v_ext.reshape(b, c, chunk, h, dv + 1).float()
    ar = logf.reshape(b, c, chunk, h).permute(0, 3, 1, 2)  # (b,h,c,q)
    a_cs = torch.cumsum(ar, -1)

    Lm = torch.exp(_segsum(ar))                            # (b,h,c,q,kq)
    scores = torch.einsum("bcqhd,bckhd->bhcqk", qr, kr)
    Y_diag = torch.einsum("bhcqk,bckhe->bcqhe", scores.float() * Lm, vr)

    decay_states = torch.exp(a_cs[..., -1:] - a_cs)        # (b,h,c,k)
    kd = kr.float() * decay_states.permute(0, 2, 3, 1)[..., None]
    states = torch.einsum("bckhd,bckhe->bchde", kd, vr)
    chunk_decay = torch.exp(a_cs[..., -1])                 # (b,h,c)
    if init_state is None:
        init_state = torch.zeros((b, h, dk, dv + 1), dtype=torch.float32,
                                 device=q.device)
    prev, cur = [], init_state
    for ci in range(c):
        prev.append(cur)
        cur = cur * chunk_decay[:, :, ci, None, None] + states[:, ci]
    prev = torch.stack(prev, 1)                            # (b,c,h,dk,dv+1)
    state_decay = torch.exp(a_cs).permute(0, 2, 3, 1)      # (b,c,q,h)
    Y_off = torch.einsum("bcqhd,bchde->bcqhe", qr.float(),
                         prev.to(q.dtype).float()) * state_decay[..., None]
    y_ext = (Y_diag + Y_off).reshape(b, s, h, dv + 1)
    y, norm = y_ext[..., :dv], y_ext[..., dv:]
    y = y / torch.clamp(torch.abs(norm), min=1.0)
    return y, cur


def mlstm_block(x, p, cfg, state=None):
    """x: (B,S,D).  state: C (B,H,dk,dv+1) for decode, or None.  On the
    model axis H is this rank's heads, the state's too (module
    docstring).  Heads that do not divide the model axis (xlstm-350m's 4
    on 16 ranks) run whole on every rank, and a decode state cut on its
    key dim (``launch/serve.py``) steps this rank's key rows, its
    readout's partial sums added over the group."""
    B, S, D = x.shape
    di, H = d_inner(cfg), mlstm_heads(cfg)
    dh = di // H
    g = L.model_group()
    split = g is not None and H % torch.distributed.get_world_size(g) == 0
    h_in = L.rms_norm(x, p["ln"], cfg.norm_eps)
    z, m = torch.chunk(L.whole_proj(h_in, p["w_up"], (D, 2 * di)), 2, -1)

    mc = coll.tp_copy(m, g if split else None)

    def mine(w, shape, dim):
        """This rank's block of ``w`` along ``dim`` on split heads, else
        ``w`` whole."""
        return L.block_of(w, shape, dim) if split else L.whole(w, shape)

    def heads(name):
        return torch.matmul(mc, mine(p[name], (di, di), 1)).reshape(
            B, S, -1, dh)

    q, v = heads("wq"), heads("wv")
    k = heads("wk") * (dh ** -0.5)
    # the gates' f32 weights are the compute dtype in a bf16 round's
    # client; the JAX package's products promote them to f32
    logi = (torch.matmul(mc.float(), mine(p["w_i"], (di, H), 1).float())
            + mine(p["b_i"], (H,), 0))
    logf = F.logsigmoid(
        torch.matmul(mc.float(), mine(p["w_f"], (di, H), 1).float())
        + mine(p["b_f"], (H,), 0))
    # stabilize the input gate (exp can overflow): subtract a running cap
    logi = torch.clamp(logi, max=10.0)

    if state is None or S > 1:
        y, final = mlstm_chunked(q, k, v, logf, logi,
                                 min(cfg.ssm_chunk or 64, S), init_state=state)
    else:
        # one-step recurrent decode
        ones = torch.ones(v.shape[:-1] + (1,), dtype=v.dtype, device=v.device)
        v_ext = (torch.cat([v, ones], -1)
                 * torch.exp(logi)[..., None].to(v.dtype))[:, 0]
        f = torch.exp(logf)[:, 0]                           # (B,H)
        qk = (q[:, 0].float(), k[:, 0].float())
        key_cut = state.shape[-2] != dh
        if key_cut:
            qk = tuple(coll.tp_scatter(t, 2, g) for t in qk)
        final = state * f[..., None, None] + torch.einsum(
            "bhd,bhe->bhde", qk[1], v_ext.float())
        y_ext = torch.einsum("bhd,bhde->bhe", qk[0], final)
        if key_cut:
            y_ext = coll.tp_reduce(y_ext, g)
        yv, norm = y_ext[..., :-1], y_ext[..., -1:]
        y = (yv / torch.clamp(torch.abs(norm), min=1.0))[:, None]

    # the chunked path mixes f32 decay factors in; pin back to residual dtype
    y = y.reshape(B, S, -1).to(x.dtype)
    if split or g is None:
        y = (L.rms_norm(y, L.block_of(p["ln_inner"], (di,), 0), cfg.norm_eps,
                        group=g)
             * F.silu(L.shard(z, None, None, "model")))
    else:
        y = L.shard(L.rms_norm(y, p["ln_inner"], cfg.norm_eps) * F.silu(z),
                    None, None, "model")
    return x + L.down_proj(y, p["w_down"], (di, D)), final


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------


def slstm_ff(cfg) -> int:
    return max(64, (4 * cfg.d_model // 3 + 63) // 64 * 64)


def init_slstm(gen, cfg):
    dtype, dev = cfg.pdtype, gen.device
    D, H = cfg.d_model, cfg.n_heads
    dh = D // H
    f32 = torch.float32
    makers = dict(ln=lambda: torch.zeros((D,), dtype=dtype, device=dev))
    for g in _GATES:
        makers[f"W{g}"] = lambda: L.dense_init(gen, (D, D), f32)
        makers[f"R{g}"] = lambda: L.dense_init(gen, (H, dh, dh), f32,
                                               fan_in=dh)
        makers[f"b{g}"] = (
            (lambda: torch.full((D,), 3.0, dtype=f32, device=dev)) if g == "f"
            else (lambda: torch.zeros((D,), dtype=f32, device=dev)))
    makers["ffn"] = lambda: L.init_mlp(gen, D, slstm_ff(cfg), dtype, "swiglu")
    makers["ln_ffn"] = lambda: torch.zeros((D,), dtype=dtype, device=dev)
    return L.draw_sorted(**makers)


def slstm_scan(x, p, cfg, init=None):
    """x: (B,S,D) -> (B,S,D); stabilized exponential-gating recurrence,
    one step of S at a time.  The four gates' input and recurrent
    products are each one matrix product (the weights side by side)."""
    B, S, D = x.shape
    H = cfg.n_heads
    dh = D // H
    W = torch.cat([L.whole(p[f"W{g}"], (D, D)) for g in _GATES],
                  -1).float()   # f32, as the JAX package's product promotes
    bias = torch.cat([L.whole(p[f"b{g}"], (D,)) for g in _GATES], -1)
    pre = (torch.matmul(x.float(), W) + bias).reshape(B, S, 4, H, dh)
    # on a model axis the four R* are gathered whole in one call, here,
    # before the time loop
    R = torch.cat(list(L.whole(torch.stack([p[f"R{g}"] for g in _GATES]),
                               (4, H, dh, dh))), -1).float()  # (H, dh, 4dh)

    if init is None:
        zeros = torch.zeros((B, H, dh), dtype=torch.float32, device=x.device)
        init = {"c": zeros, "n": zeros, "h": zeros, "m": zeros - 1e30 * 0}
    c, n, h, m = init["c"], init["n"], init["h"], init["m"]
    hs = []
    for t in range(S):
        rec = torch.einsum("bhd,hde->bhe", h, R).reshape(B, H, 4, dh)
        pz, pi, pf, po = (pre[:, t, j] + rec[:, :, j] for j in range(4))
        z = torch.tanh(pz)
        f_log = F.logsigmoid(pf)
        o = torch.sigmoid(po)
        m_new = torch.maximum(f_log + m, pi)
        i_p = torch.exp(pi - m_new)
        f_p = torch.exp(f_log + m - m_new)
        c = f_p * c + i_p * z
        n = f_p * n + i_p
        h = o * c / torch.clamp(n, min=1.0)
        m = m_new
        hs.append(h)
    out = torch.stack(hs, 1).reshape(B, S, D).to(x.dtype)
    return out, {"c": c, "n": n, "h": h, "m": m}


def slstm_block(x, p, cfg, state=None):
    h_in = L.rms_norm(x, p["ln"], cfg.norm_eps)
    y, final = slstm_scan(h_in, p, cfg, init=state)
    x = x + y
    h2 = L.rms_norm(x, p["ln_ffn"], cfg.norm_eps)
    return x + L.mlp(h2, p["ffn"], "swiglu", d_ff=slstm_ff(cfg)), final


# ---------------------------------------------------------------------------
# full model
# ---------------------------------------------------------------------------


def layer_plan(cfg):
    """(n_periods, mlstm_per_period, n_trailing_mlstm).  One sLSTM closes
    each period."""
    if cfg.slstm_every <= 0:
        return 0, 0, cfg.n_layers
    n_per = cfg.n_layers // cfg.slstm_every
    trailing = cfg.n_layers - n_per * cfg.slstm_every
    return n_per, cfg.slstm_every - 1, trailing


def init_params(cfg, seed: int, device=None):
    gen = L.generator(seed, device)
    dtype, D = cfg.pdtype, cfg.d_model
    n_per, m_per, trailing = layer_plan(cfg)
    return L.draw_sorted(
        embedding=lambda: L.init_embedding(gen, cfg.vocab, D, dtype),
        mlstm_seg=lambda: L.stack_layers(lambda: init_mlstm(gen, cfg),
                                         (n_per, m_per))
        if n_per and m_per else None,
        slstm=lambda: L.stack_layers(lambda: init_slstm(gen, cfg), (n_per,))
        if n_per else None,
        mlstm_tail=lambda: L.stack_layers(lambda: init_mlstm(gen, cfg),
                                          (trailing,))
        if trailing else None,
        ln_final=lambda: torch.zeros((D,), dtype=dtype, device=gen.device),
        lm_head=lambda: L.init_embedding(gen, cfg.vocab, D, dtype),
    )


def _blocks(params, cfg):
    """(kind, cache index, layer params) in network order: kind "m_seg"
    (index (period, i)), "s_seg" (index (period,)) or "m_tail"."""
    n_per, m_per, trailing = layer_plan(cfg)
    # a stack the model axis cuts on a stacking dim is gathered whole
    seg = L.whole_stack(params["mlstm_seg"], (n_per, m_per))
    slstm = L.whole_stack(params["slstm"], (n_per,))
    tail = L.whole_stack(params["mlstm_tail"], (trailing,))
    for pi in range(n_per):
        for mi in range(m_per):
            yield "m_seg", (pi, mi), L.layer_slice(seg, pi, mi)
        yield "s_seg", (pi,), L.layer_slice(slstm, pi)
    for ti in range(trailing):
        yield "m_tail", (ti,), L.layer_slice(tail, ti)


def _run(params, x, cfg, cache, decode):
    """Every block over x, each block's final state written into its slot
    of ``cache`` in place; with ``decode`` each block starts from that
    slot's state."""
    for kind, idx, lyr in _blocks(params, cfg):
        if kind == "s_seg":
            slots = L.layer_slice(cache[kind], *idx)
            x, new = slstm_block(x, lyr, cfg, state=slots if decode else None)
            for k, v in new.items():
                slots[k].copy_(v)
        else:
            slot = cache[kind][idx]
            x, new = mlstm_block(x, lyr, cfg, state=slot if decode else None)
            slot.copy_(new if decode else L.cache_block(new, slot))
    return L.rms_norm(x, params["ln_final"], cfg.norm_eps)


def _period(x, mlstms, slstm, cfg):
    """One period: its mLSTM layers, then its sLSTM."""
    for lyr in mlstms:
        x, _ = mlstm_block(x, lyr, cfg)
    return slstm_block(x, slstm, cfg)[0]


def _mlstm_x(x, lyr, cfg):
    return mlstm_block(x, lyr, cfg)[0]


def _train_run(params, x, cfg):
    """Every block over x with no cache (the training forward): each
    period (its mLSTM layers and its sLSTM) and each trailing mLSTM layer
    is a rematerialized unit under autograd (the JAX package's
    ``jax.checkpoint`` of its scan bodies)."""
    n_per, m_per, _ = layer_plan(cfg)
    blocks = [lyr for _, _, lyr in _blocks(params, cfg)]
    for pi in range(n_per):
        period = blocks[pi * (m_per + 1):(pi + 1) * (m_per + 1)]
        x = L.remat(_period, x, period[:-1], period[-1], cfg)
    for lyr in blocks[n_per * (m_per + 1):]:
        x = L.remat(_mlstm_x, x, lyr, cfg)
    return L.rms_norm(x, params["ln_final"], cfg.norm_eps)


def forward_hidden(params, batch, cfg, cache=None):
    """Final hidden states; with ``cache``, the blocks' final states are
    written into it (the prefill: never rematerialized)."""
    x = L.embed(batch["tokens"], params["embedding"])
    if cache is None:
        return _train_run(params, x, cfg)
    return _run(params, x, cfg, cache, decode=False)


def logits_fn(params, batch, cfg):
    return L.unembed(forward_hidden(params, batch, cfg), params["lm_head"])


def loss(params, batch, cfg, *, loss_chunk: int = 512):
    h = forward_hidden(params, batch, cfg)
    return L.chunked_lm_loss(h, batch["labels"], params["lm_head"],
                             loss_chunk=loss_chunk)


def init_cache(cfg, batch_size, max_len, device=None):
    dev = resolve_device(device)
    n_per, m_per, trailing = layer_plan(cfg)
    di, H = d_inner(cfg), mlstm_heads(cfg)
    dh = di // H
    dhs = cfg.d_model // cfg.n_heads

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=dev)

    mstate = (batch_size, H, dh, dh + 1)
    sstate = (batch_size, cfg.n_heads, dhs)
    return {
        "m_seg": zeros(n_per, m_per, *mstate) if n_per and m_per else None,
        "s_seg": {k: zeros(n_per, *sstate) for k in "cnhm"}
        if n_per else None,
        "m_tail": zeros(trailing, *mstate) if trailing else None,
    }


def prefill(params, batch, cfg, cache):
    """The chunked forward from zero state, every block's final state
    written into ``cache`` in place; returns (last logits, cache)."""
    h = forward_hidden(params, batch, cfg, cache=cache)
    return L.unembed(h[:, -1:], params["lm_head"])[:, 0], cache


def decode_step(params, cache, token, pos, cfg):
    """One recurrent step per block from the cached states (``pos`` is
    not read: the state carries the position)."""
    x = L.embed(token, params["embedding"])
    h = _run(params, x, cfg, cache, decode=True)
    return L.unembed(h, params["lm_head"])[:, 0], cache


register_family(
    Family(
        name="ssm",
        init_params=init_params,
        forward=logits_fn,
        loss=loss,
        init_cache=init_cache,
        prefill=prefill,
        decode_step=decode_step,
    )
)
