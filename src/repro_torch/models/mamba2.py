"""Mamba2 (SSD — state-space duality) block, chunkwise-parallel (port of
``repro/models/mamba2.py``).

Follows the minimal SSD formulation (Dao & Gu, 2024):

    h_t = exp(a_t) * h_{t-1} + dt_t * B_t x_t^T        (per head)
    y_t = C_t h_t + D * x_t

with a_t = -exp(A_log) * dt_t (scalar per head), B/C shared across heads
(n_groups = 1), chunked into blocks of ``cfg.ssm_chunk``:
  * intra-chunk: quadratic attention-like term with decay mask L — the
    ``ssd_intra_chunk`` kernel (:mod:`repro_torch.kernels.ssd_scan`),
  * inter-chunk: a short loop over per-chunk states (B, H, P, N).

Decode is the recurrent form on a persistent (B, H, P, N) state plus a
(width-1) causal-conv state.

On the model axis (:func:`repro_torch.models.layers.set_mesh_context`,
params cut by the leaf rule) :func:`mamba2_forward` runs the SSM heads
split over the model group: each rank scans its H/M heads (the
``ssd_intra_chunk`` kernel launches on them) and its d_inner block goes
through the gated norm and out_proj's rows; :func:`mamba2_decode` steps
the same heads, with their state.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.launch import collectives as coll
from repro_torch.models import layers as L


def d_inner(cfg) -> int:
    return cfg.ssm_expand * cfg.d_model


def n_heads_ssm(cfg) -> int:
    return d_inner(cfg) // cfg.ssm_head_dim


def conv_channels(cfg) -> int:
    return d_inner(cfg) + 2 * cfg.ssm_state  # x ++ B ++ C (one group)


def init_mamba2(gen, cfg):
    dtype, dev = cfg.pdtype, gen.device
    D = cfg.d_model
    di, H, N = d_inner(cfg), n_heads_ssm(cfg), cfg.ssm_state
    d_in_proj = 2 * di + 2 * N + H  # z, x, B, C, dt
    return L.draw_sorted(
        in_proj=lambda: L.dense_init(gen, (D, d_in_proj), dtype, fan_in=D),
        conv_w=lambda: L.dense_init(gen, (cfg.ssm_conv, conv_channels(cfg)),
                                    dtype, fan_in=cfg.ssm_conv),
        conv_b=lambda: torch.zeros((conv_channels(cfg),), dtype=dtype,
                                   device=dev),
        dt_bias=lambda: torch.zeros((H,), dtype=torch.float32, device=dev),
        A_log=lambda: torch.zeros((H,), dtype=torch.float32, device=dev),
        D=lambda: torch.ones((H,), dtype=torch.float32, device=dev),
        norm=lambda: torch.zeros((di,), dtype=dtype, device=dev),
        out_proj=lambda: L.dense_init(gen, (di, D), dtype, fan_in=di),
    )


def _segsum(a):
    """a: (..., Q) -> (..., Q, Q) with out[i,j] = sum_{j<k<=i} a_k (causal)."""
    Q = a.shape[-1]
    cs = torch.cumsum(a, -1)
    seg = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=a.device))
    return seg.masked_fill(~mask, -torch.inf)


def ssd_chunked(x, a, Bm, Cm, chunk: int, init_state=None):
    """Chunked SSD scan.

    x:  (b, s, h, p)   head inputs (already * dt)
    a:  (b, s, h)      log decay per step (<= 0), f32
    Bm: (b, s, n)      input projection (shared across heads)
    Cm: (b, s, n)      output projection
    Returns (y (b,s,h,p) f32, final_state (b,h,p,n) f32).

    The intra-chunk term ``Y_diag`` always goes through
    :func:`repro_torch.kernels.ssd_scan.ops.ssd_intra_chunk`, which picks
    the route by device: the CUDA kernel for a CUDA tensor, the plain
    version for a CPU one.  This replaces the JAX package's
    ``use_kernel=True`` flag (its two branches agree).
    """
    b, s, h, p = x.shape
    n = Bm.shape[-1]
    c = s // chunk
    q = chunk
    # contiguous: the kernel takes dense row-major inputs (Bm and Cm are
    # slices of the conv output)
    xr = x.reshape(b, c, q, h, p).contiguous()
    ar = a.reshape(b, c, q, h).permute(0, 3, 1, 2).contiguous()  # (b,h,c,q)
    Br = Bm.reshape(b, c, q, n).contiguous()
    Cr = Cm.reshape(b, c, q, n).contiguous()

    a_cs = torch.cumsum(ar, dim=-1)                        # (b,h,c,q)
    Y_diag = ssd_ops.ssd_intra_chunk(xr, ar, Br, Cr)

    # states at chunk ends: sum_k exp(a_end - a_k) B_k x_k
    decay_states = torch.exp(a_cs[..., -1:] - a_cs)        # (b,h,c,q)
    xw = xr.float() * decay_states.permute(0, 2, 3, 1)[..., None]
    states = torch.matmul(Br.float().transpose(-1, -2),    # (b,c,n,h*p)
                          xw.reshape(b, c, q, h * p))
    states = states.reshape(b, c, n, h, p).permute(0, 1, 3, 4, 2)  # (b,c,h,p,n)

    # inter-chunk recurrence (the JAX package's lax.scan)
    chunk_decay = torch.exp(a_cs[..., -1])                 # (b,h,c)
    hprev = (torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
             if init_state is None else init_state)
    prev = []
    for ci in range(c):
        prev.append(hprev)
        hprev = hprev * chunk_decay[:, :, ci, None, None] + states[:, ci]
    final = hprev
    prev_states = torch.stack(prev, dim=1)                 # (b,c,h,p,n)

    # inter-chunk contribution
    state_decay = torch.exp(a_cs)                          # (b,h,c,q)
    ps = prev_states.to(x.dtype).float()
    Y_off = torch.matmul(Cr.float(),                       # (b,c,q,h*p)
                         ps.permute(0, 1, 4, 2, 3).reshape(b, c, n, h * p))
    Y_off = Y_off.reshape(b, c, q, h, p) * \
        state_decay.permute(0, 2, 3, 1)[..., None]
    y = (Y_diag + Y_off).reshape(b, s, h, p)
    return y, final


def _causal_conv(xBC, w, bias):
    """Depthwise causal conv over time. xBC: (B, S, C), w: (K, C)."""
    K, S = w.shape[0], xBC.shape[1]
    pad = F.pad(xBC, (0, 0, K - 1, 0))
    out = pad[:, 0:S] * w[0]
    for i in range(1, K):
        out = out + pad[:, i:i + S] * w[i]
    return out + bias


def _softplus(x):
    """jax.nn.softplus: log(1 + exp(x)) as max(x, 0) + log1p(exp(-|x|))."""
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-x.abs()))


def _shapes(cfg):
    """The whole shapes of one mixer's leaves."""
    D, di, H, N = cfg.d_model, d_inner(cfg), n_heads_ssm(cfg), cfg.ssm_state
    C = conv_channels(cfg)
    return {"in_proj": (D, 2 * di + 2 * N + H), "conv_w": (cfg.ssm_conv, C),
            "conv_b": (C,), "dt_bias": (H,), "A_log": (H,), "D": (H,),
            "norm": (di,), "out_proj": (di, D)}


def gated_rms_norm(y, z, scale, eps, group=None):
    """``rms_norm(y * silu(z), scale)``; with ``group``, y, z and scale are
    this rank's blocks of d_inner and the mean of squares covers the
    whole d_inner (the blocks' sums of squares added over the group)."""
    return L.rms_norm(y * F.silu(z), scale, eps, group)


def mamba2_forward(x, p, cfg, state=None):
    """Full mamba2 mixer on (B, S, D). Returns (out, (conv_state, ssm_state)).

    On the model axis the fused in_proj's output dim is cut contiguously
    (the leaf rule), so its split into z/x/B/C/dt crosses the blocks: the
    projection runs on this rank's columns and is all-gathered whole, as
    are the conv's channels.  Then each rank takes its H/M heads of x, z
    and dt (the JAX package's ``shard``), scans them with the group's
    whole B and C, and adds its rows of out_proj to the group's sum; the
    ssm state holds this rank's heads.  With no model axis every helper
    below returns its input and this is the one-device mixer."""
    group = L.model_group()
    Bsz, S, D = x.shape
    di, H, N, P = d_inner(cfg), n_heads_ssm(cfg), cfg.ssm_state, cfg.ssm_head_dim
    shapes = _shapes(cfg)

    zxbcdt = L.whole_proj(x, p["in_proj"], shapes["in_proj"])
    z, xs, Bm, Cm, dt = torch.split(zxbcdt, [di, di, N, N, H], dim=-1)

    xBC_raw = torch.cat([xs, Bm, Cm], -1)
    conv_w = L.whole(p["conv_w"], shapes["conv_w"])
    conv_b = L.whole(p["conv_b"], shapes["conv_b"])
    if state is not None:
        conv_in = torch.cat([state[0], xBC_raw], dim=1)
        xBC = _causal_conv(conv_in, conv_w, conv_b)[:, state[0].shape[1]:]
    else:
        xBC = _causal_conv(xBC_raw, conv_w, conv_b)
    xBC = F.silu(xBC)
    xs, Bm, Cm = torch.split(xBC, [di, N, N], dim=-1)

    xs, z, dt = (L.shard(t, None, None, "model") for t in (xs, z, dt))
    h = dt.shape[-1]                                               # H / M
    dt = _softplus(dt.float() + L.block_of(p["dt_bias"], (H,), 0))  # (B,S,h)
    a = -torch.exp(L.block_of(p["A_log"], (H,), 0)) * dt            # (B,S,h)
    xh = xs.reshape(Bsz, S, h, P)
    x_dt = (xh.float() * dt[..., None]).to(x.dtype)

    init_ssm = state[1] if state is not None else None
    y, ssm_final = ssd_chunked(
        x_dt, a, coll.tp_copy(Bm, group), coll.tp_copy(Cm, group),
        min(cfg.ssm_chunk, S), init_state=init_ssm)
    D_skip = L.block_of(p["D"], (H,), 0)
    y = y + xh * D_skip[None, None, :, None].to(x.dtype)
    # SSD mixes f32 decay factors in; pin back to the residual dtype
    y = y.reshape(Bsz, S, h * P).to(x.dtype)
    y = gated_rms_norm(y, z, L.block_of(p["norm"], (di,), 0), cfg.norm_eps,
                       group)
    out = coll.tp_reduce(
        torch.matmul(y, L.block_of(p["out_proj"], (di, D), 0)), group)
    K = cfg.ssm_conv
    if state is not None:
        tail = torch.cat([state[0], xBC_raw], dim=1)[:, -(K - 1):]
    else:
        tail = xBC_raw[:, S - (K - 1):]
    return out, (tail, ssm_final)


def mamba2_decode(x, p, cfg, state):
    """One-step recurrent decode. x: (B, 1, D); state=(conv_state, ssm_state).

    On the model axis this follows :func:`mamba2_forward`'s placement:
    in_proj's output on this rank's columns, all-gathered whole; the
    step of the SSM on this rank's H/M heads, whose state the rank holds;
    the gated norm's sums of squares added over the group and out_proj's
    rows summed (``tp_reduce``).  A conv state cut on its channels (as
    ``launch/serve.py`` places it) convolves this rank's channels, and
    the conv's output is all-gathered whole; a whole one convolves all
    of them."""
    group = L.model_group()
    conv_state, ssm_state = state
    Bsz = x.shape[0]
    di, H, N, P = d_inner(cfg), n_heads_ssm(cfg), cfg.ssm_state, cfg.ssm_head_dim
    shapes = _shapes(cfg)

    zxbcdt = L.whole_proj(x, p["in_proj"], shapes["in_proj"])
    z, xs, Bm, Cm, dt = torch.split(zxbcdt, [di, di, N, N, H], dim=-1)
    xBC_new = torch.cat([xs, Bm, Cm], -1)                  # (B,1,C)

    channels_cut = conv_state.shape[-1] != conv_channels(cfg)
    if channels_cut:
        conv_in = torch.cat([conv_state, L.shard(xBC_new, None, None,
                                                 "model")], dim=1)
        conv_w = L.block_of(p["conv_w"], shapes["conv_w"], 1)
        conv_b = L.block_of(p["conv_b"], shapes["conv_b"], 0)
    else:
        conv_in = torch.cat([conv_state, xBC_new], dim=1)  # (B,K,C)
        conv_w = L.whole(p["conv_w"], shapes["conv_w"])
        conv_b = L.whole(p["conv_b"], shapes["conv_b"])
    xBC = (conv_in * conv_w[None]).sum(dim=1, keepdim=True) + conv_b
    if channels_cut:
        xBC = coll.tp_gather(xBC, 2, group)
    xBC = F.silu(xBC)
    new_conv_state = conv_in[:, 1:]

    xs, Bm, Cm = torch.split(xBC, [di, N, N], dim=-1)
    xs, z, dt = (L.shard(t, None, None, "model") for t in (xs, z, dt))
    h = dt.shape[-1]                                               # H / M
    dt = _softplus(dt.float() + L.block_of(p["dt_bias"], (H,), 0))  # (B,1,h)
    a = torch.exp(-torch.exp(L.block_of(p["A_log"], (H,), 0)) * dt)[:, 0]
    xs_h = xs.reshape(Bsz, h, P).float()
    x_dt = xs_h * dt[:, 0, :, None]                                # discretized

    # h <- a h + (dt x) B^T ; y = h C + D x
    new_ssm = ssm_state * a[..., None, None] + \
        x_dt[..., None] * Bm[:, 0].float()[:, None, None, :]
    y = torch.matmul(new_ssm, Cm[:, 0].float()[:, None, :, None])[..., 0]
    y = y + xs_h * L.block_of(p["D"], (H,), 0)[None, :, None]
    y = y.reshape(Bsz, 1, h * P).to(x.dtype)
    y = gated_rms_norm(y, z, L.block_of(p["norm"], (di,), 0), cfg.norm_eps,
                       group)
    out = coll.tp_reduce(
        torch.matmul(y, L.block_of(p["out_proj"], shapes["out_proj"], 0)),
        group)
    return out, (new_conv_state, new_ssm)


def init_decode_state(cfg, batch_size, device):
    H, N, P = n_heads_ssm(cfg), cfg.ssm_state, cfg.ssm_head_dim
    conv = torch.zeros((batch_size, cfg.ssm_conv - 1, conv_channels(cfg)),
                       dtype=cfg.pdtype, device=device)
    ssm = torch.zeros((batch_size, H, P, N), dtype=torch.float32,
                      device=device)
    return (conv, ssm)
