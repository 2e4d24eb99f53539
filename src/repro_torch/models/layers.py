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
* The mesh context (:func:`set_mesh_context`, installed by the
  launcher) carries the model axis: tensor parallelism over the mesh's
  model group, explicit through the autograd collectives of
  :mod:`repro_torch.launch.collectives`.  A layer whose params hold
  blocks cut on the model axis (a leaf smaller than its whole shape from
  the config) runs model-parallel: a projection whose output dim is cut
  runs on this rank's columns, one whose input dim is cut on its rows
  and sums the ranks' partial outputs (:func:`attention`'s q/k/v and o,
  :func:`mlp`'s hidden, :func:`down_proj`, the vocab or the d_model
  columns of :func:`embed`, :func:`unembed` and :func:`chunked_lm_loss`);
  a norm's scale cut in blocks is read whole (:func:`rms_norm`,
  :func:`layer_norm`), and a norm over a cut activation adds its sums of
  squares over the group; the math is the one-device layer's.  With
  no context the helpers (:func:`whole`, :func:`block_of`,
  :func:`shard` and the collectives) return their input and every layer
  is the one-device code; attention, the MLP and the vocab functions
  run it with whole params too.  Serving on the model axis
  (``launch/serve.py``) hands the families a rank's blocks of the
  caches: :func:`cache_block` and :func:`cache_write` write into them,
  and :func:`decode_attention` attends where they lie.
* Rematerialization (:func:`remat`, the JAX package's ``jax.checkpoint``):
  the families' training forwards keep only each checkpointed unit's
  inputs and run the unit again in the backward; the chunked loss does
  so per chunk.
"""
from __future__ import annotations

import contextlib
import functools
import itertools

import torch
import torch.nn.functional as F
from torch.utils import checkpoint as _ckpt

from repro_torch.device import resolve_device
from repro_torch.kernels.flash_attn import ops as flash_ops
from repro_torch.launch import collectives as coll
from repro_torch.launch.shardings import real_range, slots
from repro_torch.pytree import tree_leaves, tree_map

# ---------------------------------------------------------------------------
# the mesh context: the model axis (installed by the launcher)
# ---------------------------------------------------------------------------

_MESH_CTX = {"mesh": None, "cfg": None, "rows": False}


def set_mesh_context(mesh, *, cfg, rows: bool = False):
    """Install ``mesh`` (a :class:`repro_torch.launch.mesh.HostMesh`) for
    the layers: its ``"model"`` axis carries tensor parallelism.  ``cfg``
    gives the whole shapes that blocks are read against (the JAX package
    reads them from its global arrays).  ``rows``: the batch's rows are
    split over the data axes (serving, ``launch/serve.py``); a layer that
    mixes rows (MoE routing's token groups) then reads the whole batch
    (:func:`rows_group`).  The reference's ``data_axes``, ``model_axis``
    and ``attn_axis`` have no counterpart: inside a client's model the
    data axes play no part (the JAX launcher passes None), the model axis
    is the mesh's ``"model"``, and attention's activations are cut on the
    dim its weights are cut on."""
    _MESH_CTX.update(mesh=mesh, cfg=cfg, rows=bool(rows))


def clear_mesh_context():
    _MESH_CTX.update(mesh=None, cfg=None, rows=False)


def rows_group():
    """The data axes' process group when the batch's rows are split over
    them (serving), else None."""
    return _MESH_CTX["mesh"].group if _MESH_CTX["rows"] else None


def model_group():
    """The model axis's process group, or None (no context, a model axis
    of 1, or no process group)."""
    mesh = _MESH_CTX["mesh"]
    if mesh is None or mesh.shape["model"] == 1:
        return None
    return mesh.model_group


def _axis(g) -> tuple:
    """(size, this rank's coordinate) of the model group ``g``."""
    return (torch.distributed.get_world_size(g),
            torch.distributed.get_rank(g))


def split_dim(w, whole_shape) -> "int | None":
    """The dim along which ``w`` is a model-axis block of a leaf of
    ``whole_shape`` (None: ``w`` is whole): an equal block, or on the
    model axis GSPMD's padded block of a head count
    (``shardings.real_range``)."""
    g = model_group()
    m = None if g is None else _axis(g)[0]
    found = None
    for i, (a, b) in enumerate(zip(w.shape, whole_shape)):
        if a != b:
            if found is not None or (b % a and a != (m and slots(b, m))):
                raise ValueError(f"{tuple(w.shape)} is no block of "
                                 f"{tuple(whole_shape)}")
            found = i
    return found


def whole(w, whole_shape):
    """``w`` whole on every rank: its blocks all-gathered when it is one
    (for replicated compute; padded blocks narrowed to the whole size),
    else ``w`` (always, with no model axis)."""
    g = model_group()
    d = None if g is None else split_dim(w, whole_shape)
    return w if d is None else coll.tp_gather(w, d, g, whole_shape[d])


def block_of(w, whole_shape, dim: int):
    """This rank's block of ``w`` along ``dim`` (for local compute),
    whether ``w`` holds that block, the whole leaf or another block;
    with no model axis, ``w``."""
    g = model_group()
    if g is None or split_dim(w, whole_shape) == dim:
        return w
    return coll.tp_scatter(whole(w, whole_shape), dim, g)


def shard(x, *logical):
    """The JAX package's activation constraint: a replicated activation
    becomes this rank's block along the dim named ``"model"`` (``None``
    and ``"batch"`` entries stay whole: a client's microbatch is not split
    over the data axes).  Without a model axis, ``x``."""
    g = model_group()
    if g is None or "model" not in logical:
        return x
    return coll.tp_scatter(x, logical.index("model"), g)


def _ctx_cfg():
    cfg = _MESH_CTX["cfg"]
    if cfg is None:
        raise ValueError("the model axis needs set_mesh_context(..., cfg=)")
    return cfg


@contextlib.contextmanager
def no_mesh_context():
    """A ``with`` block in which the layers see no mesh context (the
    production round's one-client-per-rank placement runs each client's
    model whole on its rank); the context is restored on exit."""
    saved = dict(_MESH_CTX)
    clear_mesh_context()
    try:
        yield
    finally:
        _MESH_CTX.update(saved)


# ---------------------------------------------------------------------------
# rematerialization (the JAX package's jax.checkpoint)
# ---------------------------------------------------------------------------

# the 2-D matrix products: what jax.checkpoint_policies.
# dots_with_no_batch_dims_saveable saves (matmul over a batch of rows
# folds into mm; attention's batched products are bmm and recomputed)
_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return (_ckpt.CheckpointPolicy.MUST_SAVE if op in _SAVED_DOTS
            else _ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def remat(fn, *args, policy=None):
    """``fn(*args)`` as a rematerialized unit when autograd records (grad
    mode on and a tensor among ``args`` requiring grad): the backward
    keeps only the unit's inputs and runs ``fn`` again to rebuild what it
    needs (``torch.utils.checkpoint.checkpoint``, non-reentrant).  With
    ``policy="dots"`` the unit's 2-D matrix products are saved and the
    rest is recomputed (selective checkpointing).  Otherwise (serving,
    prefill, the loss evals under ``no_grad``) ``fn`` runs as it is, with
    no checkpoint machinery.

    ``preserve_rng_state=False``: no unit draws a random number (the DP
    noise is drawn outside the loss), so there is no RNG state to
    restore, and restoring it would read the device's generator state in
    every unit.  ``determinism_check`` keeps its default: the recompute's
    saved tensors must match the first forward's shapes, dtypes and
    devices.  The recompute re-runs the unit's kernels (``ssd_intra_chunk``
    launches again) and its model-axis collectives, in the same order on
    every rank of a model group, up to the last tensor the backward saved
    (PyTorch's early stop: a layer's MLP down projection, whose output no
    backward saves, and its all-reduce do not run again)."""
    if not (torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad
            for t in tree_leaves(list(args)))):
        return fn(*args)
    kw = {}
    if policy == "dots":
        kw["context_fn"] = functools.partial(
            _ckpt.create_selective_checkpoint_contexts, _dots_policy)
    return _ckpt.checkpoint(fn, *args, use_reentrant=False,
                            preserve_rng_state=False, **kw)

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


def whole_stack(tree, lead):
    """Stacked leaves (leading dims ``lead``) with any leaf the model axis
    cuts on a stacking dim gathered whole: the leaf rule matches dims by
    size, and a layer count can equal a candidate size."""
    g = model_group()
    if g is None:
        return tree

    def fix(v):
        for k, n in enumerate(lead):
            if v.shape[k] != n:
                return coll.tp_gather(v, k, g, n)
        return v

    return tree_map(fix, tree)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def rms_norm(x, scale, eps=1e-6, group=None):
    """RMSNorm over the last dim.  On the model axis a scale cut in blocks
    is read whole; with ``group``, x and scale are this rank's blocks of
    the normed dim and the mean of squares covers the whole dim (the
    blocks' sums of squares added over the group)."""
    x32 = x.float()
    if group is None:
        scale = whole(scale, (x.shape[-1],))
        var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    else:
        ss = torch.sum(torch.square(x32), dim=-1, keepdim=True)
        var = coll.tp_copy(coll.tp_reduce(ss, group), group) / (
            x32.shape[-1] * torch.distributed.get_world_size(group))
    out = x32 * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.float())).to(x.dtype)


def layer_norm(x, scale, bias, eps=1e-5):
    scale, bias = (whole(t, (x.shape[-1],)) for t in (scale, bias))
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


def _attn_shapes(cfg):
    D, H, Hkv, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return {"wq": (D, H, Dh), "wk": (D, Hkv, Dh), "wv": (D, Hkv, Dh),
            "wo": (H, Dh, D)}


def heads_cut(p, cfg) -> bool:
    """Whether the attention params ``p`` run on this rank's query heads:
    wq cut on its heads over the model axis (``attn_shard=
    "heads_padded"``, padded where the axis does not divide them)."""
    g = model_group()
    return g is not None and split_dim(
        p["wq"], _attn_shapes(cfg)["wq"]) == 1


def straddles(n_heads: int, n_kv: int, m: int) -> bool:
    """Whether some rank of a model axis of ``m``, holding padded blocks
    of the ``n_heads`` query and ``n_kv`` kv heads, has a query head
    whose kv head (``h // (n_heads / n_kv)``, GQA) another rank holds: a
    GQA group across two ranks, or kv padding that leaves a rank without
    the kv heads its queries read."""
    rep = n_heads // n_kv
    for r in range(m):
        lo, hi = real_range(n_heads, m, r)
        klo, khi = real_range(n_kv, m, r)
        if lo < hi and (lo // rep < klo or (hi - 1) // rep >= khi):
            return True
    return False


def _in_projs(x, p, cfg, names):
    """``_proj(x, p[n])`` for each name, whole on every rank: a weight cut
    on an output dim projects ``x`` on this rank's columns, and the
    blocks are all-gathered (one call when all are cut on head_dim).
    With wq cut on the heads (:func:`heads_cut`) they are this rank's:
    :func:`_head_projs`."""
    if heads_cut(p, cfg):
        return _head_projs(x, p, cfg, names)
    return _whole_projs(x, p, cfg, names)


def _head_projs(x, p, cfg, names):
    """The projections on this rank's heads (padded blocks narrowed to
    their real heads first, so no product and no gradient touches a zero
    slot): q is this rank's real query heads; k/v its real kv heads, or,
    where some rank of the group reads a kv head it does not hold
    (:func:`straddles`), the kv heads all-gathered whole (replicated).  A
    k/v weight not cut on its heads gives k/v whole."""
    g = model_group()
    m, r = _axis(g)
    shapes = _attn_shapes(cfg)
    xc = coll.tp_copy(x, g)
    gather = straddles(cfg.n_heads, cfg.n_kv_heads, m)
    out = []
    for n in names:
        count = shapes[n][1]
        if n != "wq" and split_dim(p[n], shapes[n]) != 1:
            out += _whole_projs(x, p, cfg, (n,))
            continue
        lo, hi = real_range(count, m, r)
        t = _proj(xc, p[n].narrow(1, 0, hi - lo))
        if n != "wq" and gather:
            t = coll.tp_gather(t, x.dim() - 1, g, count)
        out.append(t)
    return out


def _kv_for_heads(k, v, cfg):
    """k/v as :func:`_head_projs` gives them -> this rank's query heads'
    kv heads, one per query head (the JAX package's ``jnp.repeat`` of the
    kv heads, restricted to this rank's heads): a whole k/v is replicated
    into this rank's compute (:func:`coll.tp_copy`: its gradient is the
    sum of the ranks' parts)."""
    g = model_group()
    m, r = _axis(g)
    rep = cfg.n_heads // cfg.n_kv_heads
    qlo, qhi = real_range(cfg.n_heads, m, r)
    base = 0
    if k.shape[2] == cfg.n_kv_heads:
        k, v = coll.tp_copy(k, g), coll.tp_copy(v, g)
    else:
        base = real_range(cfg.n_kv_heads, m, r)[0]
    idx = [h // rep - base for h in range(qlo, qhi)]
    if idx == list(range(k.shape[2])):
        return k, v
    idx = torch.tensor(idx, dtype=torch.long, device=k.device)
    return k.index_select(2, idx), v.index_select(2, idx)


def _whole_projs(x, p, cfg, names):
    g = model_group()
    shapes = _attn_shapes(cfg)
    ws = [p[n] for n in names]
    dims = ([None] * len(names) if g is None
            else [split_dim(w, shapes[n]) for w, n in zip(ws, names)])
    # a cut input dim (d_model) is no column block: gather that one whole
    ws = [whole(w, shapes[n]) if d == 0 else w
          for w, n, d in zip(ws, names, dims)]
    dims = [None if d == 0 else d for d in dims]
    if all(d is None for d in dims):
        return [_proj(x, w) for w in ws]
    xc = coll.tp_copy(x, g)
    out = [_proj(x, w) if d is None else _proj(xc, w)
           for w, d in zip(ws, dims)]
    if len(set(dims)) == 1 and dims[0] == 2:
        # all cut on head_dim: one gather of the heads side by side
        sizes = [o.shape[2] for o in out]
        return list(torch.split(coll.tp_gather(
            torch.cat(out, dim=2), 3, g), sizes, dim=2))
    return [o if d is None else coll.tp_gather(o, x.dim() - 2 + d, g,
                                               shapes[n][d])
            for o, d, n in zip(out, dims, names)]


def _o_proj(o, wo, cfg):
    """o (B, S, H, Dh) times wo: with wo cut on heads or head_dim, this
    rank's block of o (the JAX package's ``shard(o, ...)``) on its rows,
    the partial sums added over the model group; with wo cut on d_model,
    o on this rank's output columns, all-gathered.  An o of this rank's
    real heads (:func:`_head_projs`) takes wo's real rows."""
    g = model_group()
    shape = _attn_shapes(cfg)["wo"]
    d = None if g is None else split_dim(wo, shape)
    if d is None:
        return _out_proj(o, wo)
    if d == 0 and o.shape[2] != shape[0]:
        return coll.tp_reduce(_out_proj(o, wo.narrow(0, 0, o.shape[2])), g)
    if d == 2:
        return coll.tp_gather(_out_proj(coll.tp_copy(o, g), wo), 2, g)
    axes = [None] * 4
    axes[2 + d] = "model"
    return coll.tp_reduce(_out_proj(shard(o, *axes), wo), g)


def _qkv(x, p, cfg, positions, rope=True):
    q, k, v = _in_projs(x, p, cfg, ("wq", "wk", "wv"))
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

    On the model axis q/k/v come from this rank's columns and are
    all-gathered whole (the leaf rule cuts head_dim, and RoPE pairs dim i
    with i + Dh/2 across the cut), the core runs whole on every rank of
    the group, and o goes through wo's rows (module docstring).  With wq
    cut on the heads (``heads_padded``, :func:`heads_cut`) the core runs
    on this rank's real query heads, each against its kv head
    (:func:`_kv_for_heads`: this rank's own, or the kv heads gathered
    whole where a GQA group or the kv padding crosses ranks), RoPE per
    head, and o goes through wo's real rows; a rank holding padding only
    attends no head and adds zeros.  ``kv_override``'s k/v are then as
    :func:`_qkv` gives them.
    """
    B, S, D = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device).expand(B, S)
    if kv_override is None:
        q, k, v = _qkv(x, p, cfg, positions, rope=rope)
        kv_pos = positions
    else:
        (q,) = _in_projs(x, p, cfg, ("wq",))
        if rope:
            q = apply_rope(q, positions, cfg.rope_theta)
        k, v, kv_pos = kv_override

    if model_group() is not None and q.shape[2] != cfg.n_heads:
        k, v = _kv_for_heads(k, v, cfg)
    o = attend(q, k, v, positions, kv_pos, cfg, window=window,
               causal=causal, q_chunk=q_chunk)
    return _o_proj(o, p["wo"], cfg)


def attend(q, k, v, positions, kv_pos, cfg, *, window: int = 0,
           causal: bool = True, q_chunk: int = 1024):
    """The core of :func:`attention`: q (B, S, H, Dh) against k/v (B, Skv,
    Hkv, Dh) -> (B, S, H, Dh), the heads and the GQA ratio read from the
    tensors, ``cfg`` giving the scale's head_dim and the softcap."""
    S, H = q.shape[1], q.shape[2]
    # no heads (a rank holding padding only) still runs, on empty
    # tensors: its backward makes the group's collectives as every rank's
    rep = H // k.shape[2] if k.shape[2] else 1
    scale = cfg.head_dim ** -0.5
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
        probs = torch.softmax(logits, dim=-1).to(q.dtype)
        return torch.matmul(probs, v_t).permute(0, 2, 1, 3)  # (B, Cq, H, Dh)

    # pick the largest divisor of S that fits the target chunk (S=1500
    # whisper frames, S=4672 vlm patch+text, ... are not 1024-divisible)
    eff_chunk = q_chunk
    while eff_chunk > 1 and S % eff_chunk:
        eff_chunk -= 1
    if S <= q_chunk or eff_chunk < 64:
        return attend_chunk(q, positions)
    return torch.cat([attend_chunk(q[:, i:i + eff_chunk],
                                   positions[:, i:i + eff_chunk])
                      for i in range(0, S, eff_chunk)], dim=1)


def cache_block(t, cache):
    """This rank's block of a whole cache entry ``t``, cut as the cache
    leaf ``cache`` holds it on one of its last two dims (a K or V
    (..., Hkv, Dh) on its kv heads or head_dim, a conv state on its
    channels), or ``t`` itself (a whole leaf, or no model axis)."""
    for d in (-2, -1):
        if t.shape[d] != cache.shape[d]:
            return coll.tp_scatter(t, t.dim() + d, model_group())
    return t


def kv_block(t, cache):
    """:func:`cache_block` of a K or V (..., Hkv, Dh) as :func:`_qkv`
    gives it: whole, or this rank's real kv heads (``heads_padded``, no
    GQA group across ranks), which are the cache's block where the cache
    is cut on the kv heads, and are gathered whole first where it is cut
    on head_dim."""
    g = model_group()
    n = None if g is None else _ctx_cfg().n_kv_heads
    if n is not None and t.shape[-2] != n:
        if tuple(t.shape[-2:]) == tuple(cache.shape[-2:]):
            return t
        t = coll.tp_gather(t, t.dim() - 2, g, n)
    return cache_block(t, cache)


def cache_write(ck, cv, k, v, idx):
    """Write one new token's ``k``/``v`` (B, 1, Hkv, Dh), as :func:`_qkv`
    gives them, at ``idx`` (rows, positions) into one layer's K/V cache
    blocks in place."""
    ck.index_put_(idx, kv_block(k, ck)[:, 0])
    cv.index_put_(idx, kv_block(v, cv)[:, 0])


def decode_attention(q, p, cache_k, cache_v, pos, cfg, *, window: int = 0):
    """One-token decode: q (B, 1, H, Dh) against cache (B, L, Hkv, Dh).

    ``pos`` (B,) int32 is the current position; cache positions are
    0..L-1 and entries > pos (or outside the window) are masked.  The
    attention itself is :func:`repro_torch.kernels.flash_attn.ops.
    flash_decode`: the ``flash_decode`` CUDA kernel on the card, its plain
    version on the CPU.

    On the model axis q is whole (from :func:`_qkv`) and the cache holds
    this rank's block (``launch/serve.py``): cut on the kv heads,
    ``flash_decode`` runs on this rank's kv heads and their query heads,
    and o goes through wo's rows when wo is cut on the heads, else it is
    all-gathered whole over the heads for :func:`_o_proj`; cut on
    head_dim (kv heads that do not divide the model axis), the layer's
    K/V blocks are all-gathered whole and every rank attends all heads.
    With q this rank's real query heads (``heads_padded``):
    :func:`_decode_on_heads`.
    """
    g = model_group()
    if g is not None and q.shape[2] != cfg.n_heads:
        return _decode_on_heads(q, p, cache_k, cache_v, pos, cfg, window)
    kv_cut = cache_k.shape[-2] != cfg.n_kv_heads
    if cache_k.shape[-1] != q.shape[-1]:
        cache_k, cache_v = (coll.tp_gather(c, c.dim() - 1, g).contiguous()
                            for c in (cache_k, cache_v))
    q1 = coll.tp_scatter(q[:, 0], 1, g) if kv_cut else q[:, 0]
    o = flash_ops.flash_decode(q1, cache_k, cache_v, pos, window=window,
                               softcap=cfg.attn_logit_softcap)[:, None]
    if kv_cut:
        if split_dim(p["wo"], _attn_shapes(cfg)["wo"]) == 0:
            return coll.tp_reduce(_out_proj(o, p["wo"]), g)
        o = coll.tp_gather(o, 2, g)
    return _o_proj(o, p["wo"], cfg)


def _decode_on_heads(q, p, cache_k, cache_v, pos, cfg, window):
    """:func:`decode_attention` with q (B, 1, h, Dh) this rank's real query
    heads.  ``flash_decode`` runs on the whole GQA groups of the kv heads
    ``[lo, hi)`` those heads read: q zero-filled to the groups' heads,
    the extra outputs dropped, so the kernel reads each kv head once and
    its ``H % Hkv`` holds.  A cache cut on the kv heads (the axis divides
    them, so the groups are this rank's kv heads) is read where it lies;
    one cut on head_dim is all-gathered and the kv heads ``[lo, hi)``
    taken from it.  o goes through wo's real rows, then an all-reduce; a
    rank holding padding only launches nothing and adds zeros."""
    g = model_group()
    m, r = _axis(g)
    H, Hkv = cfg.n_heads, cfg.n_kv_heads
    rep = H // Hkv
    qlo, qhi = real_range(H, m, r)
    lo, hi = qlo // rep, -(-qhi // rep)
    if cache_k.shape[-2] == Hkv:
        base = 0
        if cache_k.shape[-1] != q.shape[-1]:
            cache_k, cache_v = (coll.tp_gather(c, c.dim() - 1, g)
                                for c in (cache_k, cache_v))
    else:
        base = real_range(Hkv, m, r)[0]
    if qhi == qlo:
        return _o_proj(q, p["wo"], cfg)
    k, v = (c.narrow(-2, lo - base, hi - lo).contiguous()
            for c in (cache_k, cache_v))
    off, nq = qlo - lo * rep, qhi - qlo
    qg = q[:, 0]
    if qg.shape[1] != (hi - lo) * rep:
        qg = q.new_zeros((q.shape[0], (hi - lo) * rep, q.shape[-1]))
        qg[:, off:off + nq] = q[:, 0]
    o = flash_ops.flash_decode(qg, k, v, pos, window=window,
                               softcap=cfg.attn_logit_softcap)
    return _o_proj(o[:, None, off:off + nq], p["wo"], cfg)


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


def _mlp_hidden(x, w_up, w_gate, variant):
    up = torch.matmul(x, w_up)
    if variant == "swiglu":
        return F.silu(torch.matmul(x, w_gate)) * up
    if variant == "geglu":
        # jax.nn.gelu's default is the tanh approximation
        return F.gelu(torch.matmul(x, w_gate), approximate="tanh") * up
    return F.gelu(up, approximate="tanh")


def mlp(x, p, variant="swiglu", d_ff=None):
    """On the model axis the hidden is this rank's block of d_ff (the JAX
    package's ``shard(h, "batch", None, "model")``): w_up/w_gate's
    columns, then w_down as :func:`down_proj` takes it.  ``d_ff`` is the
    hidden's whole width (default the config's; MoE's shared expert and
    the sLSTM's FFN have their own)."""
    g = model_group()
    if g is not None:
        D, Fd = x.shape[-1], d_ff or _ctx_cfg().d_ff
        wide, tall = (D, Fd), (Fd, D)
        cut = [split_dim(p["w_up"], wide), split_dim(p["w_down"], tall)]
        if "w_gate" in p:
            cut.append(split_dim(p["w_gate"], wide))
        if any(d is not None for d in cut):
            gate = p.get("w_gate")
            h = _mlp_hidden(coll.tp_copy(x, g), block_of(p["w_up"], wide, 1),
                            None if gate is None else block_of(gate, wide, 1),
                            variant)
            return down_proj(h, p["w_down"], tall)
    h = _mlp_hidden(x, p["w_up"], p.get("w_gate"), variant)
    return torch.matmul(h, p["w_down"])


def down_proj(h, w, whole_shape):
    """``h @ w`` replicated, from h this rank's block of the hidden (its
    last dim) and w (..., F, D) of ``whole_shape``: w cut on F (or whole)
    takes this rank's rows and the partial outputs are added over the
    group; w cut on D gathers the hidden whole, projects it on this
    rank's columns and gathers those (activations move, never the
    weight).  With no model axis, ``h @ w``."""
    g = model_group()
    if g is None:
        return torch.matmul(h, w)
    n, last = len(whole_shape), h.dim() - 1
    if split_dim(w, whole_shape) == n - 1:
        hw = coll.tp_copy(coll.tp_gather(h, last, g), g)
        return coll.tp_gather(torch.matmul(hw, w), last, g)
    return coll.tp_reduce(torch.matmul(h, block_of(w, whole_shape, n - 2)),
                          g)


def whole_proj(x, w, whole_shape):
    """``x @ w`` whole on every rank, for replicated x and w (D, N): a w
    cut on N projects x on this rank's columns and the blocks are
    all-gathered; a w cut otherwise is read whole."""
    g = model_group()
    if g is not None and split_dim(w, whole_shape) == 1:
        return coll.tp_gather(torch.matmul(coll.tp_copy(x, g), w),
                              x.dim() - 1, g)
    return torch.matmul(x, whole(w, whole_shape))


# ---------------------------------------------------------------------------
# embedding / unembedding
# ---------------------------------------------------------------------------


def init_embedding(gen, vocab, d_model, dtype):
    return dense_init(gen, (vocab, d_model), dtype, fan_in=d_model)


def _table_cut(table):
    """(model group, cut dim, first row) of a (V, D) table on the model
    axis: dim 0 (a block of the vocab, from row ``first row``), 1 (a
    block of the d_model columns) or None (whole, or no model axis)."""
    g = model_group()
    if g is None:
        return None, None, 0
    cfg = _ctx_cfg()
    d = split_dim(table, (cfg.vocab, cfg.d_model))
    lo = table.shape[0] * torch.distributed.get_rank(g) if d == 0 else 0
    return g, d, lo


def embed(tokens, emb):
    """On the model axis, a vocab block per rank: each rank looks up the
    tokens in its rows, zero elsewhere, and the rows are summed over the
    group (one nonzero term per token: exact).  A block of the d_model
    columns per rank: each rank looks up its columns and they are
    all-gathered."""
    g, d, lo = _table_cut(emb)
    if d is None:
        return F.embedding(tokens, emb)
    if d == 1:
        return coll.tp_gather(F.embedding(tokens, emb), tokens.dim(), g)
    local = tokens.long() - lo
    inside = (local >= 0) & (local < emb.shape[0])
    rows = F.embedding(torch.where(inside, local, 0), emb)
    return coll.tp_reduce(torch.where(inside[..., None], rows, 0), g)


def _column_logits(x, W, softcap, g):
    """``unembed`` from this rank's d_model columns of W (V, D / M): this
    rank's block of x times them, the partial logits added over the group
    in f32 and rounded once to x's dtype, as the whole product rounds."""
    xb = shard(x, *([None] * (x.dim() - 1)), "model")
    part = torch.matmul(xb.float(), W.float().t())
    return _softcap(coll.tp_reduce(part, g).to(x.dtype).float(), softcap)


def unembed(x, emb_or_head, softcap: float = 0.0):
    W = emb_or_head
    g, d, _ = _table_cut(W)
    if d is None:
        return _softcap(torch.matmul(x, W.t()).float(), softcap)
    if d == 1:
        return _column_logits(x, W, softcap, g)
    logits = _softcap(torch.matmul(coll.tp_copy(x, g), W.t()).float(),
                      softcap)
    return coll.tp_gather(logits, logits.dim() - 1, g)


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
    of those.  Each chunk is a rematerialized unit (:func:`remat`, the
    JAX package's ``jax.checkpoint(chunk_loss)``): under autograd a chunk
    keeps only its slice of ``h``, and its f32 logits are rebuilt in the
    backward one chunk at a time, so at most one chunk's logits (and
    their gradient) are live at once; the (B, S, V) logits are never
    held whole, in the forward or the backward."""
    B, S, _ = h.shape
    n_chunks = max(1, S // loss_chunk)
    size = S // n_chunks
    if size * n_chunks != S:
        raise ValueError(f"sequence {S} does not split into {n_chunks} "
                         f"chunks of {size}")
    g, d, lo = _table_cut(W)
    if d is None or d == 1:
        # whole, or d_model columns: unembed adds the partial logits
        losses = [remat(_chunk_ce, h[:, i:i + size], labels[:, i:i + size],
                        W, softcap)
                  for i in range(0, S, size)]
    else:
        hc = coll.tp_copy(h, g)
        losses = [remat(_vocab_parallel_ce, hc[:, i:i + size],
                        labels[:, i:i + size], W, softcap, lo, g)
                  for i in range(0, S, size)]
    return torch.mean(torch.stack(losses))


def _chunk_ce(h, labels, W, softcap):
    return cross_entropy_loss(unembed(h, W, softcap), labels, W.shape[0])


def _vocab_parallel_ce(h, labels, W, softcap, lo, group):
    """:func:`cross_entropy_loss` of ``unembed(h, W)`` with W this rank's
    vocab rows from ``lo``: the log-sum-exp from the group's maximum and
    the sum of the ranks' exp-sums, the gold logit from the rank that
    holds it (one all-reduce of both)."""
    logits = _softcap(torch.matmul(h, W.t()).float(), softcap)
    m = coll.tp_max(logits.detach().amax(dim=-1), group)
    sumexp = torch.exp(logits - m[..., None]).sum(dim=-1)
    local = labels.long() - lo
    inside = (local >= 0) & (local < W.shape[0])
    gold = torch.gather(logits, -1, torch.where(inside, local, 0)[..., None])
    gold = torch.where(inside, gold[..., 0], 0.0)
    both = coll.tp_reduce(torch.stack([sumexp, gold]), group)
    return torch.mean(m + torch.log(both[0]) - both[1])
