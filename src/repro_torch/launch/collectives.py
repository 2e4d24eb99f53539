"""Collectives over the mesh's axes, and the process group they run in
(the port's counterpart of what GSPMD inserts into the JAX package's
programs).

The backend is the caller's choice, made by one stated rule
(:func:`choose_backend`) and printed by the launchers:

* ``nccl`` when each rank owns a card;
* ``gloo`` on the CPU;
* ``gloo`` for several ranks sharing one card (NCCL refuses two ranks
  on one GPU).  The CUDA tensors of such ranks go through host memory:
  every collective here copies its CUDA buffer to the host, runs gloo's
  CPU algorithm and copies the result back, for every collective alike
  (gloo's own CUDA variants, where a build has them, stage through
  pinned host memory too).  The copies are written out below and
  counted per collective (``host_staged``).

Nothing here picks a backend or a device behind the caller's back, and a
collective that fails raises.

A ``meta`` tensor (shapes only: ``launch/dryrun.py`` traces one rank's
program) is taken only on a fake process group
(``torch.testing._internal.distributed.fake_pg``, backend ``"fake"``):
the collective returns an output of the shape it would have, moves
nothing, stages nothing, and is counted in :func:`stats` exactly as a
real call is.

Every function takes the process group of one mesh axis (``mesh.group``
for the data axis, ``mesh.model_group`` for the model axis).
Trees are moved in buckets: consecutive leaves of one dtype are packed
into one flat buffer of at most :data:`BUCKET_BYTES`, one collective per
bucket.  :func:`stats` counts each collective's calls, the bytes of
this rank's input buffers, how many went through host memory, and the
host seconds spent in them (the whole call where it is host-staged or
on the CPU; an NCCL call returns before the card has finished).

The model axis (tensor parallelism inside one client's model) is carried
by four ``autograd`` functions over the model group, Megatron's pair and
its two reshapes (:func:`tp_copy`, :func:`tp_reduce`, :func:`tp_gather`,
:func:`tp_scatter`).  Each tensor of a model-parallel forward is either
*replicated* (the same bits on every rank of the group, its gradient
computed whole on each) or *local* (this rank's own block or partial
sum); the four functions are the only ways from one to the other, and
each one's backward is the other side's forward, so a replicated
tensor's gradient is whole and equal on every rank.
"""
from __future__ import annotations

import socket
import time
import warnings
from datetime import timedelta

import torch
import torch.distributed as dist

from repro_torch.launch.shardings import pad_to, real_range, slots
from repro_torch.pytree import tree_leaves, tree_unflatten_like

BUCKET_BYTES = 256 << 20

_LEDGER: dict = {}


def stats() -> dict:
    """``{collective: {"calls", "bytes", "host_staged", "seconds",
    "by_group"}}`` since the last :func:`reset_stats` (bytes: this
    rank's input buffers; ``by_group``: ``{group size: {"calls",
    "bytes"}}``, which ``analysis/hlo.py`` turns into link traffic)."""
    return {k: dict(v, by_group={g: dict(c) for g, c in
                                 v["by_group"].items()})
            for k, v in _LEDGER.items()}


def reset_stats():
    _LEDGER.clear()


def _note(name: str, nbytes: int, staged: bool, t0: float, group):
    e = _LEDGER.setdefault(name, {"calls": 0, "bytes": 0, "host_staged": 0,
                                  "seconds": 0.0, "by_group": {}})
    e["calls"] += 1
    e["bytes"] += int(nbytes)
    e["host_staged"] += int(staged)
    e["seconds"] += time.perf_counter() - t0
    g = e["by_group"].setdefault(dist.get_world_size(group),
                                 {"calls": 0, "bytes": 0})
    g["calls"] += 1
    g["bytes"] += int(nbytes)


# ---------------------------------------------------------------------------
# the process group
# ---------------------------------------------------------------------------

def choose_backend(device_type: str, world: int, cards: int = 0) -> str:
    """The backend rule: ``nccl`` when each of the ``world`` ranks owns a
    card (``device_type == "cuda"`` and ``world <= cards``), else
    ``gloo`` (the CPU, or several ranks on one card)."""
    if device_type == "cuda" and world <= cards:
        return "nccl"
    return "gloo"


def rank_device(device_type: str, rank: int, cards: int = 0) -> torch.device:
    """Rank ``rank``'s device: ``cuda:<rank mod cards>`` on the card(s),
    else the CPU."""
    if device_type == "cuda":
        if cards < 1:
            raise RuntimeError("no CUDA device for a cuda rank")
        return torch.device("cuda", rank % cards)
    return torch.device("cpu")


def free_port() -> int:
    """A free TCP port on localhost for the group's rendezvous."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def init_group(backend: str, rank: int, world: int, port: int,
               device=None, timeout_s: float = 600.0):
    """Join the process group at ``tcp://localhost:<port>``; NCCL ranks
    bind their card first."""
    if backend == "nccl":
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend, init_method=f"tcp://localhost:{port}", rank=rank,
        world_size=world, timeout=timedelta(seconds=timeout_s))


def describe(group, device) -> str:
    """One line naming the group's backend and how CUDA tensors move."""
    backend = dist.get_backend(group)
    dev = torch.device(device)
    note = ""
    if backend == "gloo" and dev.type == "cuda":
        note = (" (CUDA tensors staged through host memory for every "
                "collective)")
    return (f"backend {backend}, world {dist.get_world_size(group)}, rank "
            f"{dist.get_rank(group)} on {dev}{note}")


def _staged(x: torch.Tensor, group) -> bool:
    return x.is_cuda and dist.get_backend(group) == "gloo"


def _meta(x: torch.Tensor, group) -> bool:
    """Whether ``x`` is a ``meta`` tensor, whose collective only takes
    its output's shape: on a fake group, else a ValueError (the ranks of
    a real group would wait for a call that never comes)."""
    if x.device.type != "meta":
        return False
    if dist.get_backend(group) != "fake":
        raise ValueError("a meta tensor's collective runs only on a fake "
                         f"process group, not {dist.get_backend(group)}")
    return True


def _host(x: torch.Tensor, staged: bool) -> torch.Tensor:
    return x.cpu() if staged else x


def _buffer(x: torch.Tensor, staged: bool) -> torch.Tensor:
    """A contiguous copy of ``x`` for an in-place collective (NCCL refuses
    a strided tensor, such as the gradient of a chunk's view), on the
    host when ``staged``."""
    x = x.detach()
    return (x.contiguous().cpu() if staged
            else x.clone(memory_format=torch.contiguous_format))


def _back(y: torch.Tensor, like: torch.Tensor, staged: bool) -> torch.Tensor:
    return y.to(like.device) if staged else y


def _call(fn_new: str, fn_old: str):
    fn = getattr(dist, fn_new, None)
    return fn if fn is not None else getattr(dist, fn_old)


# ---------------------------------------------------------------------------
# tensor collectives
# ---------------------------------------------------------------------------

def all_gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``x`` stacked on dim 0 in rank order: (W * n, ...)."""
    t0 = time.perf_counter()
    staged = _staged(x, group)
    w = dist.get_world_size(group)
    src = _host(x.contiguous(), staged)
    out = torch.empty((w * x.shape[0],) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=src.device)
    if not _meta(x, group):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", FutureWarning)
            _call("all_gather_single", "all_gather_into_tensor")(
                out, src, group=group)
    out = _back(out, x, staged)
    _note("all_gather", x.numel() * x.element_size(), staged, t0, group)
    return out


def reduce_scatter_rows(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over ranks of ``x`` (W * n, ...), this rank's n rows."""
    t0 = time.perf_counter()
    staged = _staged(x, group)
    w = dist.get_world_size(group)
    if x.shape[0] % w:
        raise ValueError(f"reduce_scatter of {tuple(x.shape)} over {w} ranks")
    src = _host(x.contiguous(), staged)
    out = torch.empty((x.shape[0] // w,) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=src.device)
    if not _meta(x, group):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", FutureWarning)
            _call("reduce_scatter_single", "reduce_scatter_tensor")(
                out, src, group=group)
    out = _back(out, x, staged)
    _note("reduce_scatter", x.numel() * x.element_size(), staged, t0, group)
    return out


def all_reduce_sum(x: torch.Tensor, group, op=None) -> torch.Tensor:
    """The sum over ranks of ``x`` (a new tensor); ``op`` another
    ``dist.ReduceOp`` (``MAX``)."""
    t0 = time.perf_counter()
    staged = _staged(x, group)
    buf = _buffer(x, staged)
    if not _meta(x, group):
        dist.all_reduce(buf, op=op or dist.ReduceOp.SUM, group=group)
    buf = _back(buf, x, staged)
    _note("all_reduce", x.numel() * x.element_size(), staged, t0, group)
    return buf


def broadcast(x: torch.Tensor, src: int, group) -> torch.Tensor:
    """Rank ``src``'s ``x`` on every rank (a new tensor)."""
    t0 = time.perf_counter()
    staged = _staged(x, group)
    buf = _buffer(x, staged)
    if not _meta(x, group):
        dist.broadcast(buf, src=dist.get_global_rank(group, src),
                       group=group)
    buf = _back(buf, x, staged)
    _note("broadcast", x.numel() * x.element_size(), staged, t0, group)
    return buf


def barrier(group):
    t0 = time.perf_counter()
    dist.barrier(group=group)
    _note("barrier", 0, False, t0, group)


# ---------------------------------------------------------------------------
# trees, in buckets
# ---------------------------------------------------------------------------

def _buckets(items, width):
    """Group ``(index, tensor)`` items into runs of one dtype of at most
    :data:`BUCKET_BYTES` (per row of ``width(t)`` elements)."""
    out, cur, cur_bytes = [], [], 0
    for i, t in items:
        nbytes = width(t) * t.element_size()
        if cur and (t.dtype != cur[0][1].dtype
                    or cur_bytes + nbytes > BUCKET_BYTES):
            out.append(cur)
            cur, cur_bytes = [], 0
        cur.append((i, t))
        cur_bytes += nbytes
    if cur:
        out.append(cur)
    return out


def gather_members(tree, group):
    """Every rank's stacked (k, ...) members, stacked in rank order:
    each leaf becomes (W * k, ...), rank r's rows at ``r*k .. r*k+k-1``."""
    leaves = tree_leaves(tree)
    out = [None] * len(leaves)
    for bucket in _buckets(enumerate(leaves),
                           lambda t: t[0].numel() if t.dim() else 1):
        k = bucket[0][1].shape[0]
        flat = torch.cat([t.reshape(k, -1) for _, t in bucket], dim=1)
        full = all_gather_rows(flat, group)
        off = 0
        for i, t in bucket:
            n = t[0].numel()
            out[i] = full[:, off:off + n].reshape(
                (full.shape[0],) + tuple(t.shape[1:]))
            off += n
    return tree_unflatten_like(tree, out)


def _rows(t: torch.Tensor, dim: int, w: int) -> torch.Tensor:
    """``t`` split in ``w`` equal chunks along ``dim``: (w, chunk numel)."""
    return t.movedim(dim, 0).reshape(w, -1)


def all_gather_tree(tree, dims, group):
    """Whole leaves from this rank's shards: leaf j, split along
    ``dims[j]`` (None: replicated, returned as is), is all-gathered and
    its W chunks joined along that dim in rank order.  A group of one
    rank moves nothing: its shards are whole."""
    w = dist.get_world_size(group)
    if w == 1:
        return tree
    leaves = tree_leaves(tree)
    out = list(leaves)
    split = [(j, t) for j, t in enumerate(leaves) if dims[j] is not None]
    for bucket in _buckets(split, lambda t: t.numel()):
        flat = torch.cat([t.movedim(dims[j], 0).reshape(1, -1)
                          for j, t in bucket], dim=1)
        full = all_gather_rows(flat, group)          # (W, N)
        off = 0
        for j, t in bucket:
            n, d = t.numel(), dims[j]
            moved = t.movedim(d, 0)
            whole = full[:, off:off + n].reshape(
                (w * moved.shape[0],) + tuple(moved.shape[1:]))
            out[j] = whole.movedim(0, d).contiguous()
            off += n
    return tree_unflatten_like(tree, out)


def reduce_scatter_tree(tree, dims, group):
    """The sum over ranks of whole leaves, each left as this rank's shard:
    leaf j is reduce-scattered along ``dims[j]``, or all-reduced whole
    where that is None (a replicated leaf).  A group of one rank moves
    nothing: the sum is the tree."""
    w = dist.get_world_size(group)
    if w == 1:
        return tree
    leaves = tree_leaves(tree)
    out = [None] * len(leaves)
    split = [(j, t) for j, t in enumerate(leaves) if dims[j] is not None]
    for bucket in _buckets(split, lambda t: t.numel() // w):
        flat = torch.cat([_rows(t, dims[j], w) for j, t in bucket], dim=1)
        mine = reduce_scatter_rows(flat, group)      # (1, N)
        off = 0
        for j, t in bucket:
            d = dims[j]
            moved = t.movedim(d, 0)
            chunk = (moved.shape[0] // w,) + tuple(moved.shape[1:])
            n = int(torch.Size(chunk).numel())
            out[j] = mine[0, off:off + n].reshape(chunk).movedim(
                0, d).contiguous()
            off += n
    repl = [(j, t) for j, t in enumerate(leaves) if dims[j] is None]
    for bucket in _buckets(repl, lambda t: t.numel()):
        flat = torch.cat([t.reshape(-1) for _, t in bucket])
        total = all_reduce_sum(flat, group)
        off = 0
        for j, t in bucket:
            out[j] = total[off:off + t.numel()].reshape(t.shape)
            off += t.numel()
    return tree_unflatten_like(tree, out)


# ---------------------------------------------------------------------------
# the model axis: tensor-parallel autograd functions
# ---------------------------------------------------------------------------

def _sum_f32(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over ranks, added in f32 and rounded once to ``x``'s dtype
    (two bf16 partial sums added in bf16 would round twice)."""
    if x.dtype in (torch.bfloat16, torch.float16):
        return all_reduce_sum(x.float(), group).to(x.dtype)
    return all_reduce_sum(x, group)


def _gather_dim(x: torch.Tensor, dim: int, group, n=None) -> torch.Tensor:
    """Every rank's ``x`` joined along ``dim`` in rank order.  With ``n``
    each rank's ``x`` holds its real slots of a dim of ``n`` cut in
    padded blocks (``shardings.real_range``; ``x`` may be the padded
    block itself): the blocks are padded, joined and narrowed to ``n``."""
    w = dist.get_world_size(group)
    if n is not None:
        x = pad_to(x, dim, slots(n, w))
    moved = x.movedim(dim, 0)
    full = all_gather_rows(moved.reshape(1, -1), group)
    full = full.reshape((w * moved.shape[0],) + tuple(
        moved.shape[1:])).movedim(0, dim)
    return full if n is None else full.narrow(dim, 0, n)


def _chunk(x: torch.Tensor, dim: int, group, keep=None) -> torch.Tensor:
    """This rank's block of ``x`` along ``dim``: an equal chunk, or where
    the ranks do not divide the dim its padded block (the real slots,
    then zeros).  ``keep``: the leading slots of the block to keep."""
    w, r = dist.get_world_size(group), dist.get_rank(group)
    n = x.shape[dim]
    lo, hi = real_range(n, w, r)
    out = pad_to(x.narrow(dim, lo, hi - lo), dim, slots(n, w))
    return (out if keep is None else out.narrow(dim, 0, keep)).contiguous()


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum_f32(g, ctx.group), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _sum_f32(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, n):
        ctx.dim, ctx.group, ctx.keep = dim, group, x.shape[dim]
        return _gather_dim(x, dim, group, n)

    @staticmethod
    def backward(ctx, g):
        return _chunk(g, ctx.dim, ctx.group, ctx.keep), None, None, None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group, ctx.n = dim, group, x.shape[dim]
        return _chunk(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _gather_dim(g, ctx.dim, ctx.group, ctx.n), None, None


def tp_copy(x: torch.Tensor, group) -> torch.Tensor:
    """Replicated ``x`` into local compute: the identity, whose backward
    sums the ranks' partial gradients (an all-reduce).  With no group
    (no model axis) this and the functions below return ``x``."""
    return x if group is None else _Copy.apply(x, group)


def tp_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """The ranks' partial sums -> the replicated sum (an all-reduce, added
    in f32); the backward passes the whole gradient to every partial."""
    return x if group is None else _Reduce.apply(x, group)


def tp_gather(x: torch.Tensor, dim: int, group, n=None) -> torch.Tensor:
    """The ranks' blocks along ``dim`` -> the replicated whole (an
    all-gather); the backward keeps this rank's block of the gradient.
    ``n``: the whole dim's size when the ranks hold padded blocks of it
    (``x`` this rank's real slots, or its padded block): the result is
    narrowed to ``n``, and the backward gives ``x``'s slots."""
    return x if group is None else _Gather.apply(x, dim, group, n)


def tp_scatter(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Replicated ``x`` -> this rank's block along ``dim`` (no
    communication): an equal block, or GSPMD's padded block where the
    ranks do not divide the dim; the backward all-gathers the blocks'
    gradients (narrowed to the dim's size)."""
    return x if group is None else _Scatter.apply(x, dim, group)


def tp_max(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise maximum over the ranks (no gradient)."""
    return x if group is None else all_reduce_sum(x, group,
                                                  op=dist.ReduceOp.MAX)
