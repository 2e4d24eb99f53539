"""Launcher of the flash decode kernels, CUDA C++ for Hopper
(``kernels/csrc/flash_decode.cu``).

They replace the Pallas TPU kernel ``flash_decode`` of
``repro/kernels/flash_attn/flash_attn.py``; the source's note gives the
bound on the H100 and what the design does about it.  One launch is a
split-S kernel followed by a merge kernel; it counts once.  The split
plan (:func:`split_plan`) depends on the shapes and the SM count only,
never on a device value, so the launch never waits on the card.  The
library is built at the first launch (:mod:`repro_torch.kernels.build`).
The output and the f32 scratch of the splits' partials are allocated here
with ``torch.empty``; the kernels run on PyTorch's current stream and
allocate nothing.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import (
    cdiv, check_launchable, check_no_grad, check_tensor, sm_count)

ROUTE = "cuda"
DTYPES = (torch.float32, torch.bfloat16)
HEAD_DIMS = (32, 64, 96, 128, 256)  # the kernel's lanes own Dh / 32 dims
HEADS_PER_BLOCK = (1, 2, 4, 8)      # query heads one block serves
CHUNK_KEYS = 64                     # keys per chunk; chunks go to splits in turn
BLOCKS_PER_SM = 8                   # split blocks resident per SM (64 registers)

# launch counter: one per kernel launch, added where the kernel launches
flash_decode_launches = 0


def launches() -> int:
    return flash_decode_launches


def reset_launches() -> None:
    global flash_decode_launches
    flash_decode_launches = 0


def check_inputs(q, k, v, pos):
    """Shapes, dtypes and devices of both routes -> (B, H, S, Hkv, Dh).

    q (B,H,Dh) f32 or bf16; k, v (B,S,Hkv,Dh) in q's dtype with
    H % Hkv == 0; pos (B,) int32, all on q's device."""
    if q.dim() != 3 or k.dim() != 4:
        raise ValueError(f"q must be (B,H,Dh) and k (B,S,Hkv,Dh): "
                         f"{tuple(q.shape)} {tuple(k.shape)}")
    B, H, Dh = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    if Hkv == 0 or H % Hkv:
        raise ValueError(f"H={H} must be a multiple of Hkv={Hkv}")
    check_tensor("q", q, (B, H, Dh), DTYPES, q.device)
    check_tensor("k", k, (B, S, Hkv, Dh), (q.dtype,), q.device)
    check_tensor("v", v, (B, S, Hkv, Dh), (q.dtype,), q.device)
    check_tensor("pos", pos, (B,), (torch.int32,), q.device)
    return B, H, S, Hkv, Dh


def heads_per_block(rep: int) -> int:
    """Query heads one block serves: the GQA ratio rounded up to 1, 2, 4
    or 8 (above 8, blocks of 8 heads; K and V are then read once per 8)."""
    return next((r for r in HEADS_PER_BLOCK if r >= rep), HEADS_PER_BLOCK[-1])


def split_plan(S: int, B: int, H: int, Hkv: int, n_sm: int):
    """-> (n_split, chunk): the keys are cut into chunks of ``chunk`` keys
    and split s takes chunks s, s + n_split, s + 2 n_split, ...; every
    split gets at least one chunk.

    Plain ints in, plain ints out: the plan reads nothing from the card.
    It takes at most as many splits as fill the card with one wave of
    ``BLOCKS_PER_SM`` blocks per SM, and at least half as many; of those,
    the count that deals the chunks out most evenly (the largest on a
    tie).  zamba2-1.2b's decode (B=8, S=2112 = 33 chunks, 32 kv heads) on
    132 SMs may take 2 to 4 splits and takes 3, of 11 chunks each, in 768
    blocks."""
    rep = H // Hkv
    blocks = B * Hkv * cdiv(rep, heads_per_block(rep))
    n_chunks = cdiv(S, CHUNK_KEYS)
    most = max(1, min(n_chunks, BLOCKS_PER_SM * n_sm // blocks))
    n_split = max(range(cdiv(most, 2), most + 1),
                  key=lambda n: (n_chunks / (n * cdiv(n_chunks, n)), n))
    return n_split, CHUNK_KEYS


def flash_decode(q, k, v, pos, *, window: int = 0,
                 softcap: float = 0.0) -> torch.Tensor:
    """One launch (split kernel + merge kernel) -> (B, H, Dh) in q's
    dtype."""
    global flash_decode_launches
    B, H, S, Hkv, Dh = check_inputs(q, k, v, pos)
    for name, t in (("q", q), ("k", k), ("v", v), ("pos", pos)):
        check_launchable(name, t)
    check_no_grad("flash_decode", q, k, v)
    if Dh not in HEAD_DIMS:
        raise ValueError(f"head dim {Dh} not in {HEAD_DIMS}")
    n_split, chunk = split_plan(S, B, H, Hkv, sm_count(q.device))
    out = torch.empty_like(q)
    part = torch.empty(B * H * n_split * (Dh + 2), dtype=torch.float32,
                       device=q.device)
    lib = build.library()
    fn = (lib.flash_decode_bf16 if q.dtype == torch.bfloat16
          else lib.flash_decode_f32)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(),
                 part.data_ptr(), out.data_ptr(), B, H, S, Hkv, Dh,
                 heads_per_block(H // Hkv), n_split, chunk, int(window),
                 float(Dh ** -0.5), float(softcap),
                 build.stream_ptr(q.device))
    build.check(err, "flash_decode")
    flash_decode_launches += 1
    return out
