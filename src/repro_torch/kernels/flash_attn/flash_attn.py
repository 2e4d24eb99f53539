"""Launcher of the flash decode kernel, CUDA C++ for Hopper
(``kernels/csrc/flash_decode.cu``).

It replaces the Pallas TPU kernel ``flash_decode`` of
``repro/kernels/flash_attn/flash_attn.py``; the source's note gives its
bound on the H100 and what the design does about it.  The library is
built at the first launch (:mod:`repro_torch.kernels.build`).  The output
is allocated here with ``torch.empty``; the kernel runs on PyTorch's
current stream and allocates nothing.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import check_launchable, check_tensor

ROUTE = "cuda"
DTYPES = (torch.float32, torch.bfloat16)
HEAD_DIMS = (32, 64, 128, 256)      # the kernel's lanes own Dh / 32 dims

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


def flash_decode(q, k, v, pos, *, window: int = 0,
                 softcap: float = 0.0) -> torch.Tensor:
    """One kernel launch -> (B, H, Dh) in q's dtype."""
    global flash_decode_launches
    B, H, S, Hkv, Dh = check_inputs(q, k, v, pos)
    for name, t in (("q", q), ("k", k), ("v", v), ("pos", pos)):
        check_launchable(name, t)
    if Dh not in HEAD_DIMS:
        raise ValueError(f"head dim {Dh} not in {HEAD_DIMS}")
    out = torch.empty_like(q)
    lib = build.library()
    fn = (lib.flash_decode_bf16 if q.dtype == torch.bfloat16
          else lib.flash_decode_f32)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(),
                 out.data_ptr(), B, H, S, Hkv, Dh, int(window),
                 float(Dh ** -0.5), float(softcap),
                 build.stream_ptr(q.device))
    build.check(err, "flash_decode")
    flash_decode_launches += 1
    return out
