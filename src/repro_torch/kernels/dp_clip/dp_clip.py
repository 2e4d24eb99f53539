"""Fused per-example clip + mean (+ noise) as two Triton kernels for
Hopper — the DP-SGD hot spot of every local step on the ``"pallas"``
DP path (the config string keeps its reference meaning).

Replaces the Pallas TPU kernels of ``repro/kernels/dp_clip/dp_clip.py``:

* ``_sqnorm_kernel``  <- ``sqnorms`` / ``_sqnorm_kernel`` (dp_clip.py:88):
  grid (K*B,), one program per row; it walks the row in ``BLOCK_D``
  chunks with an f32 register accumulator and masks the ragged tail
  itself, so nothing is zero-padded to a tile multiple (the TPU version
  pads to (128, 512) tiles and carries the sum across its sequential
  grid axis, which Hopper's unordered blocks cannot do).
* ``_scale_mean_kernel`` <- ``cohort_scale_mean`` / ``_scale_mean_kernel``
  and ``_scale_mean_noise_kernel`` (dp_clip.py:104): grid
  (K, cdiv(D, BLOCK_D)); each program loops over its member's B rows in
  fixed order, accumulating ``scale_b * g_b`` in f32 registers (the loop
  replaces the TPU's sequential row-tile grid axis), multiplies by
  ``inv_b`` and, under the ``HAS_NOISE`` constexpr, adds
  ``stddev * z[m, tile]``.  ``stddev`` is read from a one-element device
  tensor, so changing sigma never recompiles (one program per sigma
  sweep, as on the TPU).

Neither kernel uses atomics and both sum in a fixed order, so reruns are
bit-identical.

Bound on the card: both passes are streaming reductions at ~0.25 FLOP
per byte, far below the H100's ridge point, so HBM bandwidth bounds
them.  Pass 1 reads K*B*D*4 bytes; pass 2 reads K*B*D*4 + K*D*4 and
writes K*D*4.  At K=4, B=128, D=317,124 that is ~649 MB per pass, i.e.
at least ~0.19 ms each at the data sheet's 3.35 TB/s (H100 SXM, 700 W).
Triton's masked, vectorised block loads reach for that bound as readily
as hand-written CUDA would; there is no matrix product for tensor cores.

``triton`` is imported at first launch (:func:`_kernels`), never at
module import: the CPU tests import this module on machines without it.
"""
from __future__ import annotations

import functools

import torch

# bound to the triton modules by _kernels() at first launch; the kernel
# bodies below resolve ``tl`` through this module's globals when Triton
# compiles them
triton = None
tl = None

BLOCK_D_SQNORM = 4096
BLOCK_D_MEAN = 1024

# launch counters: each wrapper adds one exactly where it launches its
# kernel (a run shows it went through the kernels by these moving)
sqnorm_launches = 0
scale_mean_launches = 0


def launches() -> int:
    return sqnorm_launches + scale_mean_launches


def reset_launches() -> None:
    global sqnorm_launches, scale_mean_launches
    sqnorm_launches = 0
    scale_mean_launches = 0


def _sqnorm_kernel(g_ptr, out_ptr, D, BLOCK_D: tl.constexpr):
    row = tl.program_id(0)
    base = g_ptr + row.to(tl.int64) * D
    acc = tl.zeros([BLOCK_D], dtype=tl.float32)
    for start in range(0, D, BLOCK_D):
        offs = start + tl.arange(0, BLOCK_D)
        x = tl.load(base + offs, mask=offs < D, other=0.0)
        acc += x * x
    tl.store(out_ptr + row, tl.sum(acc, axis=0))


def _scale_mean_kernel(g_ptr, scale_ptr, z_ptr, std_ptr, out_ptr, B, D,
                       inv_b, HAS_NOISE: tl.constexpr,
                       BLOCK_D: tl.constexpr):
    m = tl.program_id(0)
    j = tl.program_id(1)
    offs = j * BLOCK_D + tl.arange(0, BLOCK_D)
    mask = offs < D
    row0 = m.to(tl.int64) * B
    acc = tl.zeros([BLOCK_D], dtype=tl.float32)
    for b in range(0, B):
        s = tl.load(scale_ptr + row0 + b)
        x = tl.load(g_ptr + (row0 + b) * D + offs, mask=mask, other=0.0)
        acc += s * x
    acc = acc * inv_b
    if HAS_NOISE:
        std = tl.load(std_ptr)
        zt = tl.load(z_ptr + m.to(tl.int64) * D + offs, mask=mask, other=0.0)
        acc += std * zt
    tl.store(out_ptr + m.to(tl.int64) * D + offs, acc, mask=mask)


@functools.lru_cache(maxsize=None)
def _kernels():
    """Import Triton and wrap the kernel bodies (once per process)."""
    global triton, tl
    import triton as _triton
    import triton.language as _tl
    triton, tl = _triton, _tl
    return _triton.jit(_sqnorm_kernel), _triton.jit(_scale_mean_kernel)


def _check_cuda_f32(name, t, shape):
    if t.device.type != "cuda":
        raise ValueError(f"{name} must lie on a CUDA device: {t.device}")
    if t.dtype != torch.float32:
        raise ValueError(f"{name} must be float32: {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")


def sqnorms(flat: torch.Tensor) -> torch.Tensor:
    """(R, D) f32 CUDA rows -> (R,) squared norms, one kernel launch."""
    global sqnorm_launches
    if flat.dim() != 2:
        raise ValueError(f"flat must be 2-D: {tuple(flat.shape)}")
    r, d = flat.shape
    _check_cuda_f32("flat", flat, (r, d))
    out = torch.empty((r,), dtype=torch.float32, device=flat.device)
    sq_kernel, _ = _kernels()
    sq_kernel[(r,)](flat, out, d, BLOCK_D=BLOCK_D_SQNORM, num_warps=8)
    sqnorm_launches += 1
    return out


def cohort_scale_mean(flat: torch.Tensor, scales: torch.Tensor, *, k: int,
                      inv_b: float, z=None, stddev=None) -> torch.Tensor:
    """Per-member clipped mean over a stacked cohort, one kernel launch.

    flat (K*B, D) member-major rows, scales (K*B,), optional z (K, D) with
    stddev a one-element f32 tensor -> (K, D) f32 means (noised when z is
    given)."""
    global scale_mean_launches
    if flat.dim() != 2 or flat.shape[0] % k:
        raise ValueError(
            f"flat must be (K*B, D) with K={k}: {tuple(flat.shape)}")
    r, d = flat.shape
    b = r // k
    _check_cuda_f32("flat", flat, (r, d))
    _check_cuda_f32("scales", scales, (r,))
    has_noise = z is not None
    if has_noise:
        _check_cuda_f32("z", z, (k, d))
        _check_cuda_f32("stddev", stddev, (1,))
    out = torch.empty((k, d), dtype=torch.float32, device=flat.device)
    _, mean_kernel = _kernels()
    # the noise pointers are dead code when HAS_NOISE is False; any
    # device tensor fills the slots
    mean_kernel[(k, triton.cdiv(d, BLOCK_D_MEAN))](
        flat, scales, z if has_noise else scales,
        stddev if has_noise else scales, out, b, d, float(inv_b),
        HAS_NOISE=has_noise, BLOCK_D=BLOCK_D_MEAN, num_warps=4)
    scale_mean_launches += 1
    return out
