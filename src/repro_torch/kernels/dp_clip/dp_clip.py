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
  and ``_scale_mean_noise_kernel`` (dp_clip.py:104), and ``scale_mean``
  (dp_clip.py:150) at K = 1: the per-member clipped mean, plus
  ``stddev * z`` under the ``HAS_NOISE`` constexpr.  ``stddev`` is read
  from a one-element device tensor, so changing sigma never recompiles
  (one program per sigma sweep, as on the TPU).  Design:

  - An even grid (:func:`mean_plan`): about ``programs/SM x SM count``
    programs, each owning one contiguous range of ``span`` columns of its
    member, the ranges equal to within 16 columns, so every SM carries
    the same share of the K*D outputs (a grid of fixed 1024-column tiles
    left 46 of 132 SMs with 3 tiles and 86 with 2 at K = 1, the 1.27x
    loss to ``torch.mv``).
  - A program walks its member's B rows ``ROWS`` at a time as one
    ``[ROWS, BLOCK_D]`` tile with the rows' scales as one vector, and
    loads the next tile before it accumulates the current one, so two
    tiles per program are in flight.  D is passed as ``DV * VEC`` so
    that Triton knows the rows are 16-byte aligned when 4 divides D.
  - The tile shape (ROWS, BLOCK_D, warps, programs per SM) is chosen from
    K alone (:data:`MEAN_TILES`, from a sweep on the H100: PERF.md).
    Column c of member m sums its rows in ROWS interleaved partial sums,
    partial r taking rows r, r + ROWS, ... in order, then adds the
    partials: an order fixed by B and K, not by the SM count, so the bits
    do not depend on which Hopper part runs it.

Neither kernel uses atomics and both sum in a fixed order, so reruns are
bit-identical.

Bound on the card: both passes are streaming reductions at ~0.25 FLOP
per byte, far below the H100's ridge point, so HBM bandwidth bounds
them.  Pass 1 reads K*B*D*4 bytes; pass 2 reads K*B*D*4 + K*D*4 and
writes K*D*4.  At B=128, D=317,124 that is ~162 MB per member, i.e.
~0.049 ms at K = 1 and ~0.19-0.20 ms per pass at K = 4 at the data
sheet's 3.35 TB/s (H100 SXM, 700 W).

``triton`` is imported at first launch (:func:`_kernels`), never at
module import: the CPU tests import this module on machines without it.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels.common import cdiv, sm_count

# bound to triton.language by _kernels() at first launch; the kernel
# bodies below resolve ``tl`` through this module's globals when Triton
# compiles them
tl = None

ROUTE = "triton"

BLOCK_D_SQNORM = 4096
# the clipped mean's tile by cohort size K (a K between two listed takes
# the larger one's, a K past the last the last's): (ROWS, BLOCK_D, warps,
# programs per SM).  At D = 317,124 each program's columns fit one
# BLOCK_D (59% of the lanes at K = 1 and 2, 97% at K = 4); a range just
# past BLOCK_D takes two column passes and ran 21% slower in the sweep.
MEAN_TILES = {1: (4, 512, 4, 8), 2: (2, 1024, 4, 8), 4: (1, 512, 2, 20)}

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


def _scale_mean_kernel(g_ptr, scale_ptr, z_ptr, std_ptr, out_ptr, B, DV,
                       span, inv_b, HAS_NOISE: tl.constexpr,
                       VEC: tl.constexpr, ROWS: tl.constexpr,
                       BLOCK_D: tl.constexpr):
    m = tl.program_id(1)
    D = DV * VEC
    c_lo = tl.program_id(0) * span
    c_hi = tl.minimum(c_lo + span, D)
    row0 = m.to(tl.int64) * B
    out0 = m.to(tl.int64) * D
    rows = tl.arange(0, ROWS)
    for c0 in range(c_lo, c_hi, BLOCK_D):
        cols = c0 + tl.arange(0, BLOCK_D)
        cmask = cols < c_hi
        acc = tl.zeros([ROWS, BLOCK_D], dtype=tl.float32)
        s = tl.load(scale_ptr + row0 + rows, mask=rows < B, other=0.0)
        x = tl.load(g_ptr + (row0 + rows)[:, None] * D + cols[None, :],
                    mask=(rows < B)[:, None] & cmask[None, :], other=0.0)
        for b0 in range(ROWS, B + ROWS, ROWS):
            # the next tile's loads are issued before this one is summed
            r = b0 + rows
            s_next = tl.load(scale_ptr + row0 + r, mask=r < B, other=0.0)
            x_next = tl.load(g_ptr + (row0 + r)[:, None] * D + cols[None, :],
                             mask=(r < B)[:, None] & cmask[None, :],
                             other=0.0)
            acc += s[:, None] * x
            s, x = s_next, x_next
        res = tl.sum(acc, axis=0) * inv_b
        if HAS_NOISE:
            std = tl.load(std_ptr)
            res += std * tl.load(z_ptr + out0 + cols, mask=cmask, other=0.0)
        tl.store(out_ptr + out0 + cols, res, mask=cmask)


@functools.lru_cache(maxsize=None)
def _kernels():
    """Import Triton and wrap the kernel bodies (once per process)."""
    global tl
    import triton
    import triton.language as _tl
    tl = _tl
    return triton.jit(_sqnorm_kernel), triton.jit(_scale_mean_kernel)


def mean_tile(k: int):
    """-> (ROWS, BLOCK_D, warps, programs per SM) of the clipped mean at
    cohort size ``k``."""
    return MEAN_TILES[next((t for t in sorted(MEAN_TILES) if t >= k),
                           max(MEAN_TILES))]


def mean_plan(k: int, d: int, n_sm: int):
    """-> (programs per member, columns per program) of the clipped mean:
    about ``programs/SM * n_sm`` programs in all, each owning one
    contiguous range of ``span`` columns (a multiple of 16) of its member;
    only a member's last range may be shorter.  Plain ints in and out."""
    per = max(1, min(cdiv(mean_tile(k)[3] * n_sm, k), cdiv(d, 16)))
    span = 16 * cdiv(cdiv(d, per), 16)
    return cdiv(d, span), span


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
    rows, block_d, warps, _ = mean_tile(k)
    per, span = mean_plan(k, d, sm_count(flat.device))
    vec = 4 if d % 4 == 0 else 1
    # the noise pointers are dead code when HAS_NOISE is False; any
    # device tensor fills the slots
    mean_kernel[(per, k)](
        flat, scales, z if has_noise else scales,
        stddev if has_noise else scales, out, b, d // vec, span,
        float(inv_b), HAS_NOISE=has_noise, VEC=vec, ROWS=rows,
        BLOCK_D=block_d, num_warps=warps)
    scale_mean_launches += 1
    return out
