"""Fused per-example clip + mean (+ noise) as Triton kernels for Hopper —
the DP-SGD hot spot of every local step on the ``"pallas"`` DP path (the
config string keeps its reference meaning).

Why Triton and not CUDA C++: both passes are bandwidth-bound streaming
reductions over an (R, D) f32 matrix with no matrix product, so what
decides their speed is how many 16-byte loads are in flight on every SM,
which Triton's tiles express directly.

Replaces the Pallas TPU kernels of ``repro/kernels/dp_clip/dp_clip.py``:

* ``_sqnorm_kernel`` + ``_sqnorm_finish_kernel`` <- ``sqnorms`` /
  ``_sqnorm_kernel`` (dp_clip.py:88, body :43): per-row ||g_i||^2 in f32.
  The TPU carries each row's sum along a sequential D grid axis, which
  Hopper's unordered blocks cannot do.  Here:

  - An even split-D grid (:func:`sqnorm_plan`): the rows go ``ROWS`` to a
    tile and D is cut into ``n_splits`` column ranges whose widths are
    multiples of 16 and equal to within 16 columns; one program per
    (range, row tile), about 16 programs per SM of an H100 SXM (with
    one program per row, the first design, 124 of 132 SMs carried two
    rows and 8 one at K = 2).
  - A program walks its range as ``[ROWS, BLOCK_D]`` tiles and loads the
    next tile before it sums the current one, so two tiles per program
    are in flight; D is passed as ``DV * VEC`` so the loads are 16 bytes
    wide when 4 divides D.  It writes its ROWS partial sums to an
    (n_splits, R) f32 scratch buffer.
  - ``_sqnorm_finish_kernel`` adds each row's partials in split order.
    One "launch" of the norms pass counts one :func:`sqnorms` call: both
    kernels, in that order.
  - The plan is sized for 132 SMs whatever part runs it, so the sum order
    depends on (R, D) only: the same inputs give the same bits on a
    132-SM and a 114-SM part.
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

No kernel uses atomics and all sum in a fixed order, so reruns are
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

from repro_torch.kernels.common import cdiv, check_no_grad, sm_count

# bound to triton.language by _kernels() at first launch; the kernel
# bodies below resolve ``tl`` through this module's globals when Triton
# compiles them
tl = None

ROUTE = "triton"

# the norms pass: a tile holds SQNORM_TILE_ELEMS values (ROWS x BLOCK_D);
# the plan aims at SQNORM_TILES row tiles and SQNORM_PER_SM programs per
# SM on SQNORM_SMS SMs (an H100 SXM), whatever part runs it, so the split
# of D depends on (R, D) only; the finishing kernel unrolls over at most
# SQNORM_MAX_SPLITS splits
SQNORM_SMS = 132
SQNORM_TILE_ELEMS = 4096
SQNORM_TILES = 64
SQNORM_PER_SM = 16
SQNORM_MAX_SPLITS = 64
SQNORM_WARPS = 4
SQNORM_FINISH_ROWS = 128
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


def _sqnorm_kernel(g_ptr, part_ptr, R, DV, width, n_narrow,
                   VEC: tl.constexpr, ROWS: tl.constexpr,
                   BLOCK_D: tl.constexpr):
    # column range s: the first n_narrow ranges take width - 16 columns,
    # the others width (the last one cut at D)
    s = tl.program_id(0)
    D = DV * VEC
    c_lo = s * width - 16 * tl.minimum(s, n_narrow)
    c_hi = tl.minimum(c_lo + width - 16 * (s < n_narrow).to(tl.int32), D)
    rows = tl.program_id(1) * ROWS + tl.arange(0, ROWS)
    rmask = (rows < R)[:, None]
    base = g_ptr + rows.to(tl.int64)[:, None] * D
    cols = c_lo + tl.arange(0, BLOCK_D)
    x = tl.load(base + cols[None, :], mask=rmask & (cols < c_hi)[None, :],
                other=0.0)
    acc = tl.zeros([ROWS, BLOCK_D], dtype=tl.float32)
    for c0 in range(c_lo + BLOCK_D, c_hi + BLOCK_D, BLOCK_D):
        # the next tile's loads are issued before this one is summed
        cols = c0 + tl.arange(0, BLOCK_D)
        x_next = tl.load(base + cols[None, :],
                         mask=rmask & (cols < c_hi)[None, :], other=0.0)
        acc += x * x
        x = x_next
    tl.store(part_ptr + s * R + rows, tl.sum(acc, axis=1), mask=rows < R)


def _sqnorm_finish_kernel(part_ptr, out_ptr, R, SPLITS: tl.constexpr,
                          BLOCK_R: tl.constexpr):
    rows = tl.program_id(0) * BLOCK_R + tl.arange(0, BLOCK_R)
    m = rows < R
    acc = tl.load(part_ptr + rows, mask=m, other=0.0)
    for s in tl.static_range(1, SPLITS):          # in split order
        acc += tl.load(part_ptr + s * R + rows, mask=m, other=0.0)
    tl.store(out_ptr + rows, acc, mask=m)


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
    return (triton.jit(_sqnorm_kernel), triton.jit(_sqnorm_finish_kernel),
            triton.jit(_scale_mean_kernel))


def sqnorm_plan(r: int, d: int):
    """-> (ROWS, n_splits, width) of the norms pass over (r, d) rows:
    row tiles of ROWS rows (a power of two, about SQNORM_TILES tiles) and
    D cut into n_splits column ranges of width or width - 16 columns
    (width a multiple of 16), about SQNORM_PER_SM programs per SM on
    SQNORM_SMS SMs.  Plain ints in and out; no SM count is read, so each
    row's sum order depends on (r, d) only."""
    rows = 1
    while rows < 16 and cdiv(r, 2 * rows) >= SQNORM_TILES:
        rows *= 2
    chunks = cdiv(d, 16)
    n_splits = max(1, min(round(SQNORM_PER_SM * SQNORM_SMS / cdiv(r, rows)),
                          SQNORM_MAX_SPLITS, chunks))
    return rows, n_splits, 16 * cdiv(chunks, n_splits)


def sqnorm_block_d(rows: int, width: int) -> int:
    """BLOCK_D of the norms pass: SQNORM_TILE_ELEMS / ROWS columns, or the
    power of two just above a narrower range."""
    return min(SQNORM_TILE_ELEMS // rows, 1 << (width - 1).bit_length())


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
    """(R, D) f32 CUDA rows -> (R,) squared norms: one launch of the norms
    pass (the split kernel, then the finishing kernel)."""
    global sqnorm_launches
    if flat.dim() != 2:
        raise ValueError(f"flat must be 2-D: {tuple(flat.shape)}")
    r, d = flat.shape
    _check_cuda_f32("flat", flat, (r, d))
    check_no_grad("dp_clip sqnorms", flat)
    rows, n_splits, width = sqnorm_plan(r, d)
    part = torch.empty((n_splits, r), dtype=torch.float32, device=flat.device)
    out = torch.empty((r,), dtype=torch.float32, device=flat.device)
    sq_kernel, finish_kernel, _ = _kernels()
    vec = 4 if d % 4 == 0 else 1
    sq_kernel[(n_splits, cdiv(r, rows))](
        flat, part, r, d // vec, width, n_splits * width // 16 - cdiv(d, 16),
        VEC=vec, ROWS=rows, BLOCK_D=sqnorm_block_d(rows, width),
        num_warps=SQNORM_WARPS)
    finish_kernel[(cdiv(r, SQNORM_FINISH_ROWS),)](
        part, out, r, SPLITS=n_splits, BLOCK_R=SQNORM_FINISH_ROWS,
        num_warps=4)
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
    check_no_grad("dp_clip cohort_scale_mean", flat, scales, z, stddev)
    out = torch.empty((k, d), dtype=torch.float32, device=flat.device)
    *_, mean_kernel = _kernels()
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
