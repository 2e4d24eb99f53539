"""Chip smoke test of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Drives the port only (``src/repro_torch``; nothing of ``jax`` or the JAX
package ``repro``) and fails with a non-zero exit on the first problem:

1. device: requires CUDA, prints the card's name and power limit and the
   numerics flags;
2. kernels vs plain: the Triton ``dp_clip`` kernels (built at first
   launch into ``build/triton``) against their plain PyTorch version on
   the card, at the main path's shapes (K in {1, 2, 4}, B = 128,
   D = 317,124, with and without noise) and at awkward ones (B = 1, prime
   B and D, D below one block);
3. [times] times at the main path's shapes: kernel, plain version, one
   PyTorch library call and the bytes/operations bound; the norms pass
   and the clipped mean at K = 1, 2 and 4 with their grids and tiles, and
   the Triton kernels' registers and shared memory.  Every time is device time per call,
   from a CUDA graph of 30 calls replayed between CUDA events, best of
   two turns, the order reversed every other turn; a kernel and its
   library call go seven turns, and the turns the kernel was faster in
   are printed;
4. the main path at full width: FedAsync (staleness window with K > 1
   cohorts) and FedAvg through ``run_experiment`` with
   ``dp_path="pallas"`` on the paper's default CNN and corpus; kernel
   launches must equal S_max x cohorts per kernel;
5. a small-input check of the card's run against the CPU plain route
   (which the CPU tests hold to the JAX reference);
6. a bit-identical rerun;
7. [api] ``Session.sweep`` of the main path's configuration over sigma in
   {0.5, 1, 1.5, 2} x {FedAvg, FedAsync}, cold then warm: step builds
   within the sweep's budget cold and 0 warm, the Triton kernels recorded
   at every point, the wall per point and the time of one step build;
8. [legacy] the legacy per-client loop at full width: dp_clip launched
   once per client local step, at K = 1, and member local steps/s;
9. [robust] faults and screening: the tiny testbed on the card against
   the CPU plain route (equal fault events, counters and bookkeeping),
   then full width on the card (the screening ledger, every x50 upload
   delivered to the screen and rejected there, a bit-identical rerun);
10. the engine's run modes on [main]'s configuration, each with the
   ``dp_clip`` counters set to 0 before it and S_max x cohorts launches
   per kernel required after it: [resume] (checkpointed, crashed after
   the first snapshot, resumed: RunLog and params bit-identical to
   [main]; snapshot bytes, save and restore ms), [hostfed]
   (``device_arena=False``: bit-identical, H2D bytes and member steps/s
   against the arena path), [pipeline] (``pipeline_depth=2``:
   bit-identical, no host sync between evals by the counter and by
   PyTorch's sync debug mode, member steps/s against serial, the idle
   share of a profiled window between evals) and [tiered]
   (``StoreConfig(hot_slots=128, lookahead=16)`` over N = 1,000 and
   100,000 clients sharing one dataset: equal hot-arena bytes, the store
   ledger law, bit-identical to all-resident at N = 1,000, a churning
   24-client run that spills and reloads rows, and a tiered
   crash/resume);
   then where one full-width cohort's time goes (profiled cohort step,
   idle share, the fused step's stages);
11. [kernels-zoo] the CUDA C++ kernels ``ssd_intra_chunk`` and
   ``flash_decode`` against their plain versions, at zamba2-1.2b's shapes,
   the awkward ones of ``tests/test_kernels.py``, the split-S cases
   (pos = 0 at full width, a window across chunks, GQA 56/8 at Dh 128,
   GQA 2 at Dh 256 with softcap) and every zoo model's decode shape
   (gemma2-2b past its 4096 window, phi-3-vision at Dh 96, GQA 3,
   Whisper's cross-attention over 1500 frames), f32 and bf16; each
   instantiation's registers, shared memory and spills from nvcc's log;
12. [times-zoo] their times, plain and library times and bounds at
   zamba2-1.2b's shapes, ``flash_decode`` at pos = S - 1 and S / 2 with
   its split plan, and at gemma2-2b's local layer and phi-3-vision's
   Dh = 96;
13. [serve] zamba2-1.2b at full width (38 layers, d_model 2048, bf16,
    random weights from a seed): one prefill of 8 prompts of 2048 tokens,
    then 64 greedy decode steps; 38 ``ssd_intra_chunk`` and 6 x 64
    ``flash_decode`` launches;
14. [serve-small] the reduced config on the card against the CPU plain
    route, same weights;
15. [serve-rerun] the full-width serve again: bit-identical logits and
    tokens;
16. [serve-breakdown] one profiled prefill and decode step: top device
    kernels and the device idle share;
17. [serve-zoo] every other architecture of the zoo (gemma2-2b,
    llama3.2-3b, smollm-360m, olmoe-1b-7b, qwen2-moe-a2.7b, xlstm-350m,
    phi-3-vision-4.2b, whisper-large-v3, deepseek-coder-33b last) at
    full width and depth in bf16, random weights from a seed: one
    prefill and greedy decode steps, the card freed between models;
    prompt tokens/s, ms per step, peak memory, and ``flash_decode``
    launches = attention applications x steps (Whisper 2 per decoder
    layer, xLSTM 0);
18. [serve-zoo-small] each family's reduced config on the card against
    the CPU plain route, same weights;
19. [serve-zoo-rerun] gemma2-2b at full width again: bit-identical
    logits and tokens;
20. [train-zoo] ``launch/train.py spmd`` (the production round,
    ``core/fl_step.py``) at full width and depth, 2 rounds and a
    bit-identical rerun each: zamba2-1.2b (bf16 clients, f32 master,
    FedAdam; G = 2, n_micro = 2, per_micro = 2, seq 256) with
    ``ssd_intra_chunk`` launched twice per Mamba2 layer per microbatch
    (its forward and the backward's recompute), and smollm-360m at the launcher's defaults; per round the
    params move and stay finite and delta_norm > 0; the wall per round and
    peak memory, and the device idle share of one profiled rerun round;
    zamba2's one-microbatch gradient through the kernel's
    ``autograd.Function`` against the plain route (per-leaf relative L2
    within 1e-2 on the SSD block in bf16 and on the whole model in f32;
    in bf16 the kernel route's distance from the f32 gradient within 1.5x
    the plain route's), and the SSD block's plain backward timed against
    the kernel forward at the training shape;
21. [train-zoo-small] each reduced config (f32): one round on the card
    and on the CPU plain route with the same injected noise, params and
    delta_norm within 1e-4;
22. [axes] [main]'s FedAsync with ``dp_path="jnp"`` under each
    client-axis executor: "map" bit-identical to "unroll", "vmap" within
    1e-5, "fl_step" with a coherent ``fl_cfg``; bookkeeping equal; member
    local steps/s of each;
23. [mesh-main] (after the run modes' breakdown) [main]'s FedAsync on a
    ("data", "model") mesh over the ranks of a ``torch.distributed``
    group: W = 1 over NCCL in this process, bit-identical to [main]; W = 2
    as two spawned gloo ranks sharing cuda:0 (NCCL refuses two ranks on
    one card), each training its half of every cohort: bookkeeping equal
    to [main]'s, params within the run tolerance at sigma 1, within 1e-5
    of the one-process run at sigma 0 on the member-major executor
    (dp_path jnp) and within the run tolerance on the step-major one
    (its batched grads round differently at K / 2; Adam's first step
    turns that into +-lr at sigma 0), a bit-identical rerun,
    ``dp_clip`` launched S_max x cohorts times per rank, the partition
    proof; member steps/s at W = 1, W = 2 and in [main]; each rank's
    backend and collectives; W = 2 and 4 over NCCL, a card per rank,
    where the machine has the cards;
24. [mesh-train] (after [axes]) ``launch/train.py spmd --devices 2
    --data-axis 2`` as two gloo ranks on cuda:0, the f32 master and
    FedAdam's state sharded over them: zamba2-1.2b at [train-zoo]'s
    flags (``ssd_intra_chunk`` 2 x 38 x n_micro per round on each rank,
    +38 per loss eval on rank 0; master and delta norms within 1e-5 relative
    of [train-zoo]'s W = 1 run; round 0 rerun bit-identical in the same
    ranks' processes, by fingerprints of every shard) and smollm-360m at
    G = 2 against its W = 1 run; each rank's peak memory, walls and
    collectives; on a machine with the cards, zamba2-1.2b at W = 2 and
    smollm-360m at W = 4 over NCCL, a card per rank;
25. [mesh-model] the model axis: ``spmd --devices 2 --data-axis 1``
    for zamba2-1.2b at [train-zoo]'s flags (one client, its model
    tensor-parallel over two gloo ranks on cuda:0) with round 0 rerun, and
    ``--devices 4 --data-axis 2`` for smollm-360m, 2 rounds each, then
    one round each of xlstm-350m and olmoe-1b-7b (2 of its 16 layers) at
    ``--devices 2 --data-axis 1`` (``MESH_MODEL``; whisper-large-v3 and
    phi-3-vision-4.2b run in ``scripts/torch_model_axis_control.py``),
    against the W = 1 run in this
    process: each leaf's f32 gradient and bf16 update bounded; per rank
    ``ssd_intra_chunk`` launched
    as often as W = 1 per client, at 32 of zamba2's 64 SSM heads, its
    first launch held against the plain version; equal delta norms, the
    leaves whole on the model axis bit-identical in each model group, the
    rerun bit-identical, the master's per-leaf deviation from W = 1; the
    f32 round of each reduced config on the same mesh shape within 1e-5
    of W = 1; walls, peak memory and collectives per rank; in zamba2's
    ranks, [serve-mesh] (serving on the model axis) and one round of
    smollm-360m with one client per rank (``client_placement="dp"``, G
    = 2, each client's model whole on its rank), the master bit-identical
    to (or within 1e-5 of) the one-process round of G = 2;
26. [remat] smollm-360m at full width and depth, bf16 client, f32
    master, one client's microbatch of ``train_4k`` on the 16 x 16 mesh
    (4 x 4096 tokens, n_micro 1): one round under full rematerialization
    and one under ``set_remat_policy("dots")``, the masters bit-identical,
    the dots peak memory at least the full one; both peaks and walls;
27. [dryrun] ``launch/dryrun.py``'s combinations on the host, in a child
    process started at the beginning and read at the end: zamba2-1.2b x
    decode_32k and smollm-360m x train_4k with ``--remat-policy dots
    --client-placement dp``, on the single pod;
28. [analysis] (right after [mesh-main]; no new run) the port's program
    audits (``repro_torch.analysis``) over what the phases above left:
    ``audit_engine_stats`` on every engine RunLog of [main], [rerun],
    [api], [legacy], [robust], the run modes and [mesh-main] (this
    process's and each spawned rank's), ``audit_donation(expect=True)``
    on each [main] cohort's arenas (written in place),
    ``audit_sharding`` on the W = 2 ranks' cohort rows,
    ``audit_collectives`` on every spawned rank's runs (at most 3
    all-gathers per cohort, no other kind), and the port's lint over
    ``src/repro_torch``.

The CUDA C++ kernels' ``nvcc`` build starts in the background when the
script starts and is waited for before the first CUDA kernel runs.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import json
import os
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet, 700 W
F32_FLOPS = 67e12              # H100 SXM data sheet, f32 outside tensor cores
BF16_FLOPS = 989e12            # H100 SXM data sheet, dense bf16 tensor cores

MEAN_RTOL, MEAN_ATOL = 1e-5, 1e-6   # 317k-term f32 sums in another order
NORM_RTOL = 1e-5


def log(*a):
    print(*a, flush=True)


def require(cond, msg):
    if not cond:
        raise SystemExit(f"chip_smoke FAILED: {msg}")


def phase_device():
    import torch
    from repro_torch.device import numerics_flags, resolve_device
    require(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    dev = resolve_device(None)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"on {torch.cuda.get_device_name(0)}; count "
        f"{torch.cuda.device_count()}")
    log(f"[device] flags {numerics_flags()}")
    return dev, smi


def _inputs(k, b, d, seed, dev):
    import torch
    gen = torch.Generator(dev).manual_seed(seed)
    g = torch.randn((k, b, d), generator=gen, device=dev) * (2.0 / d ** 0.5)
    g[:, : (b + 1) // 2] *= 3.0        # about half the rows clip at C = 1
    z = torch.randn((k, d), generator=gen, device=dev)
    return g, z


def phase_kernels(dev):
    """Kernel vs plain version on the card; returns per-kernel max errors."""
    import torch
    from repro_torch.kernels.dp_clip import dp_clip, ops, ref
    shapes = [(1, 128, 317124), (2, 128, 317124),       # main path
              (4, 128, 317124),
              (1, 1, 317124), (3, 13, 1031), (2, 7, 37),  # awkward
              (4, 128, 4093)]
    errs = {"dp_clip_sqnorm": 0.0, "dp_clip_scale_mean": 0.0}
    for i, (k, b, d) in enumerate(shapes):
        g, z = _inputs(k, b, d, 100 + i, dev)
        flat = g.view(k * b, d)
        sq_k, sq_p = dp_clip.sqnorms(flat), ref.sqnorms_ref(flat)
        torch.cuda.synchronize()
        require(torch.allclose(sq_k, sq_p, rtol=NORM_RTOL, atol=0),
                f"sqnorm kernel disagrees at {(k, b, d)}")
        errs["dp_clip_sqnorm"] = max(errs["dp_clip_sqnorm"],
                                     float((sq_k - sq_p).abs().max()))
        scales = ref.clip_scales(torch.sqrt(sq_p), 1.0)
        std = torch.tensor([1.0 / b], device=dev)
        for noise in (False, True):
            kw = dict(z=z, stddev=std) if noise else {}
            m_k = dp_clip.cohort_scale_mean(flat, scales, k=k, inv_b=1.0 / b,
                                            **kw)
            m_p = ref.cohort_scale_mean_ref(flat, scales, k=k,
                                            inv_b=1.0 / b, **kw)
            torch.cuda.synchronize()
            require(torch.allclose(m_k, m_p, rtol=MEAN_RTOL, atol=MEAN_ATOL),
                    f"scale_mean kernel disagrees at {(k, b, d)} "
                    f"noise={noise}")
            errs["dp_clip_scale_mean"] = max(
                errs["dp_clip_scale_mean"], float((m_k - m_p).abs().max()))
            # the whole op through the wrapper vs the plain op
            okw = dict(noise_stddev=std, z=z) if noise else {}
            a = ops.dp_clip_mean_noise_cohort(g, 1.0, **okw)
            p = ref.dp_clip_mean_noise_cohort_ref(g, 1.0, **okw)
            require(torch.allclose(a[0], p[0], rtol=MEAN_RTOL,
                                   atol=MEAN_ATOL)
                    and torch.allclose(a[1], p[1], rtol=NORM_RTOL, atol=0)
                    and torch.equal(a[2], p[2]),
                    f"dp_clip_mean_noise_cohort disagrees at {(k, b, d)}")
        log(f"[kernels] {(k, b, d)} ok; max |err| so far {errs}")
    return errs


def _bound(nbytes, flops, peak=F32_FLOPS):
    """The least time the card could take: the larger of bytes over the
    memory rate and operations over the peak rate of their type."""
    tb, tf = nbytes / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def _in_turns(fns, rounds=2, iters=30, pair=None):
    """Time each callable in turns, the order reversed every other turn
    (a, b, ..., b, a, ...: the place in a turn moves a time by up to
    1%); keep the best.  With ``pair = (x, y)``, also ``"x wins"``: the
    turns in which ``x`` was faster than ``y``, as ``"w/rounds"``."""
    t = {}
    for i in range(rounds):
        for name in (list(fns) if i % 2 == 0 else list(fns)[::-1]):
            t.setdefault(name, []).append(_time_ms(fns[name], iters))
    best = {name: min(v) for name, v in t.items()}
    if pair:
        x, y = pair
        wins = sum(a < b for a, b in zip(t[x], t[y]))
        best[f"{x} wins"] = f"{wins}/{rounds}"
    return best


def _time_ms(fn, iters=30):
    """Device ms per call: ``iters`` calls captured in one CUDA graph,
    replayed between CUDA events, so the host's dispatch of each call is
    not counted (the wrappers' Python costs tens of microseconds, as much
    as the kernels at these shapes)."""
    import torch
    fn()                                       # build, compile, warm up
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    graph.replay()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters


def _eager_ms(fn, iters=30):
    """Wall ms per call of ``iters`` calls launched one by one from Python
    (the host's dispatch included where it exceeds the device time): the
    fused step's stages, whose host time is part of the step's."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters


def phase_times(dev, smi):
    """Kernel / plain / library times at the main path's shapes: the norms
    and the clipped mean at K = 1, 2 and 4 (the clipped mean at K = 1 is
    ``ops.scale_mean``; K = 2 and 4 are the cohorts of the FedAsync run),
    with noise where the path adds it."""
    import torch
    from repro_torch.kernels.common import cdiv, sm_count
    from repro_torch.kernels.dp_clip import dp_clip, ref
    k, b, d = 4, 128, 317124
    g, z = _inputs(k, b, d, 7, dev)
    flat = g.view(k * b, d)
    scales = ref.clip_scales(torch.sqrt(ref.sqnorms_ref(flat)), 1.0)
    std = torch.tensor([1.0 / b], device=dev)
    out = {}
    for km in (1, 2, 4):
        fl, r = flat[:km * b], km * b
        t = _in_turns({
            "sq": lambda: dp_clip.sqnorms(fl),
            "sq_plain": lambda: ref.sqnorms_ref(fl),
            "sq_lib": lambda: torch.linalg.vector_norm(fl, dim=1)},
            rounds=7, pair=("sq", "sq_lib"))
        bd = _bound(r * d * 4 + r * 4, 2 * r * d)
        rows, n_splits, width = dp_clip.sqnorm_plan(r, d)
        n_prog = n_splits * cdiv(r, rows)
        log(f"[times] {smi}; sqnorm K={km} B={b} D={d}: kernel "
            f"{t['sq']:.4f} ms plain {t['sq_plain']:.4f} ms library "
            f"(linalg.vector_norm) {t['sq_lib']:.4f} ms bound {bd[0]:.4f} "
            f"ms ({bd[1]}) = {bd[0] / t['sq']:.3f} of it; kernel faster "
            f"than the library in {t['sq wins']} turns; grid {n_splits} "
            f"splits x {cdiv(r, rows)} row tiles = {n_prog} programs "
            f"({n_prog / sm_count(dev):.1f} per SM), tile {rows} x "
            f"{dp_clip.sqnorm_block_d(rows, width)}, "
            f"{dp_clip.SQNORM_WARPS} warps, ranges of {width - 16} and "
            f"{width} columns")
        if km == k:
            out["dp_clip_sqnorm"] = dict(
                ms=t["sq"], plain_ms=t["sq_plain"], library_ms=t["sq_lib"],
                bound_ms=bd[0], bound_by=bd[1])
    for km in (1, 2, 4):
        fl, sc, gk, zk = flat[:km * b], scales[:km * b], g[:km], z[:km]
        noise = dict(z=zk, stddev=std) if km > 1 else {}
        fns = {
            "kernel": lambda: dp_clip.cohort_scale_mean(
                fl, sc, k=km, inv_b=1.0 / b, **noise),
            "plain": lambda: ref.cohort_scale_mean_ref(
                fl, sc, k=km, inv_b=1.0 / b, **noise)}
        if km == 1:
            fns["library"] = lambda: torch.mv(fl.t(), sc)
        else:
            fns["kernel no noise"] = lambda: dp_clip.cohort_scale_mean(
                fl, sc, k=km, inv_b=1.0 / b)
            fns["library"] = lambda: torch.bmm(sc.view(km, 1, b), gk)
        tm = _in_turns(fns, rounds=7, pair=(
            "kernel no noise" if noise else "kernel", "library"))
        rows, block_d, warps, pps = dp_clip.mean_tile(km)
        per, span = dp_clip.mean_plan(km, d, sm_count(dev))
        nz = km * d * 4 + 4 if noise else 0
        bd = _bound(km * b * d * 4 + km * b * 4 + nz + km * d * 4,
                    2 * km * b * d + (2 * km * d if noise else 0))
        bd_lib = _bound(km * b * d * 4 + km * b * 4 + km * d * 4,
                        2 * km * b * d)
        lib = "torch.mv" if km == 1 else "torch.bmm, no noise"
        extra = (f" (no noise {tm['kernel no noise']:.4f} ms, its bound "
                 f"{bd_lib[0]:.4f} ms)" if km > 1 else "")
        wins = tm["kernel no noise wins" if noise else "kernel wins"]
        log(f"[times] {smi}; scale_mean K={km} B={b} D={d}"
            f"{' + noise' if noise else ''}: kernel {tm['kernel']:.4f} ms"
            f"{extra} plain {tm['plain']:.4f} ms library ({lib}) "
            f"{tm['library']:.4f} ms bound {bd[0]:.4f} ms ({bd[1]}) = "
            f"{bd[0] / tm['kernel']:.3f} of it; kernel faster than the "
            f"library in {wins} turns; grid {per} x {km} programs of "
            f"{span} columns, tile {rows} x {block_d}, {warps} warps, "
            f"{pps} programs/SM planned")
        if km == 4:
            out["dp_clip_scale_mean"] = dict(
                ms=tm["kernel"], plain_ms=tm["plain"],
                library_ms=tm["library"], bound_ms=bd[0], bound_by=bd[1])
    for km in (1, 2, 4):
        log(f"[times] Triton kernels at K={km}: "
            f"{_triton_resources(flat[:km * b], scales[:km * b], km)}")
    return out


def _triton_resources(flat, scales, k):
    """Registers, spills and shared memory of the Triton kernels as
    compiled for (K*B, D) f32 rows: one launch of each, straight from its
    Triton function with the plan's arguments, so no wrapper counts it."""
    import torch
    from repro_torch.kernels.common import cdiv, sm_count
    from repro_torch.kernels.dp_clip import dp_clip
    sq_kernel, finish_kernel, mean_kernel = dp_clip._kernels()
    r, d = flat.shape
    vec = 4 if d % 4 == 0 else 1
    s_rows, n_splits, width = dp_clip.sqnorm_plan(r, d)
    part = torch.empty((n_splits, r), dtype=torch.float32, device=flat.device)
    norms = torch.empty((r,), dtype=torch.float32, device=flat.device)
    means = torch.empty((k, d), dtype=torch.float32, device=flat.device)
    rows, block_d, warps, _ = dp_clip.mean_tile(k)
    per, span = dp_clip.mean_plan(k, d, sm_count(flat.device))
    compiled = {
        "sqnorm": sq_kernel[(n_splits, cdiv(r, s_rows))](
            flat, part, r, d // vec, width,
            n_splits * width // 16 - cdiv(d, 16), VEC=vec, ROWS=s_rows,
            BLOCK_D=dp_clip.sqnorm_block_d(s_rows, width),
            num_warps=dp_clip.SQNORM_WARPS),
        "sqnorm_finish": finish_kernel[(cdiv(r, dp_clip.SQNORM_FINISH_ROWS),)](
            part, norms, r, SPLITS=n_splits,
            BLOCK_R=dp_clip.SQNORM_FINISH_ROWS, num_warps=4),
        "scale_mean": mean_kernel[(per, k)](
            flat, scales, scales, scales, means, r // k, d // vec, span, 1.0,
            HAS_NOISE=False, VEC=vec, ROWS=rows, BLOCK_D=block_d,
            num_warps=warps)}
    return {name: dict(registers=getattr(c, "n_regs", None),
                       spills=getattr(c, "n_spills", None),
                       shared_bytes=getattr(getattr(c, "metadata", None),
                                            "shared", None))
            for name, c in compiled.items()}


def _check_run(params, log_, name):
    import torch
    from repro_torch.pytree import tree_leaves
    for leaf in tree_leaves(params):
        require(bool(torch.isfinite(leaf).all()), f"{name}: nonfinite params")
    info = log_.engine_stats["pallas_interpret"]
    require(info is not None and info["backend"] == "cuda"
            and info["kernel"] == "triton",
            f"{name}: engine_stats does not record the kernels: {info}")
    eps = {t: (v[-1] if v else 0.0) for t, v in log_.eps_trajectory.items()}
    log(f"[main] {name}: updates {log_.update_counts} eps "
        f"{ {t: round(e, 4) for t, e in eps.items()} } acc "
        f"{[round(a, 4) for a in log_.global_acc]} cohorts "
        f"{log_.engine_stats['cohorts']} sizes {log_.cohort_sizes}")


def phase_main_path():
    """The full-width main path: FedAsync with K > 1 cohorts, then FedAvg."""
    from repro_torch.core.testbed import TestbedConfig, run_experiment
    from repro_torch.engine.cohort import steps_per_round
    from repro_torch.engine.engine import EngineConfig
    from repro_torch.kernels.dp_clip import dp_clip
    cfg = TestbedConfig(batch_size=128, sigma=1.0, dp_path="pallas")
    ecfg = EngineConfig(staleness_window=120.0, max_cohort=4)
    dp_clip.reset_launches()
    t0 = time.perf_counter()
    p_a, log_a = run_experiment("fedasync", cfg, max_updates=40,
                                eval_every=10, engine_cfg=ecfg)
    t_async = time.perf_counter() - t0
    t0 = time.perf_counter()
    p_f, log_f = run_experiment("fedavg", cfg, rounds=2, eval_every=1,
                                engine_cfg=ecfg)
    t_fedavg = time.perf_counter() - t0
    launches = {"dp_clip_sqnorm": dp_clip.sqnorm_launches,
                "dp_clip_scale_mean": dp_clip.scale_mean_launches}
    _check_run(p_a, log_a, "fedasync")
    _check_run(p_f, log_f, "fedavg")
    require(max(log_a.cohort_sizes) > 1, "no cohort with K > 1")
    # S_max: every client of the default corpus has the same step count
    from repro_torch.core.testbed import build_partitions
    splits, _ = build_partitions(cfg)
    s_max = max(steps_per_round(tr["y"].shape[0], cfg.batch_size,
                                cfg.local_epochs) for tr, _ in splits)
    cohorts = log_a.engine_stats["cohorts"] + log_f.engine_stats["cohorts"]
    for name, n in launches.items():
        require(n == s_max * cohorts, f"{name} launched {n} times, expected "
                f"S_max x cohorts = {s_max} x {cohorts}")
    require(log_a.engine_stats["pallas_interpret"]["launches"]
            + log_f.engine_stats["pallas_interpret"]["launches"]
            == 2 * s_max * cohorts, "engine_stats launch record")
    member_steps = s_max * sum(log_a.cohort_sizes)
    updates = sum(log_a.update_counts.values())
    log(f"[main] S_max {s_max}, cohorts {cohorts}: launches {launches} "
        f"(= 2 x S_max x cohorts in all)")
    log(f"[main] fedasync {t_async:.3f} s wall for {updates} updates = "
        f"{updates / t_async:.3f} updates/s, {member_steps} member local "
        f"DP-SGD steps = {member_steps / t_async:.2f} steps/s (wall of "
        f"run_experiment: corpus, arenas, evals included); fedavg "
        f"{t_fedavg:.3f} s wall for 2 rounds")
    runs = {"fedasync": (p_a, log_a, t_async), "fedavg": (p_f, log_f,
                                                          t_fedavg)}
    return launches, runs


def phase_small_vs_cpu():
    """The same tiny run on the card and on the CPU plain route: identical
    bookkeeping, params within the run-level tolerance of the CPU tests."""
    import torch
    from repro_torch.core.testbed import TestbedConfig, run_experiment
    from repro_torch.data.synthetic_ser import SERDataConfig
    from repro_torch.engine.engine import EngineConfig
    from repro_torch.models.ser_cnn import SERConfig
    from repro_torch.pytree import tree_leaves
    dims = dict(time_frames=12, n_mels=12)
    cfg = TestbedConfig(
        batch_size=16, sigma=0.0, dp_path="pallas", seed=3,
        data=SERDataConfig(n_total=360, **dims),
        model=SERConfig(channels1=8, channels2=16, fc_dim=32, **dims))
    kw = dict(max_updates=10, eval_every=5,
              engine_cfg=EngineConfig(staleness_window=1e9, max_cohort=2))
    p_g, l_g = run_experiment("fedasync", cfg, **kw)
    p_c, l_c = run_experiment("fedasync", cfg, device="cpu", **kw)
    for f in ("times", "update_counts", "staleness", "eps_trajectory",
              "cohort_sizes", "server_version"):
        require(getattr(l_g, f) == getattr(l_c, f), f"small run: {f} differs")
    d = max(float((a.cpu() - b).abs().max())
            for a, b in zip(tree_leaves(p_g), tree_leaves(p_c)))
    require(d < 1e-2, f"small run: params differ by {d}")
    log(f"[small] card vs CPU plain route: bookkeeping equal, "
        f"max |dparam| {d:.3e}, acc {l_g.global_acc} vs {l_c.global_acc}")
    torch.cuda.synchronize()


def phase_rerun():
    import torch
    from repro_torch.core.testbed import TestbedConfig, run_experiment
    from repro_torch.engine.engine import EngineConfig
    from repro_torch.pytree import tree_leaves
    cfg = TestbedConfig(batch_size=128, sigma=1.0, dp_path="pallas", seed=1)
    kw = dict(max_updates=6, eval_every=3,
              engine_cfg=EngineConfig(staleness_window=120.0, max_cohort=4))
    p1, l1 = run_experiment("fedasync", cfg, **kw)
    p2, l2 = run_experiment("fedasync", cfg, **kw)
    for a, b in zip(tree_leaves(p1), tree_leaves(p2)):
        require(torch.equal(a, b), "rerun params are not bit-identical")
    for f in ("times", "global_acc", "update_counts", "staleness",
              "eps_trajectory", "local_acc", "cohort_sizes", "influence"):
        require(getattr(l1, f) == getattr(l2, f), f"rerun RunLog.{f} differs")
    log("[rerun] full-width fedasync rerun: params and RunLog bit-identical")


# ---------------------------------------------------------------------------
# the declarative API, the legacy loop, faults and screening
# ---------------------------------------------------------------------------

# faults of every kind (corrupted uploads all-NaN or their delta x 50) and
# a screen that rejects update norms above the threshold; the tiny
# testbed's clean norms are ~0.1 and its x50 ones 4-6 (threshold 1), the
# full width's 0.8-1.8 and 41-56 on an H100 (threshold 8); _ledger
# checks every run's norms lie a factor 2 or more from the threshold
ROBUST_FAULTS = dict(seed=1, failure_prob=0.1, upload_loss_prob=0.2,
                     late_prob=0.1, duplicate_prob=0.1, leave_prob=0.1,
                     corrupt_prob=0.3, corrupt_scale=50.0)
FEDAVG_FAULTS = dict(ROBUST_FAULTS, seed=2, leave_prob=0.2,
                     round_deadline_s=300.0, min_quorum=2)
# at full width (testbed seed 0) fault seed 2 drops 2 of its 4 x50 uploads
# at the deadline, before the screen; seed 11 delivers all 3 of its x50
# uploads in time and still drops 6 others at the deadline (the timeline
# depends only on the tier clocks and the fault seed)
FULL_FEDAVG_FAULTS = dict(FEDAVG_FAULTS, seed=11)
SMALL_THRESHOLD, FULL_THRESHOLD = 1.0, 8.0


def _main_cfg(**kw):
    from repro_torch.core.testbed import TestbedConfig
    return TestbedConfig(batch_size=128, sigma=1.0, dp_path="pallas", **kw)


def _steps(cfg):
    """Every client's local steps per round; the default corpus gives all
    five clients the same count."""
    from repro_torch.core.testbed import build_partitions
    from repro_torch.engine.cohort import steps_per_round
    counts = {steps_per_round(tr["y"].shape[0], cfg.batch_size,
                              cfg.local_epochs)
              for tr, _ in build_partitions(cfg)[0]}
    require(len(counts) == 1, f"clients differ in local steps: {counts}")
    return counts.pop()



# ---------------------------------------------------------------------------
# the engine's run modes: checkpoint/resume, the host-fed data path, the
# pipelined scheduler and the tiered client-state store, each at [main]'s
# full width (SERConfig, B = 128, sigma = 1, dp_path="pallas")
# ---------------------------------------------------------------------------

MAIN_ASYNC = dict(max_updates=40, eval_every=10)
MAIN_FEDAVG = dict(rounds=2, eval_every=1)
RUNLOG_FIELDS = ("times", "global_acc", "server_version", "update_counts",
                 "influence", "staleness", "eps_trajectory", "local_acc",
                 "cohort_sizes", "fault_events", "dropouts")


def _main_spec(kind, **engine):
    from repro_torch.api import ExperimentSpec
    from repro_torch.engine.engine import EngineConfig
    ecfg = EngineConfig(staleness_window=120.0, max_cohort=4, **engine)
    kw = MAIN_ASYNC if kind == "fedasync" else MAIN_FEDAVG
    return ExperimentSpec.from_legacy(kind, _main_cfg(), engine_cfg=ecfg,
                                      **kw)


def _max_diff(pa, pb):
    from repro_torch.pytree import tree_leaves
    return max(float((a.float() - b.float()).abs().max())
               for a, b in zip(tree_leaves(pa), tree_leaves(pb)))


def _same_run(a, b, what, stats_drop=None, params="bitwise"):
    """``b`` equals the reference run ``a``: every RunLog field down to the
    float, the engine stats except ``stats_drop`` (None: skip them), and
    the params bit for bit (``params`` a float: within that bound)."""
    (pa, la), (pb, lb) = a, b
    for f in RUNLOG_FIELDS:
        require(getattr(la, f) == getattr(lb, f), f"{what}: RunLog.{f} "
                f"differs: {getattr(la, f)} vs {getattr(lb, f)}")
    if stats_drop is not None:
        sa = {k: v for k, v in la.engine_stats.items() if k not in stats_drop}
        sb = {k: v for k, v in lb.engine_stats.items() if k not in stats_drop}
        diff = {k: (sa[k], sb.get(k)) for k in sa if sa[k] != sb.get(k)}
        require(sa == sb, f"{what}: engine_stats differ: {diff}")
    d = _max_diff(pa, pb)
    if params == "bitwise":
        require(d == 0.0, f"{what}: params differ by up to {d}")
    else:
        require(d <= params, f"{what}: params differ by {d} > {params}")
    return d


def _modes_session():
    """One Session for [resume], [hostfed] and [pipeline], warmed by a
    short run of [main]'s testbed: the corpus, its device arena and the
    cohort step are built once; every run still starts from fresh client
    and runner state (``Session`` resets them between runs)."""
    from repro_torch.api import ExperimentSpec, Session
    sess = Session()
    spec = _main_spec("fedasync")
    sess.run(ExperimentSpec.from_legacy(
        "fedasync", spec.testbed, max_updates=4, eval_every=4,
        engine_cfg=spec.engine))
    return sess


def _require_launches(name, cohorts, s_max):
    """Each ``dp_clip`` counter, set to 0 before the phase's run, equals
    S_max x cohorts after it."""
    from repro_torch.kernels.dp_clip import dp_clip
    got = {"dp_clip_sqnorm": dp_clip.sqnorm_launches,
           "dp_clip_scale_mean": dp_clip.scale_mean_launches}
    for k, n in got.items():
        require(n == s_max * cohorts, f"[{name}] {k} launched {n} times, "
                f"expected S_max x cohorts = {s_max} x {cohorts}")
    log(f"[{name}] dp_clip launches {got} (= S_max {s_max} x "
        f"{cohorts} cohorts each)")


def phase_resume(smi, main_runs, sess):
    """[main]'s two runs checkpointed, crashed after their first snapshot
    and resumed: RunLog and params equal the uninterrupted runs."""
    import shutil
    import tempfile
    from repro_torch.checkpoint import latest_step
    from repro_torch.engine import resilience
    from repro_torch.kernels.dp_clip import dp_clip
    s_max = _steps(_main_cfg())
    timed = {"save": [], "restore": []}
    originals = {}
    for name, key in (("save_async", "save"), ("save_fedavg", "save"),
                      ("restore_async", "restore"),
                      ("restore_fedavg", "restore")):
        fn = getattr(resilience, name)
        originals[name] = fn

        def wrapped(*a, _fn=fn, _key=key, **kw):
            import torch
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return _fn(*a, **kw)
            finally:
                torch.cuda.synchronize()
                timed[_key].append(time.perf_counter() - t0)

        setattr(resilience, name, wrapped)
    root = ROOT / "build"
    root.mkdir(exist_ok=True)
    try:
        for kind, every in (("fedasync", 20), ("fedavg", 1)):
            spec = _main_spec(kind)
            ckdir = tempfile.mkdtemp(prefix="resume_", dir=root)
            dp_clip.reset_launches()
            try:
                sess.run(spec, checkpoint_every=every,
                              checkpoint_dir=ckdir, crash_after_saves=1)
                require(False, f"[resume] {kind}: no simulated crash")
            except resilience.SimulatedCrash:
                pass
            step = latest_step(ckdir)
            nbytes = os.path.getsize(
                os.path.join(ckdir, f"step_{step:08d}.npz"))
            p, lg = sess.run(spec, checkpoint_every=every,
                             checkpoint_dir=ckdir, resume_from=ckdir)
            p0, l0, _ = main_runs[kind]
            _same_run((p0, l0), (p, lg), f"[resume] {kind}", stats_drop=())
            # the snapshot closes an iteration: crash + resume run exactly
            # the uninterrupted run's cohorts
            _require_launches("resume", l0.engine_stats["cohorts"], s_max)
            log(f"[resume] {smi}; {kind}: crashed after the snapshot at "
                f"step {step} ({nbytes} bytes), resumed: RunLog (engine "
                f"stats included) and params bit-identical to [main]")
            shutil.rmtree(ckdir)
    finally:
        for name, fn in originals.items():
            setattr(resilience, name, fn)
    log(f"[resume] save ms {[round(t * 1e3, 1) for t in timed['save']]}, "
        f"restore ms {[round(t * 1e3, 1) for t in timed['restore']]} "
        f"(synchronized before and after)")


def _staging_costs(run):
    """Run ``run()`` with the runner's cohort halves timed on the host:
    per cohort, the serial driver's wait for the previous cohort, staging
    without that wait, and submission; for host-fed staging also its
    numpy gather/stack and its pinned pack-and-copy apart, the pinned
    buffers it newly allocated, and the device time of one pinned copy of
    its mean upload size (CUDA events, best of 5, timed after the run).
    Returns (run's result, per-cohort ms dict)."""
    import torch
    from repro_torch.engine import engine as eng
    R, P = eng.CohortRunner, eng._PinnedStaging
    names = ("stage_cohort", "_await_serial", "submit_cohort",
             "_gather_batches", "_h2d")
    real = {n: getattr(R, n) for n in names}
    real_buffer = P._buffer
    acc = {n: 0.0 for n in names}
    acc.update(cohorts=0, allocs=0, alloc=0.0, host_stage=False)
    upload_bytes = []

    def wrap(name):
        def f(self, *a, **kw):
            host_copy = name == "_h2d" and acc["host_stage"]
            if host_copy:
                upload_bytes.append(sum(x.nbytes for x in a))
            if name == "stage_cohort":
                acc["cohorts"] += 1
                acc["host_stage"] = not self.use_arena
            t0 = time.perf_counter()
            try:
                out = real[name](self, *a, **kw)
            finally:
                if name == "stage_cohort":
                    acc["host_stage"] = False
            if name != "_h2d" or host_copy:
                acc[name] += time.perf_counter() - t0
            return out
        return f

    def buffer(self, nbytes):
        n0, t0 = len(self.bufs), time.perf_counter()
        out = real_buffer(self, nbytes)
        if len(self.bufs) > n0:
            acc["allocs"] += 1
            acc["alloc"] += time.perf_counter() - t0
        return out

    for n in names:
        setattr(R, n, wrap(n))
    P._buffer = buffer
    try:
        result = run()
    finally:
        for n in names:
            setattr(R, n, real[n])
        P._buffer = real_buffer
    torch.cuda.synchronize()
    k = max(acc["cohorts"], 1)
    ms = {"wait": acc["_await_serial"], "submit": acc["submit_cohort"],
          "stage": acc["stage_cohort"] - acc["_await_serial"],
          "gather": acc["_gather_batches"], "pack_copy": acc["_h2d"],
          "alloc": acc["alloc"]}
    ms = {n: round(v * 1e3 / k, 3) for n, v in ms.items()}
    ms["copy_device"] = 0.0
    if upload_bytes:
        src = torch.empty(sum(upload_bytes) // len(upload_bytes),
                          dtype=torch.uint8, pin_memory=True)
        best = []
        for _ in range(5):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            src.to("cuda", non_blocking=True)
            e1.record()
            e1.synchronize()
            best.append(e0.elapsed_time(e1))
        ms["copy_device"] = round(min(best), 3)
    ms["allocs"] = acc["allocs"]
    ms["cohorts"] = acc["cohorts"]
    return result, ms


def phase_hostfed(smi, main_runs, sess):
    """``device_arena=False`` on [main]'s configuration: bookkeeping equal
    to the arena runs, params bit-identical or within 1e-5; member
    steps/s of both paths in one warm session, and where each path's
    host time per cohort goes."""
    import torch
    from repro_torch.kernels.dp_clip import dp_clip
    s_max = _steps(_main_cfg())
    for kind in ("fedasync", "fedavg"):
        walls, runs, costs = {}, {}, {}
        for arena in (True, False):
            dp_clip.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            runs[arena], costs[arena] = _staging_costs(
                lambda: sess.run(_main_spec(kind, device_arena=arena)))
            torch.cuda.synchronize()
            walls[arena] = time.perf_counter() - t0
            _require_launches("hostfed",
                              runs[arena][1].engine_stats["cohorts"], s_max)
        p, lg = runs[False]
        p0, l0, _ = main_runs[kind]
        d = _same_run((p0, l0), (p, lg), f"[hostfed] {kind}", params=1e-5)
        st, st0 = lg.engine_stats, runs[True][1].engine_stats
        require(st["data_path"] == "host" and st0["data_path"] == "arena",
                "[hostfed] data paths")
        steps = s_max * sum(lg.cohort_sizes)
        log(f"[hostfed] {smi}; {kind}: bookkeeping equal to [main], max "
            f"|dparam| {d:.3e} ({'bit-identical' if d == 0 else 'differs'})"
            f"; H2D bytes per cohort host {st['h2d_bytes_per_cohort']:.0f} "
            f"vs arena {st0['h2d_bytes_per_cohort']:.0f}; member steps/s "
            f"host {steps / walls[False]:.2f} vs arena "
            f"{steps / walls[True]:.2f} (warm session, walls "
            f"{walls[False]:.3f} / {walls[True]:.3f} s, evals included)")
        log(f"[hostfed] {smi}; {kind}: host ms per cohort (serial wait "
            f"for the previous cohort / staging without it / submission; "
            f"host-fed staging = numpy gather+stack, pinned pack + copy "
            f"enqueue, of which new pinned buffers; device ms of one "
            f"pinned copy of the mean upload): host {costs[False]} vs "
            f"arena {costs[True]}")


def _window_idle_share(run):
    """Run ``run()`` with the profiler on over its first window between
    evals only: started at the end of the first eval, stopped at the start
    of the second after a synchronise (the wait the eval's fetch makes
    anyway).  Returns (window ms, device busy ms, idle share), the busy
    time being the union of the device activities' intervals.  Only the
    device's activity is recorded: the busy time reads nothing else, and
    the host ops' events took the profiler ~35 s to gather per window."""
    import torch
    from repro_torch.engine.engine import CohortRunner
    real = CohortRunner.eval_boundary
    acts = [torch.profiler.ProfilerActivity.CUDA]
    state = {"evals": 0}

    def boundary(self, inside):
        if inside:
            state["evals"] += 1
            if state["evals"] == 2:
                torch.cuda.synchronize()
                state["t1"] = time.perf_counter()
                state["prof"].stop()
        out = real(self, inside)
        if not inside and state["evals"] == 1:
            state["prof"] = torch.profiler.profile(activities=acts)
            state["prof"].start()
            state["t0"] = time.perf_counter()
        return out

    CohortRunner.eval_boundary = boundary
    try:
        run()
    finally:
        CohortRunner.eval_boundary = real
    require("t1" in state, f"no window between evals: {state}")
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in state["prof"].events()
                   if str(getattr(e, "device_type", "")).endswith("CUDA")
                   and not getattr(e, "is_user_annotation", False))
    busy, cur_a, cur_b = 0.0, None, None
    for a, b in spans:
        if cur_b is None or a > cur_b:
            if cur_b is not None:
                busy += cur_b - cur_a
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    if cur_b is not None:
        busy += cur_b - cur_a
    window = (state["t1"] - state["t0"]) * 1e6
    require(busy > 0, "the profiled window holds no device activity")
    return window / 1e3, busy / 1e3, max(0.0, 1.0 - busy / window)


def phase_pipeline(smi, main_runs, sess):
    """``pipeline_depth=2``: RunLog and params bit-identical to [main]'s
    serial runs, no host sync between evals (the counter, and PyTorch's
    sync debug mode over the windows between evals), and member steps/s
    serial against pipelined in one warm session."""
    import warnings
    import torch
    from repro_torch.engine.engine import CohortRunner
    from repro_torch.kernels.dp_clip import dp_clip
    s_max = _steps(_main_cfg())
    sched = ("pipeline_depth", "blocking_submits", "drain_waits",
             "host_syncs_between_evals")
    from repro_torch.api import ExperimentSpec
    spec = _main_spec("fedasync")
    for kind in ("fedasync", "fedavg"):
        walls = {1: [], 2: []}
        for depth in (1, 2, 2, 1):          # turns: serial, pipelined x2
            dp_clip.reset_launches()
            real_b, real_d = CohortRunner.eval_boundary, CohortRunner.drain
            caught = []
            if depth == 2:
                # sync debug mode on between evals, off inside evals and
                # backpressure drains (the sanctioned waits)
                def boundary(self, inside, _real=real_b):
                    torch.cuda.set_sync_debug_mode(0 if inside else "warn")
                    return _real(self, inside)

                def drain(self, inflight, _real=real_d):
                    torch.cuda.set_sync_debug_mode(0)
                    try:
                        return _real(self, inflight)
                    finally:
                        torch.cuda.set_sync_debug_mode("warn")

                CohortRunner.eval_boundary = boundary
                CohortRunner.drain = drain
            try:
                with warnings.catch_warnings(record=True) as caught:
                    warnings.simplefilter("always")
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    p, lg = sess.run(_main_spec(kind, pipeline_depth=depth))
                    torch.cuda.synchronize()
                    walls[depth].append(time.perf_counter() - t0)
            finally:
                torch.cuda.set_sync_debug_mode(0)
                CohortRunner.eval_boundary, CohortRunner.drain = real_b, real_d
            p0, l0, _ = main_runs[kind]
            _same_run((p0, l0), (p, lg), f"[pipeline] {kind} depth {depth}",
                      stats_drop=sched)
            st = lg.engine_stats
            _require_launches("pipeline", st["cohorts"], s_max)
            if depth == 2:
                syncs = [str(w.message)[:120] for w in caught
                         if "synchroniz" in str(w.message).lower()]
                require(st["host_syncs_between_evals"] == 0
                        and st["blocking_submits"] == 0,
                        f"[pipeline] {kind}: {st}")
                require(not syncs, f"[pipeline] {kind}: sync debug mode "
                        f"caught {len(syncs)} syncs between evals: "
                        f"{sorted(set(syncs))[:3]}")
                drains = st["drain_waits"]
        steps = s_max * sum(lg.cohort_sizes)
        rate = {d: [round(steps / w, 2) for w in ws]
                for d, ws in walls.items()}
        log(f"[pipeline] {smi}; {kind}: RunLog and params bit-identical to "
            f"[main] in all 4 turns; pipelined: host_syncs_between_evals 0, "
            f"blocking_submits 0, drain_waits {drains}, sync debug warnings "
            f"between evals 0; member steps/s serial {rate[1]} vs pipelined "
            f"{rate[2]} (warm session, turns serial, pipelined, pipelined, "
            f"serial; evals included)")
    # one profiled window between evals of a FedAsync run, each driver
    import dataclasses
    for depth in (1, 2):
        sp = ExperimentSpec.from_legacy(
            "fedasync", spec.testbed, max_updates=20, eval_every=10,
            engine_cfg=dataclasses.replace(spec.engine,
                                           pipeline_depth=depth))
        w, busy, idle = _window_idle_share(lambda: sess.run(sp))
        log(f"[pipeline] {smi}; profiled window between evals 1 and 2 "
            f"(FedAsync, depth {depth}): {w:.1f} ms wall, {busy:.1f} ms of "
            f"device kernels -> device idle share {idle:.3f}")


def phase_tiered(smi):
    """The tiered store at full width: FedAsync, depth 2,
    StoreConfig(hot_slots=128, lookahead=16), 32 updates over N = 1,000
    and N = 100,000 clients sharing one dataset dict (the reference's
    bench_scale set-up at the full-width SERConfig)."""
    import gc
    import shutil
    import tempfile
    import torch
    from repro_torch.api.workloads import get_workload
    from repro_torch.core.aggregation import FedAsync
    from repro_torch.core.testbed import build_clients, build_partitions
    from repro_torch.engine import resilience
    from repro_torch.engine.cohort import steps_per_round
    from repro_torch.engine.engine import (
        CohortRunner, EngineConfig, run_async_engine)
    from repro_torch.engine.statestore import StoreConfig
    from repro_torch.kernels.dp_clip import dp_clip
    from repro_torch.pytree import tree_leaves
    base = _main_cfg()
    splits, pooled = build_partitions(base)
    tmpl = splits[0][0]          # every client shares client 0's dataset
    wl = get_workload(base.workload)
    params0 = wl.init(base.seed, base.model, "cuda")
    acc_fn = wl.shared_accuracy(base.model)
    s_max = steps_per_round(tmpl["y"].shape[0], base.batch_size,
                            base.local_epochs)
    hot, look, updates = 128, 16, 32

    def nbytes(tree):
        return sum(l.numel() * l.element_size() for l in tree_leaves(tree))

    def go(n, store, **kw):
        ec = EngineConfig(staleness_window=60.0, max_cohort=8,
                          pipeline_depth=2, store=store)
        gc.collect()                 # the last run's runner and arenas
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        clients = build_clients(base, [splits[0]] * n)
        runner = CohortRunner(clients, ec, "cuda")
        first = []
        real_stage = runner.stage_cohort

        def stage(plans):
            if not first:
                first.append(time.perf_counter())
            return real_stage(plans)

        runner.stage_cohort = stage
        p, lg = run_async_engine(clients, params0, acc_fn, pooled,
                                 FedAsync(alpha=0.4), max_updates=updates,
                                 seed=0, eval_every=10 ** 9, runner=runner,
                                 **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        del runner.stage_cohort
        return dict(params=p, log=lg, wall=wall, startup=first[0] - t0,
                    state_bytes=nbytes(runner._arena_params)
                    + nbytes(runner._arena_opt),
                    data_bytes=nbytes(runner._arena_data),
                    row_bytes=(nbytes(runner._arena_params)
                               + nbytes(runner._arena_opt))
                    // runner.arena_slots,
                    peak=torch.cuda.max_memory_allocated())

    tiered = StoreConfig(hot_slots=hot, lookahead=look)
    dp_clip.reset_launches()
    resident = go(1_000, StoreConfig())
    _require_launches("tiered", resident["log"].engine_stats["cohorts"],
                      s_max)
    rows = {}
    for n in (1_000, 100_000):
        dp_clip.reset_launches()
        r = go(n, tiered)
        st = r["log"].engine_stats
        _require_launches("tiered", st["cohorts"], s_max)
        require(st["store_fetches"] == st["store_hot_hits"]
                + st["store_prefetch_hits"] + st["store_stall_waits"],
                f"[tiered] N={n}: store ledger {st}")
        require(st["host_syncs_between_evals"] == 0
                and st["blocking_submits"] == 0, f"[tiered] N={n}: {st}")
        require(sum(r["log"].update_counts.values()) >= updates,
                f"[tiered] N={n}: updates {r['log'].update_counts}")
        rows[n] = r
        resident_eq = r["row_bytes"] * (n + 1) + r["data_bytes"]
        store = {k[6:]: v for k, v in st.items() if k.startswith("store_")}
        log(f"[tiered] {smi}; N={n}: hot arena {r['state_bytes']} bytes "
            f"({hot + 1} rows) + data {r['data_bytes']} bytes; all-resident "
            f"equivalent {resident_eq / 1e9:.2f} GB; peak device memory "
            f"{r['peak'] / 2 ** 30:.2f} GiB; startup {r['startup']:.2f} s, "
            f"wall {r['wall']:.2f} s, {updates / r['wall']:.2f} updates/s; "
            f"cohorts {st['cohorts']} sizes {r['log'].cohort_sizes}; store "
            f"{store}; drain_waits {st['drain_waits']}")
    require(rows[1_000]["state_bytes"] == rows[100_000]["state_bytes"],
            "[tiered] hot-arena bytes differ between N = 1,000 and 100,000")
    _same_run((resident["params"], resident["log"]),
              (rows[1_000]["params"], rows[1_000]["log"]),
              "[tiered] N=1000 vs all-resident")
    log(f"[tiered] N=1000 tiered vs all-resident ({resident['state_bytes']} "
        f"bytes of client state, peak {resident['peak'] / 2 ** 30:.2f} GiB):"
        f" RunLog and params bit-identical")
    # churn: 24 clients over 8 hot slots, so rows spill to pinned host
    # memory and come back through the side stream
    churn = StoreConfig(hot_slots=8, lookahead=4)

    def go_churn(store):
        ec = EngineConfig(staleness_window=60.0, max_cohort=4,
                          pipeline_depth=2, store=store)
        clients = build_clients(base, [splits[0]] * 24)
        return run_async_engine(
            clients, params0, acc_fn, pooled, FedAsync(alpha=0.4),
            max_updates=48, seed=0, eval_every=16,
            runner=CohortRunner(clients, ec, "cuda"))

    dp_clip.reset_launches()
    p_res, l_res = go_churn(StoreConfig())
    p_tier, l_tier = go_churn(churn)
    _require_launches("tiered", l_res.engine_stats["cohorts"]
                      + l_tier.engine_stats["cohorts"], s_max)
    _same_run((p_res, l_res), (p_tier, l_tier), "[tiered] churn")
    st = l_tier.engine_stats
    store = {k[6:]: v for k, v in st.items() if k.startswith("store_")}
    require(st["store_spill_bytes"] > 0 and st["store_evictions"] > 0
            and st["store_fetches"] == st["store_hot_hits"]
            + st["store_prefetch_hits"] + st["store_stall_waits"]
            and st["host_syncs_between_evals"] == 0, f"[tiered] churn {st}")
    log(f"[tiered] {smi}; churn (24 clients, hot_slots 8, lookahead 4, 48 "
        f"updates): RunLog and params bit-identical to all-resident; store "
        f"{store}; H2D bytes {st['h2d_bytes_total']} (cold rows included); "
        f"host_syncs_between_evals 0")
    # a tiered crash/resume at N = 1,000
    root = ROOT / "build"
    root.mkdir(exist_ok=True)
    ckdir = tempfile.mkdtemp(prefix="tiered_", dir=root)
    try:
        try:
            go(1_000, tiered, checkpoint=resilience.CheckpointPolicy(
                ckdir, every=16, crash_after_saves=1))
            require(False, "[tiered] no simulated crash")
        except resilience.SimulatedCrash:
            pass
        res = go(1_000, tiered, resume_from=ckdir)
        _same_run((rows[1_000]["params"], rows[1_000]["log"]),
                  (res["params"], res["log"]), "[tiered] resume",
                  stats_drop=("drain_waits",))
        size = sum(f.stat().st_size for f in pathlib.Path(ckdir).iterdir())
        log(f"[tiered] N=1000 crash after the snapshot at 16 updates "
            f"({size} bytes) and resume: RunLog, params and store counters "
            f"bit-identical")
    finally:
        shutil.rmtree(ckdir)


def phase_api(smi):
    """``Session.sweep`` on the card: the [main] configuration over sigma x
    strategy, cold (the step cache emptied first) and again warm."""
    import torch
    from repro_torch.analysis.guard import sweep_max_builds
    from repro_torch.api import ExperimentSpec, RunBudget, Session, \
        StrategySpec
    from repro_torch.engine import cohort_step
    from repro_torch.engine.engine import EngineConfig
    from repro_torch.kernels.dp_clip import dp_clip
    spec = ExperimentSpec(
        testbed=_main_cfg(), strategy=StrategySpec("fedasync", alpha=0.4),
        run=RunBudget(rounds=1, max_updates=10, eval_every=10),
        engine=EngineConfig(staleness_window=120.0, max_cohort=4))
    axes = {"testbed.sigma": [0.5, 1.0, 1.5, 2.0],
            "strategy": [StrategySpec("fedavg"),
                         StrategySpec("fedasync", alpha=0.4)]}
    sess = Session()
    cohort_step.invalidate_step_cache()
    walls, rates, deltas, launches = {}, {}, {}, {}
    for turn in ("cold", "warm"):
        b0 = cohort_step.step_builds()
        dp_clip.reset_launches()
        res = sess.sweep(spec, axes)
        torch.cuda.synchronize()
        deltas[turn] = cohort_step.step_builds() - b0
        launches[turn] = (dp_clip.sqnorm_launches,
                          dp_clip.scale_mean_launches)
        walls[turn] = res.wall_s
        rates[turn] = [_steps(s.testbed) * sum(log_.cohort_sizes) / w
                       for s, log_, w in zip(res.specs, res.logs, res.wall_s)]
        for point, log_ in zip(res.points, res.logs):
            info = log_.engine_stats["pallas_interpret"]
            require(info["kernel"] == "triton" and info["launches"] > 0,
                    f"[api] {turn} {point}: kernels not recorded: {info}")
        require(launches[turn][0] == launches[turn][1] > 0,
                f"[api] {turn}: dp_clip launches {launches[turn]}")
    # what a step-cache miss costs: one make_cohort_step call of this
    # configuration (closures only; the port compiles nothing), best of 20
    c0 = sess._clients[0]
    build_s = []
    for _ in range(20):
        t0 = time.perf_counter()
        cohort_step.make_cohort_step(c0.loss_fn, c0.dp_cfg, c0.opt,
                                     use_dp=c0.use_dp, dp_path=c0.dp_path)
        build_s.append(time.perf_counter() - t0)
    budget = sweep_max_builds(res.specs)
    require(deltas["cold"] <= budget,
            f"[api] cold sweep built {deltas['cold']} steps, budget {budget}")
    require(deltas["warm"] == 0,
            f"[api] warm sweep built {deltas['warm']} steps")
    log(f"[api] {smi}; Session.sweep over sigma x strategy (8 points, full "
        f"width, 1 round / 10 updates each): step builds cold "
        f"{deltas['cold']} (budget {budget}), warm {deltas['warm']}; "
        f"dp_clip launches (norms, mean) cold {launches['cold']} warm "
        f"{launches['warm']}")
    for turn in ("cold", "warm"):
        log(f"[api] {turn} wall per point (s): "
            f"{[round(w, 3) for w in walls[turn]]}; sum "
            f"{sum(walls[turn]):.3f} s; member local steps/s per point "
            f"{[round(r, 1) for r in rates[turn]]}")
    log(f"[api] one make_cohort_step build (a step-cache miss): "
        f"{min(build_s) * 1e6:.1f} us best of 20, median "
        f"{sorted(build_s)[10] * 1e6:.1f} us; the shortest warm sweep point "
        f"{min(walls['warm']):.3f} s")
    for row in res.table():
        log(f"[api]   {row}")
    log(f"[api] session layers: {sess.stats()}")


def phase_legacy(smi):
    """The legacy per-client loop at full width in one Session: one FedAvg
    round, then 10 FedAsync updates; every client local step is one K = 1
    dp_clip call.  The same FedAsync spec then runs on the engine at
    ``staleness_window=0`` (cohorts of one) in the same session, for
    member local steps/s side by side."""
    import dataclasses
    import torch
    from repro_torch.api import ExperimentSpec, RunBudget, Session, \
        StrategySpec
    from repro_torch.kernels.dp_clip import dp_clip, ops
    cfg = _main_cfg()
    steps = _steps(cfg)
    specs = {
        "fedavg": ExperimentSpec(testbed=cfg, strategy=StrategySpec("fedavg"),
                                 run=RunBudget(rounds=1), backend="legacy"),
        "fedasync": ExperimentSpec(
            testbed=cfg, strategy=StrategySpec("fedasync", alpha=0.4),
            run=RunBudget(max_updates=10, eval_every=10), backend="legacy")}
    sess = Session()
    ks = []
    real = ops.dp_clip_mean_noise_cohort

    def recorded(g, *a, **kw):
        ks.append(int(g.shape[0]))
        return real(g, *a, **kw)

    ops.dp_clip_mean_noise_cohort = recorded
    try:
        walls, counts = {}, {}
        for name, spec in specs.items():
            dp_clip.reset_launches()
            t0 = time.perf_counter()
            p, log_ = sess.run(spec)
            torch.cuda.synchronize()
            walls[name] = time.perf_counter() - t0
            updates = sum(log_.update_counts.values())
            # local trains: every client per round (fedavg); every client
            # at start, then one re-dispatch per merge but the last (async)
            trains = (5 * spec.run.rounds if name == "fedavg"
                      else 5 + updates - 1)
            counts[name] = (dp_clip.sqnorm_launches,
                            dp_clip.scale_mean_launches, trains * steps)
            require(counts[name][0] == counts[name][1] == trains * steps,
                    f"[legacy] {name}: launches {counts[name][:2]}, "
                    f"expected {trains} local trains x {steps} steps")
            _check_finite(p, f"[legacy] {name}")
    finally:
        ops.dp_clip_mean_noise_cohort = real
    require(set(ks) == {1}, f"[legacy] dp_clip cohort sizes {set(ks)}")
    for name in walls:
        n = counts[name][2]
        log(f"[legacy] {smi}; {name}: {n} client local steps, launches "
            f"(norms, mean) {counts[name][:2]} all at K = 1; "
            f"{walls[name]:.3f} s wall = {n / walls[name]:.2f} member local "
            f"steps/s (one eval, the testbed built in the fedavg run)")
    engine_spec = dataclasses.replace(specs["fedasync"], backend="cohort")
    for turn in ("first", "warm"):
        t0 = time.perf_counter()
        _, log_ = sess.run(engine_spec)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n = steps * sum(log_.cohort_sizes)
        log(f"[legacy] the same fedasync spec on the engine "
            f"(staleness_window=0, cohorts of one), {turn} run: {n} member "
            f"local steps, {wall:.3f} s wall = {n / wall:.2f} member local "
            f"steps/s")


def _check_finite(params, what):
    import torch
    from repro_torch.pytree import tree_leaves
    for leaf in tree_leaves(params):
        require(bool(torch.isfinite(leaf).all()), f"{what}: nonfinite params")


def _robust_specs(tb, threshold, fedavg_faults, fedavg_kw):
    import dataclasses
    from repro_torch.api import ExperimentSpec, RunBudget, StrategySpec
    from repro_torch.core.faults import FaultModel
    from repro_torch.core.screening import ScreeningConfig
    tb = dataclasses.replace(tb, screening=ScreeningConfig(
        max_update_norm=threshold, quarantine_after=2))
    return {
        "fedasync_normbound": ExperimentSpec(
            testbed=dataclasses.replace(
                tb, faults=FaultModel(**ROBUST_FAULTS)),
            strategy=StrategySpec("fedasync_normbound", alpha=0.4,
                                  norm_bound=threshold / 10),
            run=RunBudget(max_updates=10, eval_every=5)),
        "fedavg_trimmed": ExperimentSpec(
            testbed=dataclasses.replace(
                tb, faults=FaultModel(**fedavg_faults)),
            strategy=StrategySpec("fedavg_trimmed", trim_frac=0.34),
            run=RunBudget(rounds=3, eval_every=1), **fedavg_kw)}


def _screened(sess, spec):
    """Run ``spec``, recording every screen verdict's (cid, t, finite,
    norm)."""
    from repro_torch.core.screening import ScreeningState
    calls = []
    screen = ScreeningState.screen

    def recorded(self, cid, t, finite, norm):
        calls.append((cid, t, bool(finite), float(norm)))
        return screen(self, cid, t, finite, norm)

    ScreeningState.screen = recorded
    try:
        params, log_ = sess.run(spec)
    finally:
        ScreeningState.screen = screen
    return params, log_, calls


def _ledger(log_, calls, threshold, what, deadline_ok):
    """The screening ledger laws, and every corrupted upload at scale >= 10
    rejected (a norm reject, or dropped while its client is suspended).
    A corrupted upload dropped at the round's deadline never meets the
    screen: allowed only where ``deadline_ok``, and returned apart."""
    st = log_.engine_stats
    require(st["screen_rejections"]
            == st["screen_nonfinite"] + st["screen_norm_rejects"],
            f"{what}: screen_rejections != nonfinite + norm rejects: {st}")
    require(st["screen_verdict_syncs"] == st["cohorts"],
            f"{what}: verdict fetches {st['screen_verdict_syncs']} for "
            f"{st['cohorts']} cohorts")
    events = {(k, c, t) for k, c, t in log_.fault_events}
    scaled = [(c, t) for k, c, t in log_.fault_events if k == "corrupt_scale"]
    late = [(c, t) for c, t in scaled if ("deadline_drop", c, t) in events]
    require(deadline_ok or not late,
            f"{what}: corrupted uploads {late} dropped at the deadline, "
            f"before the screen")
    for c, t in scaled:
        require(("screen_norm", c, t) in events
                or ("quarantine_drop", c, t) in events
                or (c, t) in late,
                f"{what}: corrupted upload of client {c} at t={t} merged")
    by_key = {(c, t): n for c, t, f, n in calls if f}
    bad = {(c, t) for c, t in scaled}
    clean = [n for k, n in by_key.items() if k not in bad]
    hot = [n for k, n in by_key.items() if k in bad]
    require(all(n < threshold / 2 for n in clean)
            and all(n > 2 * threshold for n in hot),
            f"{what}: norms too close to the threshold {threshold}: clean "
            f"{clean} corrupted {hot}")
    return scaled, late, clean, hot


def phase_robust(smi):
    """Faults + screening: the tiny testbed on the card against the CPU
    plain route, then the full width on the card (ledger laws, a
    bit-identical rerun)."""
    import dataclasses
    import torch
    from repro_torch.api import Session
    from repro_torch.core.testbed import TestbedConfig
    from repro_torch.data.synthetic_ser import SERDataConfig
    from repro_torch.engine.engine import EngineConfig
    from repro_torch.models.ser_cnn import SERConfig
    from repro_torch.pytree import tree_leaves
    dims = dict(time_frames=12, n_mels=12)
    small = TestbedConfig(
        batch_size=16, sigma=0.0, dp_path="pallas", seed=3,
        data=SERDataConfig(n_total=360, **dims),
        model=SERConfig(channels1=8, channels2=16, fc_dim=32, **dims))
    specs = _robust_specs(small, SMALL_THRESHOLD, FEDAVG_FAULTS,
                          dict(engine=EngineConfig(max_cohort=2)))
    gpu, cpu = Session(), Session(device="cpu")
    for name, spec in specs.items():
        p_g, l_g, c_g = _screened(gpu, spec)
        p_c, l_c, c_c = _screened(cpu, spec)
        for f in ("fault_events", "times", "update_counts", "staleness",
                  "eps_trajectory", "cohort_sizes"):
            require(getattr(l_g, f) == getattr(l_c, f),
                    f"[robust] small {name}: {f} differs card vs CPU")
        keys = [k for k in l_g.engine_stats
                if k.startswith(("fault_", "screen_", "degraded", "deadline"))]
        require({k: l_g.engine_stats[k] for k in keys}
                == {k: l_c.engine_stats[k] for k in keys},
                f"[robust] small {name}: counters differ card vs CPU")
        d = max(float((a.cpu() - b).abs().max())
                for a, b in zip(tree_leaves(p_g), tree_leaves(p_c)))
        require(d < 1e-2, f"[robust] small {name}: params differ by {d}")
        _ledger(l_g, c_g, SMALL_THRESHOLD, f"[robust] small {name}",
                deadline_ok=True)
        log(f"[robust] small {name}: card vs CPU fault events "
            f"({len(l_g.fault_events)}), counters, bookkeeping equal, max "
            f"|dparam| {d:.3e}; counters "
            f"{ {k: l_g.engine_stats[k] for k in keys if l_g.engine_stats[k]} }")
    full = _robust_specs(_main_cfg(), FULL_THRESHOLD, FULL_FEDAVG_FAULTS, dict(
        engine=EngineConfig(staleness_window=120.0, max_cohort=4)))
    full["fedasync_normbound"] = dataclasses.replace(
        full["fedasync_normbound"],
        engine=EngineConfig(staleness_window=120.0, max_cohort=4))
    sess = Session()
    for name, spec in full.items():
        t0 = time.perf_counter()
        p1, l1, c1 = _screened(sess, spec)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        p2, l2, c2 = _screened(sess, spec)
        _check_finite(p1, f"[robust] full {name}")
        for a, b in zip(tree_leaves(p1), tree_leaves(p2)):
            require(torch.equal(a, b), f"[robust] full {name}: rerun params "
                    "are not bit-identical")
        for f in ("fault_events", "times", "global_acc", "update_counts",
                  "eps_trajectory", "cohort_sizes", "engine_stats"):
            require(getattr(l1, f) == getattr(l2, f),
                    f"[robust] full {name}: rerun RunLog.{f} differs")
        require(repr(c1) == repr(c2),
                f"[robust] full {name}: rerun verdicts differ")
        scaled, _, clean, hot = _ledger(l1, c1, FULL_THRESHOLD,
                                        f"[robust] full {name}",
                                        deadline_ok=False)
        st = l1.engine_stats
        events = {tuple(e) for e in l1.fault_events}
        norm_rejected = sum(("screen_norm", c, t) in events
                            for c, t in scaled)
        log(f"[robust] {smi}; full {name}: {sum(l1.update_counts.values())} "
            f"updates in {wall:.3f} s; corrupted x50 uploads {len(scaled)}, "
            f"each delivered and rejected ({norm_rejected} norm rejects, "
            f"{len(scaled) - norm_rejected} dropped in quarantine), deadline "
            f"drops {st['deadline_drops']}; screen counters "
            f"{ {k: v for k, v in st.items() if k.startswith('screen_')} }; "
            f"update norms clean {min(clean):.3f}-{max(clean):.3f}, "
            f"corrupted {[round(n, 1) for n in hot]} (threshold "
            f"{FULL_THRESHOLD}); rerun bit-identical")


def phase_breakdown(smi):
    """Where one full-width K=4 cohort's time goes: a profiled cohort step
    (wall vs summed device-kernel time = the idle share) and the fused
    step's stages timed with CUDA events."""
    import numpy as np
    import torch
    from torch.func import vmap
    from repro_torch.core.dp import per_example_grads
    from repro_torch.core.testbed import TestbedConfig, build_testbed
    from repro_torch.engine.cohort_step import take_rows
    from repro_torch.engine.engine import CohortRunner, EngineConfig
    from repro_torch.kernels.dp_clip.ops import dp_clip_mean_noise_cohort
    from repro_torch.pytree import (
        tree_flatten_to_vector, tree_unflatten_from_vector)
    cfg = TestbedConfig(batch_size=128, sigma=1.0, dp_path="pallas")
    clients, params, acc_fn, pooled = build_testbed(cfg)
    runner = CohortRunner(clients, EngineConfig(max_cohort=4), params[
        "out"]["w"].device)
    seeds = iter(range(1, 100))

    def cohort():
        plans = [runner.dispatch(c, params, next(seeds), 0)
                 for c in clients[:4]]
        t0 = time.perf_counter()
        runner.run_cohort(plans)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    cohort()                                   # warm-up (cuDNN, Triton)
    walls = [cohort() for _ in range(2)]
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        wall = cohort()
    dev_us, by_name = 0.0, {}
    for e in prof.key_averages():
        if not str(getattr(e, "device_type", "")).endswith("CUDA"):
            continue                      # CPU ops; their kernels count below
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = getattr(e, "self_cuda_time_total", 0.0)
        if t > 0:
            dev_us += t
            by_name[e.key] = t
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    s_max = runner.s_max
    log(f"[breakdown] {smi}; one K=4 cohort ({s_max} local steps, B=128, "
        f"D=317124): wall {min(walls) * 1e3:.1f} ms unprofiled, "
        f"{wall * 1e3:.1f} ms profiled; device kernels {dev_us / 1e3:.1f} ms "
        f"-> device idle share {max(0.0, 1 - dev_us / 1e6 / wall):.3f}")
    for name, t in top:
        log(f"[breakdown]   {t / 1e3:9.2f} ms  {name[:90]}")

    # stages of one fused local step, timed alone
    k = 4
    slots = torch.arange(k, device=runner.device)
    p = take_rows(runner._arena_params, slots)
    o = take_rows(runner._arena_opt, slots)
    idx = torch.from_numpy(np.stack([
        np.arange(128) + 128 * i for i in range(k)])).to(runner.device)
    batch = {kk: l[slots[:, None], idx] for kk, l in
             runner._arena_data.items()}
    member_grads = vmap(lambda pp, bb: per_example_grads(
        clients[0].loss_fn, pp, bb))
    z = torch.randn((k, 317124), device=runner.device)
    std = torch.tensor([1.0 / 128], device=runner.device)
    template = {kk: {n: v[0] for n, v in sub.items()} for kk, sub in p.items()}
    g = member_grads(p, batch)
    flat = tree_flatten_to_vector(g, lead=2)
    means = dp_clip_mean_noise_cohort(flat, 1.0, std, z)[0]
    grads = tree_unflatten_from_vector(means, template, lead=1)
    stages = {
        "per-example grads (vmap o vmap o grad)": lambda: member_grads(p, batch),
        "flatten to (K, B, D)": lambda: tree_flatten_to_vector(g, lead=2),
        "noise draws z (K x D)": lambda: torch.randn((k, 317124),
                                                   device=runner.device),
        "dp_clip op (Triton norms pass, clipped mean + glue)":
            lambda: dp_clip_mean_noise_cohort(flat, 1.0, std, z),
        "batched Adam": lambda: clients[0].opt.update(grads, o, p),
        "eval: pooled-test accuracy": lambda: acc_fn(params, pooled),
    }
    for name, fn in stages.items():
        log(f"[breakdown] stage {name}: {_eager_ms(fn, iters=5):.3f} ms")


# ---------------------------------------------------------------------------
# the serving slice: zamba2-1.2b with the ssd_intra_chunk and flash_decode
# CUDA C++ kernels
# ---------------------------------------------------------------------------

# zamba2-1.2b at full width: B = 8 prompts of 2048 tokens, 64 decode steps
SERVE_B, SERVE_S, SERVE_STEPS = 8, 2048, 64
SSD_FULL = (8, 16, 128, 64, 64, 64)        # (b, c, q, h, p, n) of a prefill
FLASH_FULL = (8, 2112, 32, 32, 64)         # (B, S, H, Hkv, Dh) of a decode
# (b, c, q, h, p, n): the full-width shape, then tests/test_kernels.py's,
# then ragged ones: q and n not multiples of 16 (element copies where n or
# p is not a multiple of 8), p of two 64-column chunks with n past 128
SSD_SHAPES = [SSD_FULL, (1, 2, 32, 2, 16, 16), (2, 4, 64, 4, 64, 64),
              (1, 1, 128, 8, 64, 32), (1, 1, 20, 2, 16, 12),
              (2, 3, 36, 3, 24, 40), (1, 2, 64, 2, 128, 160)]
# zamba2-1.2b training on one rank of a model axis of 2 ([mesh-model]):
# per_micro 2, seq 256 in chunks of 128, 32 of the 64 SSM heads
SSD_MODEL_RANK = (2, 2, 128, 32, 64, 64)
SSD_SHAPES.append(SSD_MODEL_RANK)
# (B, S, H, Hkv, Dh, window, softcap, pos range): the full-width decode,
# GQA, windows, softcap, S below one tile, ragged S with Dh 256, pos = 0
FLASH_CASES = [FLASH_FULL + (0, 0.0, (2048, 2112)),
               (2, 256, 8, 2, 64, 0, 0.0, (128, 256)),
               (1, 512, 4, 4, 128, 128, 0.0, (256, 512)),
               (3, 384, 6, 2, 32, 100, 0.0, (192, 384)),
               (2, 128, 4, 4, 64, 0, 50.0, (64, 128)),
               (2, 20, 4, 4, 32, 0, 0.0, (0, 20)),
               (2, 267, 8, 2, 256, 7, 0.0, (0, 267)),
               (4, 100, 4, 1, 64, 0, 0.0, (0, 1)),
               # split-S cases: pos = 0 at full width (all but one split
               # empty), a window across split boundaries, GQA 56/8
               # at Dh 128 (deepseek), GQA 2 at Dh 256 with softcap
               # (gemma2)
               (8, 2112, 32, 32, 64, 0, 0.0, (0, 1)),
               (8, 2112, 32, 32, 64, 300, 0.0, (1000, 1100)),
               (2, 1024, 56, 8, 128, 0, 0.0, (512, 1024)),
               (2, 512, 8, 4, 256, 0, 50.0, (256, 512))]
# the zoo's decode shapes, in bf16 and f32 with q unscaled (so the softcap
# cases run in bf16 too): gemma2-2b's local and global layers past its
# 4096 window with softcap 50, phi-3-vision at Dh 96, GQA 3 (llama3.2-3b
# 24/8, smollm-360m 15/5, rounded up to 4 heads a block), deepseek's
# 56/8, the MoE models' 16/16, Whisper's self-attention and its
# cross-attention over 1500 frames at pos 1499 (23 chunks and a 28-key
# tail); then Dh 96 at every heads-per-block count, a window, softcap and
# pos = 0
ZOO_FLASH_CASES = [(4, 4640, 8, 4, 256, 4096, 50.0, (4200, 4640)),
                   (4, 4640, 8, 4, 256, 0, 50.0, (4200, 4640)),
                   (8, 2064, 32, 32, 96, 0, 0.0, (1800, 2064)),
                   (8, 2064, 24, 8, 128, 0, 0.0, (1800, 2064)),
                   (8, 2064, 15, 5, 64, 0, 0.0, (1800, 2064)),
                   (1, 520, 56, 8, 128, 0, 0.0, (500, 520)),
                   (8, 2064, 16, 16, 128, 0, 0.0, (1800, 2064)),
                   (8, 464, 20, 20, 64, 0, 0.0, (400, 464)),
                   (8, 1500, 20, 20, 64, 0, 0.0, (1499, 1500)),
                   (2, 300, 8, 1, 96, 50, 0.0, (0, 300)),
                   (3, 131, 6, 2, 96, 0, 0.0, (0, 131)),
                   (2, 256, 8, 4, 96, 0, 50.0, (100, 256)),
                   (2, 70, 4, 4, 96, 0, 0.0, (0, 1))]
# zamba2-1.2b's decode on one rank of a model axis of 2 ([serve-mesh]):
# 16 of its 32 kv heads and their 16 query heads
FLASH_HEAD_SHARD = (8, 2112, 16, 16, 64, 0, 0.0, (2048, 2112))
ZOO_FLASH_CASES.append(FLASH_HEAD_SHARD)
# smollm-360m's decode on one rank of a model axis of 2 under
# heads_padded ([serve-mesh]): the 3 kv heads its 8 (or 7) query heads
# read, and their 9 query heads, the rest zero-filled
FLASH_HEADS_PADDED = (2, 2064, 9, 3, 64, 0, 0.0, (1800, 2064))
ZOO_FLASH_CASES.append(FLASH_HEADS_PADDED)


def _ssd_inputs(shape, dtype, dev, seed=0):
    import torch
    b, c, q, h, p, n = shape
    gen = torch.Generator(dev).manual_seed(seed)
    xr = torch.randn((b, c, q, h, p), generator=gen, device=dev).to(dtype)
    ar = -torch.rand((b, h, c, q), generator=gen, device=dev) * 0.2
    Br = torch.randn((b, c, q, n), generator=gen, device=dev).to(dtype)
    Cr = torch.randn((b, c, q, n), generator=gen, device=dev).to(dtype)
    return xr, ar, Br, Cr


def _flash_inputs(case, dtype, dev, seed=0):
    import torch
    B, S, H, Hkv, Dh, _, softcap, (lo, hi) = case
    gen = torch.Generator(dev).manual_seed(seed)
    q = torch.randn((B, H, Dh), generator=gen, device=dev)
    q = (q * (4.0 if softcap else 1.0)).to(dtype)
    k = torch.randn((B, S, Hkv, Dh), generator=gen, device=dev).to(dtype)
    v = torch.randn((B, S, Hkv, Dh), generator=gen, device=dev).to(dtype)
    pos = torch.randint(lo, hi, (B,), generator=gen, device=dev,
                        dtype=torch.int32)
    return q, k, v, pos


def _kernel_name(mangled):
    """The ``*_kernel`` part of a mangled name: its parts are read in turn
    as length-prefixed names (``_ZN <len><name> <len><name> ...``)."""
    i = 3 if mangled.startswith("_ZN") else 2
    while i < len(mangled) and mangled[i].isdigit():
        j = i
        while mangled[j].isdigit():
            j += 1
        name = mangled[j:j + int(mangled[i:j])]
        if name.endswith("_kernel"):
            return name
        i = j + len(name)
    return mangled


def _ptxas_summary(text):
    """One line per kernel instantiation from ``nvcc -Xptxas -v``: its
    name with the template arguments, registers, static shared memory and
    spills."""
    import re
    out, name = [], None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            mangled = m.group(1)
            args = ",".join(["bf16" if "bfloat16" in mangled else "f32"]
                            + re.findall(r"Li(\d+)E", mangled))
            name = f"{_kernel_name(mangled)}<{args}>"
        elif "spill" in line and name:
            spill = line.strip()
        elif "Used" in line and name:
            out.append(f"{name}: {line.split(':', 1)[1].strip()}; {spill}")
            name = None
    return out


def start_build():
    """The CUDA C++ kernels' ``nvcc`` build (``kernels/build.py``: one
    ``nvcc`` per source, all at once), started in a background thread
    that runs nothing but those processes; :func:`phase_kernels_zoo`
    waits for it before the first CUDA kernel runs."""
    import threading
    from repro_torch.kernels import build
    box = {}

    def run():
        t0 = time.perf_counter()
        try:
            build.build()
        except BaseException as e:  # noqa: BLE001 — raised at the join
            box["error"] = e
        box["s"] = time.perf_counter() - t0

    thread = threading.Thread(target=run, name="nvcc-build")
    thread.start()
    return thread, box


def phase_kernels_zoo(dev, build_job):
    """The CUDA C++ kernels vs their plain versions on the card (the
    tolerances of tests/test_kernels.py); returns the max |kernel - plain|
    per kernel.  ``build_job``: :func:`start_build`'s thread, waited for
    here."""
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attn import flash_attn, ref as fref
    from repro_torch.kernels.ssd_scan import ref as sref, ssd_scan
    thread, box = build_job
    t0 = time.perf_counter()
    thread.join()
    if "error" in box:
        raise box["error"]
    build.library()
    log(f"[kernels-zoo] nvcc build of kernels/csrc into "
        f"{build.build_dir().relative_to(ROOT)}: {box['s']:.1f} s in the "
        f"background from the start; waited {time.perf_counter() - t0:.1f} "
        f"s for it here")
    for line in _ptxas_summary(build.build_log()):
        log(f"[kernels-zoo]   {line}")
    lib = build.library()
    for bf16 in (1, 0):
        for dh in flash_attn.HEAD_DIMS:
            smem = {rb: lib.flash_decode_smem_bytes(bf16, dh, rb)
                    for rb in flash_attn.HEADS_PER_BLOCK}
            log(f"[kernels-zoo]   flash_decode_split_kernel<"
                f"{'bf16' if bf16 else 'f32'},{dh},rb> dynamic shared "
                f"memory by rb (bytes): {smem}")
    errs = {"ssd_intra_chunk": 0.0, "flash_decode": 0.0}
    for shape in SSD_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            xr, ar, Br, Cr = _ssd_inputs(shape, dtype, dev)
            got = ssd_scan.ssd_intra_chunk(xr, ar, Br, Cr)
            torch.cuda.synchronize()
            want = sref.ssd_intra_chunk_ref(xr, ar, Br, Cr)
            if dtype == torch.float32:
                ok = torch.allclose(got, want, rtol=1e-4, atol=1e-4)
            else:
                ok = torch.allclose(got.float(), want, rtol=5e-2,
                                    atol=1e-2 * float(want.abs().max()))
            err = float((got.float() - want).abs().max())
            require(ok, f"ssd_intra_chunk disagrees at {shape} {dtype}: "
                    f"max |err| {err}")
            require(torch.equal(got, ssd_scan.ssd_intra_chunk(xr, ar, Br, Cr)),
                    f"ssd_intra_chunk rerun differs at {shape} {dtype}")
            errs["ssd_intra_chunk"] = max(errs["ssd_intra_chunk"], err)
            log(f"[kernels-zoo] ssd_intra_chunk {shape} "
                f"{str(dtype)[6:]}: max |err| {err:.3e} "
                f"(max |plain| {float(want.abs().max()):.3e})")
    for case in FLASH_CASES:
        for dtype in (torch.bfloat16, torch.float32):
            if case[6] and dtype == torch.bfloat16:
                continue          # softcap with q x 4 is checked in f32
            q, k, v, pos = _flash_inputs(case, dtype, dev)
            kw = dict(window=case[5], softcap=case[6])
            got = flash_attn.flash_decode(q, k, v, pos, **kw)
            torch.cuda.synchronize()
            want = fref.flash_decode_ref(q, k, v, pos, **kw)
            tol = 1e-5 if dtype == torch.float32 else 2e-2
            err = float((got.float() - want.float()).abs().max())
            require(torch.allclose(got.float(), want.float(), rtol=tol,
                                   atol=tol),
                    f"flash_decode disagrees at {case} {dtype}: {err}")
            require(torch.equal(got, flash_attn.flash_decode(q, k, v, pos,
                                                             **kw)),
                    f"flash_decode rerun differs at {case} {dtype}")
            errs["flash_decode"] = max(errs["flash_decode"], err)
            log(f"[kernels-zoo] flash_decode {case[:7]} {str(dtype)[6:]}: "
                f"max |err| {err:.3e}")
    for case in ZOO_FLASH_CASES:
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v, pos = _flash_inputs(case[:6] + (0.0, case[7]), dtype,
                                         dev)
            kw = dict(window=case[5], softcap=case[6])
            got = flash_attn.flash_decode(q, k, v, pos, **kw)
            torch.cuda.synchronize()
            want = fref.flash_decode_ref(q, k, v, pos, **kw)
            tol = 1e-5 if dtype == torch.float32 else 2e-2
            err = float((got.float() - want.float()).abs().max())
            require(torch.allclose(got.float(), want.float(), rtol=tol,
                                   atol=tol),
                    f"flash_decode disagrees at zoo case {case} {dtype}: "
                    f"{err}")
            require(torch.equal(got, flash_attn.flash_decode(q, k, v, pos,
                                                             **kw)),
                    f"flash_decode rerun differs at zoo case {case} {dtype}")
            errs["flash_decode"] = max(errs["flash_decode"], err)
            log(f"[kernels-zoo] flash_decode zoo {case[:7]} "
                f"{str(dtype)[6:]}: max |err| {err:.3e}")
    return errs


def phase_times_zoo(dev, smi):
    """Kernel / plain / library times and bounds at zamba2-1.2b's shapes."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.common import sm_count
    from repro_torch.kernels.flash_attn import flash_attn, ref as fref
    from repro_torch.kernels.ssd_scan import ref as sref, ssd_scan
    out = {}
    b, c, q, h, p, n = SSD_FULL
    xr, ar, Br, Cr = _ssd_inputs(SSD_FULL, torch.bfloat16, dev)
    t = _in_turns({
        "kernel": lambda: ssd_scan.ssd_intra_chunk(xr, ar, Br, Cr),
        "plain": lambda: sref.ssd_intra_chunk_ref(xr, ar, Br, Cr)},
        iters=10)
    tri = q * (q + 1) // 2                  # causal (i, j) pairs of a chunk
    nbytes = 2 * xr.numel() * 2 + ar.numel() * 4 + 2 * Br.numel() * 2
    flops = b * c * tri * 2 * n + b * c * h * tri * 2 * p
    bd = _bound(nbytes, flops, BF16_FLOPS)
    out["ssd_intra_chunk"] = dict(ms=t["kernel"], plain_ms=t["plain"],
                                  library_ms=None, bound_ms=bd[0],
                                  bound_by=bd[1])
    log(f"[times-zoo] {smi}; ssd_intra_chunk {SSD_FULL} bf16: kernel "
        f"{t['kernel']:.4f} ms plain {t['plain']:.4f} ms library none; "
        f"bound {bd[0]:.4f} ms ({bd[1]}: {nbytes / 1e6:.1f} MB, "
        f"{flops / 1e9:.2f} GFLOP)")

    B, S, H, Hkv, Dh = FLASH_FULL
    q_, k, v, _ = _flash_inputs(FLASH_CASES[0], torch.bfloat16, dev)
    n_split, chunk = flash_attn.split_plan(S, B, H, Hkv, sm_count(dev))
    log(f"[times-zoo] flash_decode {FLASH_FULL}: {n_split} splits, each "
        f"taking every {n_split}th chunk of {chunk} keys; grid {n_split} x "
        f"{Hkv} x {B} = {n_split * Hkv * B} blocks on {sm_count(dev)} SMs")
    qs, ks, vs = q_[:, :, None], k.transpose(1, 2), v.transpose(1, 2)
    for at in (S - 1, S // 2):
        pos = torch.full((B,), at, dtype=torch.int32, device=dev)
        mask = (torch.arange(S, device=dev)[None, :] <= pos[:, None].long())
        mask = mask[:, None, None, :]                   # (B, 1, 1, S)
        t = _in_turns({
            "kernel": lambda: flash_attn.flash_decode(q_, k, v, pos),
            "plain": lambda: fref.flash_decode_ref(q_, k, v, pos),
            "library": lambda: F.scaled_dot_product_attention(
                qs, ks, vs, attn_mask=mask)}, rounds=7,
            pair=("kernel", "library"))
        keys = int((pos.long() + 1).clamp(max=S).sum())  # keys the mask admits
        nbytes = 2 * keys * Hkv * Dh * 2 + 2 * q_.numel() * 2 + B * 4
        flops = 4 * keys * H * Dh
        bd = _bound(nbytes, flops, BF16_FLOPS)
        if at == S - 1:
            out["flash_decode"] = dict(ms=t["kernel"], plain_ms=t["plain"],
                                       library_ms=t["library"],
                                       bound_ms=bd[0], bound_by=bd[1])
        log(f"[times-zoo] {smi}; flash_decode {FLASH_FULL} bf16 pos={at}: "
            f"kernel {t['kernel']:.4f} ms plain {t['plain']:.4f} ms library "
            f"(scaled_dot_product_attention, bool mask) "
            f"{t['library']:.4f} ms; bound {bd[0]:.4f} ms ({bd[1]}: "
            f"{nbytes / 1e6:.1f} MB) = {bd[0] / t['kernel']:.3f} of it; "
            f"kernel faster than the library in {t['kernel wins']} turns")
    for name, case in ZOO_TIMED.items():
        _time_zoo_flash(name, case, dev, smi)
    return out


# flash_decode timed at four zoo shapes, pos = S - 1: gemma2-2b's local
# layer (its 4096 window admits 4096 of 4640 keys; softcap 50, so no
# library call computes it), phi-3-vision's Dh = 96, zamba2-1.2b's head
# shard on a model axis of 2 and smollm-360m's GQA groups of a
# heads_padded rank
ZOO_TIMED = {"gemma2-2b local": (4, 4640, 8, 4, 256, 4096, 50.0),
             "phi-3-vision-4.2b": (8, 2064, 32, 32, 96, 0, 0.0),
             "zamba2-1.2b head shard": FLASH_HEAD_SHARD[:5] + (0, 0.0),
             "smollm-360m heads_padded rank":
                 FLASH_HEADS_PADDED[:5] + (0, 0.0)}


def _time_zoo_flash(name, case, dev, smi):
    """Kernel, plain and (without softcap) SDPA times of ``flash_decode``
    at one zoo shape in bf16; the bound is the K and V bytes the mask
    admits (plus q, out and pos) over the memory rate."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.common import sm_count
    from repro_torch.kernels.flash_attn import flash_attn, ref as fref
    B, S, H, Hkv, Dh, window, softcap = case
    q, k, v, _ = _flash_inputs(case[:6] + (0.0, (0, 1)), torch.bfloat16, dev)
    pos = torch.full((B,), S - 1, dtype=torch.int32, device=dev)
    kw = dict(window=window, softcap=softcap)
    fns = {"kernel": lambda: flash_attn.flash_decode(q, k, v, pos, **kw),
           "plain": lambda: fref.flash_decode_ref(q, k, v, pos, **kw)}
    if not softcap:
        idx = torch.arange(S, device=dev)[None, :]
        mask = (idx <= pos[:, None].long())
        if window:
            mask &= idx > pos[:, None].long() - window
        mask = mask[:, None, None, :]
        qs, ks, vs = q[:, :, None], k.transpose(1, 2), v.transpose(1, 2)
        fns["library"] = lambda: F.scaled_dot_product_attention(
            qs, ks, vs, attn_mask=mask, enable_gqa=H != Hkv)
    t = _in_turns(fns, rounds=7 if "library" in fns else 2,
                  pair=("kernel", "library") if "library" in fns else None)
    keys = B * min(S, window or S)               # keys the mask admits
    nbytes = 2 * keys * Hkv * Dh * 2 + 2 * q.numel() * 2 + B * 4
    bd = _bound(nbytes, 4 * keys * H * Dh, BF16_FLOPS)
    n_split, chunk = flash_attn.split_plan(S, B, H, Hkv, sm_count(dev))
    lib = (f"library (scaled_dot_product_attention, bool mask) "
           f"{t['library']:.4f} ms, kernel faster in {t['kernel wins']} "
           f"turns" if "library" in t else "library none (softcap)")
    log(f"[times-zoo] {smi}; flash_decode {name} (B={B}, S={S}, H={H}, "
        f"Hkv={Hkv}, Dh={Dh}, window={window}, softcap={softcap}) bf16 "
        f"pos=S-1: kernel {t['kernel']:.4f} ms plain {t['plain']:.4f} ms "
        f"{lib}; bound {bd[0]:.4f} ms ({bd[1]}: {nbytes / 1e6:.1f} MB) = "
        f"{bd[0] / t['kernel']:.3f} of it; {n_split} splits of {chunk}-key "
        f"chunks")


def _serve(params, cfg, tokens, max_len, steps):
    """zamba2: one prefill, then ``steps`` greedy decode steps (see
    :func:`_serve_family`)."""
    return _serve_family(params, cfg, {"tokens": tokens}, max_len, steps)


def _serve_family(params, cfg, batch, max_len, steps):
    """One prefill of ``batch``, then ``steps`` greedy decode steps,
    through the entry points of ``cfg``'s family.  Returns the logits of
    every step, the generated tokens and the walls (s).  A VLM's decode
    positions are global (after its patch prefix)."""
    import torch
    from repro_torch.models.base import get_family
    fam = get_family(cfg.family)
    tokens = batch["tokens"]
    B, S = tokens.shape
    dev = tokens.device
    offset = cfg.n_patches if cfg.family == "vlm" else 0

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    cache = fam.init_cache(cfg, B, max_len, device=dev)
    sync()
    t0 = time.perf_counter()
    lg, cache = fam.prefill(params, batch, cfg, cache)
    sync()
    t_prefill = time.perf_counter() - t0
    logits, toks = [lg], []
    t0 = time.perf_counter()
    for t in range(steps):
        tok = lg.argmax(-1).to(torch.int32)[:, None]
        toks.append(tok)
        pos = torch.full((B,), offset + S + t, dtype=torch.int32, device=dev)
        lg, cache = fam.decode_step(params, cache, tok, pos, cfg)
        logits.append(lg)
    sync()
    t_decode = time.perf_counter() - t0
    return torch.stack(logits), torch.cat(toks, 1), t_prefill, t_decode


def _prompts(cfg, batch, seq_len, seed):
    """(batch, seq_len) int32 prompts of the synthetic token pipeline."""
    import torch
    from repro_torch.data.tokens import TokenDataConfig, make_batches
    data = TokenDataConfig(vocab=cfg.vocab, seq_len=seq_len, seed=seed)
    return torch.from_numpy(next(make_batches(data, 1, batch))["tokens"])


def phase_serve(dev, smi):
    """zamba2-1.2b at full width: prefill + 64 greedy decode steps."""
    import gc
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attn import flash_attn
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.models import hybrid
    from repro_torch.pytree import tree_leaves
    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config("zamba2-1.2b")
    t0 = time.perf_counter()
    params = hybrid.init_params(cfg, seed=0)
    torch.cuda.synchronize()
    n_params = sum(l.numel() for l in tree_leaves(params) if l is not None)
    log(f"[serve] zamba2-1.2b: {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.n_heads} heads, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab}, {n_params / 1e9:.4f} B params "
        f"({str(cfg.pdtype)[6:]}), random init "
        f"{time.perf_counter() - t0:.2f} s")
    require(n_params > 1.1e9, f"not the full-width model: {n_params}")
    tokens = _prompts(cfg, SERVE_B, SERVE_S, seed=0).to(dev)
    torch.cuda.reset_peak_memory_stats()
    ssd_scan.reset_launches()
    flash_attn.reset_launches()
    logits, toks, t_pf, t_dec = _serve(params, cfg, tokens,
                                       SERVE_S + SERVE_STEPS, SERVE_STEPS)
    launches = {"ssd_intra_chunk": ssd_scan.launches(),
                "flash_decode": flash_attn.launches()}
    peak = torch.cuda.max_memory_allocated()
    n_seg = hybrid.segment_plan(cfg)[0]
    require(launches["ssd_intra_chunk"] == cfg.n_layers,
            f"ssd_intra_chunk launched {launches['ssd_intra_chunk']} times, "
            f"expected one per Mamba2 layer ({cfg.n_layers})")
    require(launches["flash_decode"] == n_seg * SERVE_STEPS,
            f"flash_decode launched {launches['flash_decode']} times, "
            f"expected {n_seg} x {SERVE_STEPS}")
    require(bool(torch.isfinite(logits).all()), "non-finite logits")
    require(tuple(logits.shape) == (SERVE_STEPS + 1, SERVE_B, cfg.vocab),
            f"logits shape {tuple(logits.shape)}")
    log(f"[serve] {smi}; B={SERVE_B} prompt {SERVE_S}: prefill "
        f"{t_pf * 1e3:.1f} ms wall = {SERVE_B * SERVE_S / t_pf:.0f} prompt "
        f"tokens/s; decode {SERVE_STEPS} steps {t_dec * 1e3:.1f} ms = "
        f"{t_dec / SERVE_STEPS * 1e3:.2f} ms/step = "
        f"{SERVE_B * SERVE_STEPS / t_dec:.1f} generated tokens/s; peak "
        f"memory {peak / 2**30:.2f} GiB; launches {launches}")
    log(f"[serve] first generated tokens of row 0: {toks[0, :12].tolist()}")
    return params, cfg, tokens, logits, toks, launches


def phase_serve_small(dev):
    """The reduced zamba2 (one segment and one trailing Mamba2 layer, f32)
    on the card vs the CPU plain route, the same weights carried across
    by the converter."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attn import flash_attn
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.models import convert, hybrid
    cfg = get_config("zamba2-1.2b").reduced().replace(
        param_dtype="float32", n_layers=3)
    p_cpu = hybrid.init_params(cfg, seed=0, device="cpu")
    p_gpu = convert.params_from_numpy(convert.params_to_numpy(p_cpu), dev)
    toks = _prompts(cfg, 2, 64, seed=1)
    n_ssd, n_flash = ssd_scan.launches(), flash_attn.launches()
    lg_g, tk_g, _, _ = _serve(p_gpu, cfg, toks.to(dev), 68, 4)
    require((ssd_scan.launches() - n_ssd, flash_attn.launches() - n_flash)
            == (3, 4), "reduced hybrid on the card: not 3 ssd_intra_chunk "
            "and 4 flash_decode launches")
    lg_c, tk_c, _, _ = _serve(p_cpu, cfg, toks, 68, 4)
    err = float((lg_g.cpu() - lg_c).abs().max())
    require(torch.allclose(lg_g.cpu(), lg_c, rtol=1e-3, atol=1e-3),
            f"reduced hybrid: card vs CPU logits differ by {err}")
    require(torch.equal(tk_g.cpu(), tk_c), "reduced hybrid: tokens differ")
    log(f"[serve-small] reduced zamba2 (f32, 1 segment + 1 trailing layer): "
        f"card vs CPU plain route, prefill + 4 decode logits max |diff| "
        f"{err:.3e} (tolerance 1e-3), greedy tokens equal")


def phase_serve_rerun(params, cfg, tokens, logits, toks):
    """The full-width serve again: bit-identical logits and tokens (the
    kernels sum in a fixed order, with no atomics)."""
    import torch
    logits2, toks2, t_pf, t_dec = _serve(params, cfg, tokens,
                                         SERVE_S + SERVE_STEPS, SERVE_STEPS)
    require(torch.equal(logits, logits2), "serve rerun: logits differ")
    require(torch.equal(toks, toks2), "serve rerun: tokens differ")
    log(f"[serve-rerun] bit-identical logits ({SERVE_STEPS + 1} x "
        f"{SERVE_B} x {cfg.vocab}) and tokens; warm walls: prefill "
        f"{t_pf * 1e3:.1f} ms = {SERVE_B * SERVE_S / t_pf:.0f} prompt "
        f"tokens/s, decode {t_dec / SERVE_STEPS * 1e3:.2f} ms/step = "
        f"{SERVE_B * SERVE_STEPS / t_dec:.1f} generated tokens/s")


def _profile(fn):
    """Run ``fn`` under the profiler -> (wall s, device kernel s, top)."""
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return (wall,) + _device_time(prof)


def _device_time(prof):
    """A finished profile's device kernel time -> (s, top 10 by name)."""
    dev_us, by_name = 0.0, {}
    for e in prof.key_averages():
        if not str(getattr(e, "device_type", "")).endswith("CUDA"):
            continue                      # CPU ops; their kernels count below
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = getattr(e, "self_cuda_time_total", 0.0)
        if t > 0:
            dev_us += t
            by_name[e.key] = (t, e.count)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    return dev_us / 1e6, top


def phase_serve_breakdown(params, cfg, tokens, smi):
    """Where serving time goes: one profiled prefill and one profiled
    decode step (device kernel time against wall time = the idle share)."""
    import torch
    from repro_torch.models import hybrid
    B, S = tokens.shape
    cache = hybrid.init_cache(cfg, B, S + SERVE_STEPS, device=tokens.device)
    state = {}

    def prefill():
        state["lg"], _ = hybrid.prefill(params, {"tokens": tokens}, cfg,
                                        cache)

    def decode():
        tok = state["lg"].argmax(-1).to(torch.int32)[:, None]
        pos = torch.full((B,), S, dtype=torch.int32, device=tokens.device)
        hybrid.decode_step(params, cache, tok, pos, cfg)

    walls = {}
    for name, fn in (("prefill", prefill), ("decode step", decode)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0
    for name, fn in (("prefill", prefill), ("decode step", decode)):
        wall, dev_s, top = _profile(fn)
        log(f"[serve-breakdown] {smi}; {name}: wall {walls[name] * 1e3:.2f} "
            f"ms unprofiled, {wall * 1e3:.2f} ms profiled; device kernels "
            f"{dev_s * 1e3:.2f} ms -> device idle share "
            f"{max(0.0, 1 - dev_s / walls[name]):.3f} (unprofiled wall), "
            f"{max(0.0, 1 - dev_s / wall):.3f} (profiled)")
        for kname, (t, count) in top:
            log(f"[serve-breakdown]   {t / 1e3:9.3f} ms {count:5d}x  "
                f"{kname[:90]}")


# ---------------------------------------------------------------------------
# the rest of the architecture zoo: dense, MoE, xLSTM, Whisper and VLM
# serving at full width, decoding through flash_decode
# ---------------------------------------------------------------------------

# arch -> (batch, prompt tokens, decode steps); each at full width and
# full depth in bf16, random weights from seed 0; deepseek-coder-33b
# (66.7 GB of weights) last.  phi-3-vision's prompt is 576 patches +
# 1472 tokens, Whisper's 1500 frames + 448 tokens (its native context).
ZOO_SERVE = {"gemma2-2b": (4, 4608, 32),        # decode crosses the window
             "llama3.2-3b": (8, 2048, 16),
             "smollm-360m": (8, 2048, 16),
             "olmoe-1b-7b": (8, 2048, 16),
             "qwen2-moe-a2.7b": (8, 2048, 16),
             "xlstm-350m": (8, 2048, 16),
             "phi-3-vision-4.2b": (8, 1472, 16),
             "whisper-large-v3": (8, 448, 16),
             "deepseek-coder-33b": (1, 512, 8)}


def _zoo_batch(cfg, batch, seq_len, seed, dev):
    """Prompts of the synthetic token pipeline and, for Whisper and the
    VLM, stub frame / patch embeddings drawn from ``seed`` on ``dev``."""
    import torch
    out = {"tokens": _prompts(cfg, batch, seq_len, seed).to(dev)}
    gen = torch.Generator(dev).manual_seed(seed)
    stub = {"audio": ("frames", cfg.enc_frames),
            "vlm": ("patches", cfg.n_patches)}.get(cfg.family)
    if stub:
        out[stub[0]] = torch.randn((batch, stub[1], cfg.d_model),
                                   generator=gen, device=dev).to(cfg.pdtype)
    return out


def _attn_per_step(cfg):
    """flash_decode launches per decode step: one per attention
    application (Whisper: self and cross in every decoder layer)."""
    return {"ssm": 0, "audio": 2 * cfg.n_layers}.get(cfg.family,
                                                     cfg.n_layers)


def _free_card():
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def _serve_zoo_one(arch, dev, smi, tag="serve-zoo"):
    """One zoo architecture at full width: init, prefill and greedy decode
    with the kernels' counters set to 0 just before; returns (flash_decode
    launches, logits and tokens on the CPU)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attn import flash_attn
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.models.base import get_family
    from repro_torch.pytree import tree_leaves
    batch, seq_len, steps = ZOO_SERVE[arch]
    cfg = get_config(arch)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = get_family(cfg.family).init_params(cfg, seed=0)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    n_params = sum(l.numel() for l in tree_leaves(params))
    inputs = _zoo_batch(cfg, batch, seq_len, 0, dev)
    ssd_scan.reset_launches()
    flash_attn.reset_launches()
    logits, toks, t_pf, t_dec = _serve_family(
        params, cfg, inputs, seq_len + steps, steps)
    launches = flash_attn.launches()
    peak = torch.cuda.max_memory_allocated()
    want = _attn_per_step(cfg) * steps
    require(launches == want, f"{arch}: flash_decode launched {launches} "
            f"times, expected {_attn_per_step(cfg)} x {steps}")
    require(ssd_scan.launches() == 0, f"{arch}: ssd_intra_chunk launched")
    require(bool(torch.isfinite(logits).all()), f"{arch}: nonfinite logits")
    require(tuple(logits.shape) == (steps + 1, batch, cfg.vocab),
            f"{arch}: logits shape {tuple(logits.shape)}")
    # the VLM's patches and Whisper's encoder frames are prompt positions
    stub = {"vlm": (cfg.n_patches, "patches"),
            "audio": (cfg.enc_frames, "frames")}.get(cfg.family)
    prompt = batch * (seq_len + (stub[0] if stub else 0))
    extra = f" + {stub[0]} {stub[1]}" if stub else ""
    log(f"[{tag}] {smi}; {arch} ({cfg.family}): {cfg.n_layers} layers, "
        f"d_model {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of "
        f"{cfg.head_dim}, vocab {cfg.vocab}, {n_params / 1e9:.4f} B params "
        f"(bf16), init {t_init:.2f} s; B={batch} prompt {seq_len}{extra}: "
        f"prefill {t_pf * 1e3:.1f} ms = {batch * seq_len / t_pf:.0f} prompt "
        f"tokens/s ({prompt / t_pf:.0f} positions/s); decode {steps} steps "
        f"{t_dec / steps * 1e3:.2f} ms/step = "
        f"{batch * steps / t_dec:.1f} generated tokens/s; peak memory "
        f"{peak / 2**30:.2f} GiB; flash_decode launches {launches} "
        f"(= {_attn_per_step(cfg)} x {steps})")
    log(f"[{tag}] {arch}: first generated tokens of row 0: "
        f"{toks[0, :8].tolist()}")
    out = (launches, logits.cpu(), toks.cpu())
    del params, inputs, logits, toks
    _free_card()
    return out


def phase_serve_zoo(dev, smi):
    """Every zoo architecture beside zamba2 at full width, one at a time,
    the card freed between them, deepseek last.  Returns the flash_decode
    launches of all of them and gemma2-2b's logits and tokens."""
    _free_card()
    launches, first = 0, None
    for arch in ZOO_SERVE:
        n, logits, toks = _serve_zoo_one(arch, dev, smi)
        launches += n
        if first is None:
            first = (arch, logits, toks)
    return launches, first


def phase_serve_zoo_rerun(dev, smi, first):
    """The first zoo model at full width again, from the same seed:
    bit-identical logits and tokens."""
    import torch
    arch, logits, toks = first
    _, logits2, toks2 = _serve_zoo_one(arch, dev, smi, "serve-zoo-rerun")
    require(torch.equal(logits, logits2), f"{arch} rerun: logits differ")
    require(torch.equal(toks, toks2), f"{arch} rerun: tokens differ")
    log(f"[serve-zoo-rerun] {arch}: bit-identical logits "
        f"({tuple(logits.shape)}) and tokens")


def phase_serve_zoo_small(dev):
    """Each family's reduced config (f32) on the card against the CPU
    plain route with the same weights: prefill + 4 decode logits within
    1e-3 (the CPU route is held to the JAX package at 1e-4), equal greedy
    tokens, and one flash_decode launch per attention application."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attn import flash_attn
    from repro_torch.models import convert
    from repro_torch.models.base import get_family
    for arch in ZOO_SERVE:
        cfg = get_config(arch).reduced().replace(param_dtype="float32")
        p_cpu = get_family(cfg.family).init_params(cfg, seed=0, device="cpu")
        p_gpu = convert.params_from_numpy(convert.params_to_numpy(p_cpu), dev)
        b_cpu = _zoo_batch(cfg, 2, 64, 1, "cpu")
        n0 = flash_attn.launches()
        lg_g, tk_g, _, _ = _serve_family(
            p_gpu, cfg, {k: v.to(dev) for k, v in b_cpu.items()}, 68, 4)
        n = flash_attn.launches() - n0
        require(n == _attn_per_step(cfg) * 4,
                f"reduced {arch} on the card: {n} flash_decode launches")
        lg_c, tk_c, _, _ = _serve_family(p_cpu, cfg, b_cpu, 68, 4)
        err = float((lg_g.cpu() - lg_c).abs().max())
        require(torch.allclose(lg_g.cpu(), lg_c, rtol=1e-3, atol=1e-3),
                f"reduced {arch}: card vs CPU logits differ by {err}")
        require(torch.equal(tk_g.cpu(), tk_c), f"reduced {arch}: tokens "
                "differ")
        log(f"[serve-zoo-small] reduced {arch} (f32): card vs CPU plain "
            f"route, prefill + 4 decode logits max |diff| {err:.3e} "
            f"(tolerance 1e-3), greedy tokens equal, {n} flash_decode "
            f"launches")


# ---------------------------------------------------------------------------
# training: the production round (launch/train.py spmd) at full width, every
# zoo family's reduced round card vs CPU, and the engine's executors
# ---------------------------------------------------------------------------

# (arch, spmd flags): zamba2-1.2b at a sequence of 2 SSM chunks, smollm-360m
# at the launcher's defaults; 2 rounds each (only the rounds are cut)
TRAIN_ZOO = {
    "zamba2-1.2b": ["--data-axis", "2", "--n-micro", "2", "--per-micro", "2",
                    "--seq", "256"],
    "smollm-360m": [],
}
TRAIN_ROUNDS = 2
# each arch's peak memory and wall per round when the training forward
# kept every activation (PERF.md section 5), logged beside the
# rematerialized run's
TRAIN_ZOO_NO_REMAT = {"zamba2-1.2b": "51.98 GiB, 1.29-2.13 s per round",
                      "smollm-360m": "17.32 GiB, 2.64-3.80 s per round"}
TRAIN_GRAD_RTOL = 1e-2          # relative L2 per leaf or input
# bf16 whole model: the kernel route's gradient no farther from the f32
# gradient than this many times the plain route's bf16 gradient is
TRAIN_BF16_RATIO = 1.5


# an entry's depth cut, among its spmd flags: ("--depth", K) trains K of
# the config's layers (Whisper's encoder too), widths and dtype kept.  It
# is this script's, not the launcher's: _spmd_args takes it out and
# _spmd_cfg makes the cut config, which the phases hand to the launcher
DEPTH = "--depth"


def _spmd_args(arch, flags):
    from repro_torch.launch import train
    flags, depth = list(flags), 0
    if DEPTH in flags:
        i = flags.index(DEPTH)
        depth = int(flags[i + 1])
        del flags[i:i + 2]
    args = train.build_parser().parse_args(
        ["spmd", "--arch", arch, "--steps", str(TRAIN_ROUNDS), "--sigma",
         "0.02", "--clip", "10"] + flags)
    args.depth = depth
    return args


def _spmd_cfg(args):
    """The config ``args`` trains: the launcher's ``spmd_config``, cut to
    ``args.depth`` layers where the entry asks."""
    from repro_torch.launch import train
    cfg = train.spmd_config(args)
    if args.depth:
        cfg = cfg.replace(n_layers=args.depth,
                          n_enc_layers=min(cfg.n_enc_layers, args.depth))
    return cfg


def _train_spmd_once(arch, flags, smi, profile_round=None, keep_round=None):
    """One ``run_spmd`` with the ``ssd_intra_chunk`` counter set to 0 just
    before it: per round the params move and stay finite, delta_norm > 0,
    the launches since the last round; the wall per round.  Round
    ``profile_round`` (one without a loss eval) runs under the profiler:
    its wall, device kernel time and idle share go to ``state["profile"]``;
    the master after round ``keep_round`` goes to ``state["kept"]`` (CPU).
    Returns the final master on the CPU, the launches and the walls."""
    import torch
    from repro_torch.kernels.flash_attn import flash_attn
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.launch import train
    from repro_torch.pytree import tree_leaves
    args = _spmd_args(arch, flags)
    state = {"prev": None, "launches": [], "walls": [], "norms": []}

    def on_round(i, master, metrics):
        torch.cuda.synchronize()
        now = time.perf_counter()
        if i == profile_round:
            state["prof"].stop()
            dev_s, top = _device_time(state.pop("prof"))
            wall_i = now - state["t"]
            state["profile"] = (wall_i, dev_s, max(0.0, 1 - dev_s / wall_i),
                                top)
        state["walls"].append(now - state["t"])
        state["launches"].append(ssd_scan.launches() - state["n"])
        leaves = tree_leaves(master)
        for leaf in leaves:
            require(bool(torch.isfinite(leaf).all()),
                    f"[train-zoo] {arch} round {i}: nonfinite params")
        if state["prev"] is not None:
            moved = max(float((a - b).abs().max())
                        for a, b in zip(leaves, state["prev"]))
            require(moved > 0, f"[train-zoo] {arch} round {i}: no move")
        dn = float(metrics["delta_norm"])
        require(dn > 0, f"[train-zoo] {arch} round {i}: delta_norm {dn}")
        state["norms"].append(dn)
        if i == keep_round:
            state["kept"] = [l.float().cpu() for l in leaves]
        state["prev"] = [l.clone() for l in leaves]
        state["n"] = ssd_scan.launches()
        if profile_round is not None and i == profile_round - 1:
            # device activity only: the CPU ops of a round's autograd
            # would cost the profile more than the round itself
            state["prof"] = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CUDA])
            state["prof"].start()
        state["t"] = time.perf_counter()

    _free_card()
    torch.cuda.reset_peak_memory_stats()
    ssd_scan.reset_launches()
    flash_attn.reset_launches()
    t0 = time.perf_counter()
    # the first round's wall also holds the init and one loss evaluation
    state["prev"] = None
    state["n"], state["t"] = 0, t0
    master = train.run_spmd(args, on_round=on_round, cfg=_spmd_cfg(args))
    torch.cuda.synchronize()
    total = ssd_scan.launches()
    require(flash_attn.launches() == 0, f"[train-zoo] {arch}: flash_decode "
            "launched in training")
    peak = torch.cuda.max_memory_allocated()
    out = [l.cpu() for l in tree_leaves(master)]
    del master, state["prev"]
    _free_card()
    return out, total, state, peak, time.perf_counter() - t0, args


def _rel_l2(a, b):
    """||a - b|| / ||b|| in f32 (||a|| where b is 0)."""
    import torch
    den = float(torch.linalg.vector_norm(b.float()))
    num = float(torch.linalg.vector_norm(a.float() - b.float()))
    return num / den if den else num


def _ssd_grad_check(args, dev, smi):
    """zamba2's gradient through the CUDA route's autograd.Function
    against the same gradient with the plain ``ssd_intra_chunk_ref`` in
    the kernel's place (per-leaf relative L2):

    1. the SSD block alone at the training shape, bf16: each input's
       gradient within TRAIN_GRAD_RTOL;
    2. the whole model, one microbatch (per_micro x seq tokens), f32 (the
       f32 kernel ``ssd_intra.cu``): every leaf within TRAIN_GRAD_RTOL;
    3. the whole model in bf16: the loss values within TRAIN_GRAD_RTOL,
       and per leaf the kernel route's gradient no farther from the f32
       gradient than TRAIN_BF16_RATIO times the plain route's bf16
       gradient is.  bf16 rounding alone moves this randomly initialised
       38-layer model's gradient by more than half its norm, in the JAX
       package as in the port (``tests/_torch_bf16_sensitivity.py`` on
       the CPU), so two bf16 routes cannot agree to 1e-2 whatever the
       kernel; 1 and 2 hold the kernel's backward and forward at 1e-2."""
    import torch
    from repro_torch.core.fl_step import loss_grad
    from repro_torch.data.tokens import TokenDataConfig, make_batches
    from repro_torch.kernels.ssd_scan import ops, ref, ssd_scan
    from repro_torch.models import mamba2
    from repro_torch.models.base import get_family
    from repro_torch.pytree import tree_leaves, tree_map, tree_paths
    cfg = _spmd_cfg(args)
    fam = get_family(cfg.family)
    n0 = ssd_scan.launches()
    # 1. the block
    shape = (args.per_micro, args.seq // cfg.ssm_chunk, cfg.ssm_chunk,
             mamba2.n_heads_ssm(cfg), cfg.ssm_head_dim, cfg.ssm_state)
    xs = _ssd_inputs(shape, cfg.pdtype, dev)
    dY = torch.randn(shape[:3] + shape[3:5], device=dev).to(cfg.pdtype)
    ts = [t.clone().requires_grad_() for t in xs]
    g_fn = torch.autograd.grad(ops.SSDIntraChunk.apply(*ts), ts, dY)
    us = [t.clone().requires_grad_() for t in xs]
    g_ref = torch.autograd.grad(
        ref.ssd_intra_chunk_ref(*us).to(cfg.pdtype), us, dY)
    block = {n: _rel_l2(a, b) for n, a, b in zip(("x", "a", "B", "C"),
                                                  g_fn, g_ref)}
    for n, r in block.items():
        require(r <= TRAIN_GRAD_RTOL, f"[train-zoo] SSD block d{n}: "
                f"relative L2 {r:.3e} > {TRAIN_GRAD_RTOL}")
    # 2. and 3. the whole model
    batch = next(make_batches(TokenDataConfig(
        vocab=cfg.vocab, seq_len=args.seq, seed=args.seed), 1,
        args.per_micro))
    batch = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    real = mamba2.ssd_ops.ssd_intra_chunk

    def plain(xr, ar, Br, Cr):
        return ref.ssd_intra_chunk_ref(xr, ar, Br, Cr).to(xr.dtype)

    def run(params, c, use_plain):
        def loss(p, b):
            return fam.loss(p, b, c)
        mamba2.ssd_ops.ssd_intra_chunk = plain if use_plain else real
        try:
            with torch.no_grad():
                value = float(loss(params, batch))
            g = [l.float() for l in tree_leaves(loss_grad(loss, params,
                                                          batch))]
        finally:
            mamba2.ssd_ops.ssd_intra_chunk = real
        return value, g

    p16 = fam.init_params(cfg, seed=args.seed, device=dev)
    paths = ["/".join(map(str, p)) for p in tree_paths(p16)]
    p32 = tree_map(lambda l: l.float(), p16)
    c32 = cfg.replace(param_dtype="float32")
    _, k32 = run(p32, c32, False)
    _, r32 = run(p32, c32, True)
    f32 = [_rel_l2(a, b) for a, b in zip(k32, r32)]
    del k32, p32
    v16k, k16 = run(p16, cfg, False)
    v16r, r16 = run(p16, cfg, True)
    n_kernel = ssd_scan.launches() - n0
    bf = [(_rel_l2(a, b), _rel_l2(b, c), _rel_l2(a, c))
          for a, b, c in zip(k16, r16, r32)]
    del k16, r16, r32, p16
    _free_card()
    for path, r in zip(paths, f32):
        require(r <= TRAIN_GRAD_RTOL, f"[train-zoo] f32 grad {path}: "
                f"relative L2 {r:.3e} > {TRAIN_GRAD_RTOL}")
    require(abs(v16k - v16r) <= TRAIN_GRAD_RTOL * abs(v16r),
            f"[train-zoo] bf16 loss {v16k} vs {v16r}")
    for path, (_, plain16, kernel16) in zip(paths, bf):
        require(kernel16 <= TRAIN_BF16_RATIO * plain16,
                f"[train-zoo] bf16 grad {path}: kernel route {kernel16:.3e} "
                f"from the f32 gradient, > {TRAIN_BF16_RATIO} x the plain "
                f"route's {plain16:.3e}")
    # two kernel-route runs, each a no_grad loss and a gradient (its
    # forward and the backward's recompute), and the block's one launch
    require(n_kernel == 6 * cfg.n_layers + 1, f"[train-zoo] grad check: "
            f"{n_kernel} kernel launches, expected 6 x {cfg.n_layers} + 1")
    worst32 = max(zip(f32, paths))
    log(f"[train-zoo] {smi}; zamba2-1.2b gradients through the "
        f"autograd.Function vs through ssd_intra_chunk_ref: SSD block at "
        f"{shape} {cfg.param_dtype}, relative L2 "
        f"{ {n: float(f'{r:.3e}') for n, r in block.items()} }; whole "
        f"model, one microbatch ({args.per_micro} x {args.seq} tokens), "
        f"f32: worst leaf {worst32[0]:.3e} ({worst32[1]}) of "
        f"{len(paths)}, tolerance {TRAIN_GRAD_RTOL}; bf16: loss "
        f"{v16k:.6f} vs {v16r:.6f}")
    log(f"[train-zoo] bf16 whole-model gradients, per-leaf relative L2 "
        f"(kernel vs plain | plain bf16 vs f32 | kernel bf16 vs f32; "
        f"bound: the last <= {TRAIN_BF16_RATIO} x the middle): "
        + "; ".join(
            f"{path} {a:.3f} | {b:.3f} | {c:.3f}"
            for path, (a, b, c) in zip(paths, bf)))


def _ssd_backward_times(args, dev, smi):
    """``ssd_intra_chunk`` at zamba2's training shape (b = per_micro,
    c = seq / chunk): kernel forward, plain forward and the plain
    closed-form backward, device ms each."""
    import torch
    from repro_torch.kernels.ssd_scan import ref, ssd_scan
    from repro_torch.models import mamba2
    cfg = _spmd_cfg(args)
    shape = (args.per_micro, args.seq // cfg.ssm_chunk, cfg.ssm_chunk,
             mamba2.n_heads_ssm(cfg), cfg.ssm_head_dim, cfg.ssm_state)
    xr, ar, Br, Cr = _ssd_inputs(shape, torch.bfloat16, dev)
    dY = torch.randn_like(xr)
    n0 = ssd_scan.launches()
    t = _in_turns({
        "forward": lambda: ssd_scan.ssd_intra_chunk(xr, ar, Br, Cr),
        "plain": lambda: ref.ssd_intra_chunk_ref(xr, ar, Br, Cr),
        "backward": lambda: ref.ssd_intra_chunk_bwd_ref(xr, ar, Br, Cr, dY)})
    ssd_scan.ssd_intra_launches = n0       # timing calls are not the path's
    log(f"[train-zoo] {smi}; ssd_intra_chunk at the training shape {shape} "
        f"bf16: kernel forward {t['forward']:.4f} ms, plain forward "
        f"{t['plain']:.4f} ms, plain backward (ssd_intra_chunk_bwd_ref) "
        f"{t['backward']:.4f} ms = {t['backward'] / t['forward']:.1f} x the "
        f"kernel forward")
    return t


def phase_train_zoo(dev, smi):
    """``launch/train.py spmd`` at full width and depth: zamba2-1.2b (bf16,
    ssd_intra_chunk in every Mamba2 layer's forward) and smollm-360m, 3
    rounds each, then a bit-identical rerun; zamba2's gradient through
    the kernel against the plain route.  Returns the ssd_intra_chunk
    launches of the first runs, the backward times and each first run's
    final master on the CPU and delta norms ([mesh-train]'s W = 1
    references)."""
    import torch
    launches, times, refs = 0, None, {}
    for arch, flags in TRAIN_ZOO.items():
        first, total, st, peak, wall, args = _train_spmd_once(arch, flags,
                                                              smi)
        cfg = _spmd_cfg(args)
        G, nm = args.data_axis, args.n_micro
        # every microbatch's forward and the backward's recompute of it
        per_round = (2 * cfg.n_layers * G * args.n_local * nm
                     if cfg.family == "hybrid" else 0)
        evals = len(range(0, TRAIN_ROUNDS, args.log_every)) + 1
        per_eval = cfg.n_layers if cfg.family == "hybrid" else 0
        want = [per_round] * TRAIN_ROUNDS
        want[0] += per_eval            # round 0 starts with a loss log
        require(st["launches"] == want, f"[train-zoo] {arch}: "
                f"ssd_intra_chunk per round {st['launches']}, expected "
                f"{want} (2 x 38 layers x G x n_local x n_micro: the "
                f"forward and its recompute)")
        require(total == TRAIN_ROUNDS * per_round + evals * per_eval,
                f"[train-zoo] {arch}: {total} launches in all")
        again, _, st2, _, _, _ = _train_spmd_once(arch, flags, smi,
                                                  profile_round=1)
        pw, pd, idle, top = st2["profile"]
        # the same round unprofiled, in the first run (bit-identical work)
        idle_plain = max(0.0, 1 - pd / st["walls"][1])
        for a, b in zip(first, again):
            require(torch.equal(a, b), f"[train-zoo] {arch}: rerun master "
                    "differs")
        require(st["norms"] == st2["norms"], f"[train-zoo] {arch}: rerun "
                "delta norms differ")
        launches += total
        tokens = G * args.n_local * nm * args.per_micro * args.seq
        log(f"[train-zoo] {smi}; {arch}: {cfg.n_layers} layers, d_model "
            f"{cfg.d_model}, {sum(a.numel() for a in first) / 1e9:.4f} B "
            f"params (f32 master, {cfg.param_dtype} clients), G={G} "
            f"n_micro={nm} per_micro={args.per_micro} seq {args.seq}: wall "
            f"per round {[round(w, 3) for w in st['walls']]} s (round 0 "
            f"with init and a loss eval) and rerun "
            f"{[round(w, 3) for w in st2['walls']]} (round 1 profiled: "
            f"{pw * 1e3:.1f} ms wall, {pd * 1e3:.1f} ms of device kernels "
            f"-> device idle share {idle:.3f}, {idle_plain:.3f} against "
            f"the first run's round 1); {tokens} tokens per "
            f"round; peak memory {peak / 2**30:.2f} GiB (rematerialized; "
            f"without it {TRAIN_ZOO_NO_REMAT[arch]}); delta_norm "
            f"{[round(n, 4) for n in st['norms']]}; ssd_intra_chunk "
            f"launches per round {st['launches']} ({total} with the loss "
            f"evals); rerun bit-identical; run wall {wall:.1f} s; the "
            f"profiled round's top device kernels (ms, launches): "
            + "; ".join(f"{name[:70]} {t / 1e3:.1f} ({n})"
                        for name, (t, n) in top[:6]))
        if arch == "zamba2-1.2b":
            _ssd_grad_check(args, dev, smi)
            times = _ssd_backward_times(args, dev, smi)
        refs[arch] = (first, st["norms"])
        del first, again
    return launches, times, refs


# [remat]: smollm-360m at full width and depth, bf16 client, f32 master:
# one client's microbatch of train_4k on the 16 x 16 mesh (256 rows / 16
# clients / 4 microbatches = 4 rows of 4096 tokens), one round
REMAT_ARCH = "smollm-360m"
REMAT_FLAGS = ["--data-axis", "1", "--n-micro", "1", "--per-micro", "4",
               "--seq", "4096", "--steps", "1"]


def phase_remat(smi):
    """[remat]: one ``run_spmd`` round of ``REMAT_ARCH`` at ``REMAT_FLAGS``
    under full rematerialization and one under
    ``set_remat_policy("dots")``: the recompute is the same kernels on the
    same inputs, so the two masters must be bit-identical; the dots
    policy keeps the 2-D products' outputs, so its peak memory is at
    least the full policy's.  Logs both peaks and walls."""
    import torch
    from repro_torch.launch import train
    from repro_torch.models import transformer
    from repro_torch.pytree import tree_leaves
    runs = {}
    for policy in (None, "dots"):
        args = _spmd_args(REMAT_ARCH, REMAT_FLAGS)
        state = {"walls": [], "norms": []}

        def on_round(i, master, metrics):
            torch.cuda.synchronize()
            state["walls"].append(time.perf_counter() - state["t"])
            state["norms"].append(float(metrics["delta_norm"]))

        _free_card()
        torch.cuda.reset_peak_memory_stats()
        transformer.set_remat_policy(policy)
        try:
            t0 = state["t"] = time.perf_counter()
            master = train.run_spmd(args, on_round=on_round,
                                    cfg=_spmd_cfg(args))
            torch.cuda.synchronize()
        finally:
            transformer.set_remat_policy(None)
        runs[policy] = dict(master=[l.cpu() for l in tree_leaves(master)],
                            peak=torch.cuda.max_memory_allocated(),
                            wall=time.perf_counter() - t0, **state)
        del master
        _free_card()
    full, dots = runs[None], runs["dots"]
    for leaf in full["master"]:
        require(bool(torch.isfinite(leaf).all()), "[remat] nonfinite master")
    require(all(torch.equal(a, b) for a, b in
                zip(full["master"], dots["master"]))
            and full["norms"] == dots["norms"],
            "[remat] the dots policy's master differs from the full one's")
    require(dots["peak"] >= full["peak"], f"[remat] dots peak "
            f"{dots['peak']} below the full policy's {full['peak']}")
    cfg = _spmd_cfg(_spmd_args(REMAT_ARCH, REMAT_FLAGS))
    log(f"[remat] {smi}; {REMAT_ARCH} ({cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.param_dtype} client, f32 master), one client, "
        f"one round of 1 microbatch of 4 x 4096 tokens: full remat peak "
        f"{full['peak'] / 2**30:.2f} GiB, round {full['walls'][0]:.3f} s "
        f"(with init and a loss eval; run {full['wall']:.1f} s); dots peak "
        f"{dots['peak'] / 2**30:.2f} GiB, round {dots['walls'][0]:.3f} s "
        f"(run {dots['wall']:.1f} s); masters bit-identical, delta_norm "
        f"{full['norms'][0]:.6g}")


def _small_batch(cfg, b, seq, seed):
    import numpy as np
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, size=(b, seq + 1)).astype(np.int32)
    out = {"tokens": toks[:, :seq], "labels": toks[:, 1:]}
    if cfg.family == "audio":
        out["frames"] = rng.standard_normal(
            (b, cfg.enc_frames, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        out["patches"] = rng.standard_normal(
            (b, cfg.n_patches, cfg.d_model)).astype(np.float32)
    return out


def _small_noise(client, step, leaf, shape):
    import numpy as np
    return np.random.default_rng([client, step, leaf]).standard_normal(
        shape).astype(np.float32)


def phase_train_zoo_small(dev):
    """Each reduced config (f32): one round on the card and on the CPU
    plain route from the same params, batch and injected noise;
    per-microbatch DP, 2 clients x 2 microbatches, SGD at lr 1 on the
    server (so the params hold the aggregated delta: Adam's first step
    would turn ~1e-7 differences into +-lr).  Params and delta_norm within
    1e-4; zamba2 runs ssd_intra.cu (f32) under autograd."""
    import numpy as np
    import torch
    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.core.dp import DPConfig
    from repro_torch.core.fl_step import (
        FLStepConfig, make_fl_train_step, make_server_optimizer)
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.models import convert
    from repro_torch.models.base import get_family
    from repro_torch.pytree import tree_leaves
    G, NM, SEQ = 2, 2, 32
    fl = FLStepConfig(num_clients=G, n_micro=NM, local_lr=0.05,
                      server_lr=1.0, server_opt="sgd",
                      compute_dtype="float32",
                      dp=DPConfig(1.0, 0.5, "per_microbatch"))
    for arch in ARCH_IDS:
        cfg = get_config(arch).reduced().replace(param_dtype="float32")
        fam = get_family(cfg.family)
        step = make_fl_train_step(lambda p, b: fam.loss(p, b, cfg), fl)
        p_cpu = fam.init_params(cfg, seed=0, device="cpu")
        batch = _small_batch(cfg, G * NM, SEQ, 1)
        out = {}
        for where in ("cpu", dev):
            p = convert.params_from_numpy(convert.params_to_numpy(p_cpu),
                                          where)
            b = {k: torch.from_numpy(v).to(where) for k, v in batch.items()}
            n0 = ssd_scan.launches()
            m, _, met = step(p, make_server_optimizer(fl).init(p), b,
                             torch.ones(G, device=where) / G, _small_noise)
            out[str(where)] = ([l.cpu() for l in tree_leaves(m)],
                               float(met["delta_norm"]),
                               ssd_scan.launches() - n0)
        (mc, nc, lc), (mg, ng, lg) = out["cpu"], out[str(dev)]
        d = max(float((a - b).abs().max()) for a, b in zip(mc, mg))
        moved = max(float((a.cpu() - b).abs().max()) for a, b in
                    zip(tree_leaves(p_cpu), mc))
        # the forward and the backward's recompute of each microbatch
        want = 2 * cfg.n_layers * G * NM if cfg.family == "hybrid" else 0
        require(d <= 1e-4, f"[train-zoo-small] {arch}: params differ by {d}")
        require(abs(ng - nc) <= 1e-4 * nc, f"[train-zoo-small] {arch}: "
                f"delta_norm {ng} vs {nc}")
        require(moved > 1e-3 and np.isfinite(ng), f"[train-zoo-small] "
                f"{arch}: the round did not move the params")
        require(lg == want and lc == 0, f"[train-zoo-small] {arch}: "
                f"ssd_intra_chunk launches card {lg} CPU {lc}, want {want}")
        log(f"[train-zoo-small] reduced {arch} (f32): card vs CPU plain "
            f"route, one round: max |dparam| {d:.3e}, delta_norm {ng:.6f} "
            f"vs {nc:.6f} (tolerance 1e-4), ssd_intra_chunk launches {lg}")


AXES_FL = dict(num_clients=1, n_micro=4, local_lr=0.02)


def phase_axes(smi):
    """[main]'s full-width FedAsync (40 updates) with dp_path="jnp" under
    each client-axis executor: "map" bit-identical to "unroll", "vmap"
    within 1e-5 with equal bookkeeping, "fl_step" with a coherent
    ``fl_cfg`` (per-microbatch, sigma 1) with equal bookkeeping; member
    local steps/s of each (no claim)."""
    from repro_torch.core.dp import DPConfig
    from repro_torch.core.fl_step import FLStepConfig
    from repro_torch.core.testbed import run_experiment
    from repro_torch.engine.engine import EngineConfig
    from repro_torch.kernels.dp_clip import dp_clip
    import dataclasses
    cfg = dataclasses.replace(_main_cfg(), dp_path="jnp")
    s_max = _steps(cfg)
    fl = FLStepConfig(dp=DPConfig(cfg.clip_norm, cfg.sigma,
                                  "per_microbatch"), **AXES_FL)
    runs = {}
    # warm-up: the corpus and cuDNN's first calls stay out of the walls
    run_experiment("fedasync", cfg, max_updates=4, eval_every=4,
                   engine_cfg=EngineConfig(staleness_window=120.0,
                                           max_cohort=4))
    dp_clip.reset_launches()
    for axis in ("unroll", "map", "vmap", "fl_step"):
        ecfg = EngineConfig(staleness_window=120.0, max_cohort=4,
                            client_axis=axis,
                            fl_cfg=fl if axis == "fl_step" else None)
        t0 = time.perf_counter()
        p, lg = run_experiment("fedasync", cfg, engine_cfg=ecfg,
                               **MAIN_ASYNC)
        runs[axis] = (p, lg, time.perf_counter() - t0)
        _check_finite(p, f"[axes] {axis}")
    require(dp_clip.sqnorm_launches == 0, "[axes] dp_clip launched on jnp")
    base = runs["unroll"][:2]
    _same_run(base, runs["map"][:2], "[axes] map", stats_drop=())
    keep = ("times", "server_version", "update_counts", "staleness",
            "eps_trajectory", "cohort_sizes", "influence", "fault_events")
    for axis in ("vmap", "fl_step"):
        for f in keep:
            require(getattr(base[1], f) == getattr(runs[axis][1], f),
                    f"[axes] {axis}: RunLog.{f} differs from unroll")
    d_v = _max_diff(base[0], runs["vmap"][0])
    require(d_v <= 1e-5, f"[axes] vmap: params differ by {d_v}")
    d_f = _max_diff(base[0], runs["fl_step"][0])
    require(d_f > 0, "[axes] fl_step: same params as the simulation")
    rates = {a: s_max * sum(r[1].cohort_sizes) / r[2] for a, r in runs.items()}
    log(f"[axes] {smi}; [main]'s fedasync (40 updates, dp_path jnp, "
        f"cohorts {base[1].cohort_sizes}): map bit-identical to unroll "
        f"(RunLog, engine stats, params); vmap max |dparam| {d_v:.3e} "
        f"(tolerance 1e-5), bookkeeping equal; fl_step ({AXES_FL}, "
        f"per-microbatch sigma {cfg.sigma}) bookkeeping equal, params "
        f"{d_f:.3e} from the simulation's; acc "
        f"{ {a: [round(x, 4) for x in r[1].global_acc] for a, r in runs.items()} }")
    log(f"[axes] {smi}; wall (s) {({a: round(r[2], 3) for a, r in runs.items()})}"
        f" = member local steps/s "
        f"{({a: round(v, 2) for a, v in rates.items()})} (each run builds "
        "its testbed; evals included)")


# ---------------------------------------------------------------------------
# [mesh]: the data axis of the mesh, ranks of a torch.distributed group
# ---------------------------------------------------------------------------

MESH_RUN_TOL = 1e-2       # run-level params tolerance (the CPU tests')
# [mesh-main]'s runs on each rank: (tag, sigma, dp_path)
MESH_MAIN_RUNS = (("sigma1", 1.0, "pallas"), ("rerun", 1.0, "pallas"),
                  ("sigma0", 0.0, "pallas"), ("sigma0_jnp", 0.0, "jnp"))
MESH_TIGHT = 1e-5
MESH_TRAIN_RTOL = 1e-5    # relative L2 per leaf of the f32 master
# the host bookkeeping a mesh run must equal [main]'s in
MESH_BOOKKEEPING = ("times", "server_version", "update_counts", "staleness",
                    "eps_trajectory", "cohort_sizes", "influence",
                    "fault_events", "dropouts")


# what the ranks' server process imports once, for every rank forked from
# it (on the card machine's host: torch ~7 s, and torch._dynamo 8-9 s,
# which the rematerialized training forward's first torch.utils.checkpoint
# call imports); none of it touches the card
RANK_PRELOAD = ["numpy", "torch", "torch.distributed", "torch._dynamo",
                "torch.utils.checkpoint"]
# the ranks' CUDA allocator grows expandable segments (two full-width
# zamba2 ranks share one card with this process: fragmentation would cost
# them ~7 GiB each)
RANK_ENV = {"PYTORCH_CUDA_ALLOC_CONF": "expandable_segments:True"}


def start_rank_server():
    """Start (once) the ``forkserver`` process the ranks are forked from:
    it imports ``RANK_PRELOAD`` beside this process's phases, so a rank
    starts with them imported; its environment, which the ranks inherit,
    has ``RANK_ENV``."""
    import multiprocessing
    from multiprocessing import forkserver
    multiprocessing.set_forkserver_preload(RANK_PRELOAD)
    old = {k: os.environ.get(k) for k in RANK_ENV}
    os.environ.update(RANK_ENV)
    try:
        forkserver.ensure_running()
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v


def _mesh_spawn(fn, world, *args, during=None):
    """Start ``world`` ranks of ``fn(rank, port, *args)``, forked from the
    rank server (:func:`start_rank_server`), and wait for them (a rank
    that fails fails the phase); this process first frees its cached
    blocks.  ``during``: work of this process run while the ranks run
    (returned; the ranks are killed if it raises)."""
    import torch.multiprocessing as mp
    from repro_torch.launch.collectives import free_port
    _free_card()
    start_rank_server()
    ctx = mp.start_processes(fn, args=(free_port(),) + args, nprocs=world,
                             start_method="forkserver", join=False)
    try:
        got = during() if during is not None else None
        while not ctx.join():
            pass
    except BaseException:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
        raise
    return got


def _rank_setup(rank, world, port, backend, join=True):
    """A spawned rank: the port on the path, the card bound
    (``cuda:<rank mod cards>``), the group joined unless ``join`` is
    false (the launcher joins it itself)."""
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from repro_torch.launch import collectives as coll
    device = coll.rank_device("cuda", rank, torch.cuda.device_count())
    torch.cuda.set_device(device)
    if join:
        coll.init_group(backend, rank, world, port, device)
    return device


def _mesh_main_rank(rank, port, world, backend, out, model=1):
    """One rank of [mesh-main]: [main]'s FedAsync on a (world, 1) mesh at
    sigma 1, its rerun and a sigma-0 run; one full cohort's partition
    proof.  On a model axis (``model`` > 1: a (world / model, model)
    mesh) the sigma-1 run alone.  Saves what it measured to
    ``out/rank<r>.pt``."""
    device = _rank_setup(rank, world, port, backend)
    import dataclasses

    import torch
    import torch.distributed as dist
    from repro_torch.core.testbed import build_testbed, run_experiment
    from repro_torch.engine import (
        CohortRunner, EngineConfig, assert_cohort_partitioned)
    from repro_torch.engine.mesh_backend import Shard
    from repro_torch.kernels.dp_clip import dp_clip
    from repro_torch.launch import collectives as coll
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.pytree import tree_leaves, tree_map
    try:
        mesh = make_host_mesh(data=world // model, model=model)
        res = {"describe": coll.describe(mesh.group, device),
               "coords": (mesh.rank, mesh.model_rank)}
        ecfg = EngineConfig(staleness_window=120.0, max_cohort=4, mesh=mesh)
        for tag, sigma, path in MESH_MAIN_RUNS[:1 if model > 1 else None]:
            cfg = dataclasses.replace(_main_cfg(), sigma=sigma, dp_path=path)
            dp_clip.reset_launches()
            coll.reset_stats()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            p, lg = run_experiment("fedasync", cfg, engine_cfg=ecfg,
                                   **MAIN_ASYNC)
            torch.cuda.synchronize()
            res[tag] = {
                "wall": time.perf_counter() - t0,
                "params": [l.cpu() for l in tree_leaves(p)],
                "log": {f: getattr(lg, f) for f in RUNLOG_FIELDS},
                "cohorts": lg.engine_stats["cohorts"],
                "launches": (dp_clip.sqnorm_launches,
                             dp_clip.scale_mean_launches),
                "info": lg.engine_stats["pallas_interpret"],
                "engine_stats": lg.engine_stats,
                "collectives": coll.stats(),
                "peak": torch.cuda.max_memory_allocated()}
        clients, params, _, _ = build_testbed(_main_cfg())
        runner = CohortRunner(clients, ecfg, device)
        plans = [runner.dispatch(c, params, 1000 + c.cid, 0)
                 for c in clients[:4]]
        runner.run_cohort(plans)
        res["partition"] = assert_cohort_partitioned(runner.last_partition,
                                                     mesh)
        # the cohort's rows of this rank as shapes only, for [analysis]
        res["cohort_rows"] = (len(plans), tree_map(lambda s: Shard(
            torch.empty(s.local.shape, device="meta"), s.shape, s.offset),
            runner.last_partition))
        torch.save(res, out / f"rank{rank}.pt",
                   _use_new_zipfile_serialization=False)
    finally:
        dist.destroy_process_group()


def _mesh_one(cfg, mesh):
    """One FedAsync run of [main]'s configuration in this process (on
    ``mesh`` when given): (params, RunLog, wall, dp_clip launches)."""
    import torch
    from repro_torch.core.testbed import run_experiment
    from repro_torch.engine.engine import EngineConfig
    from repro_torch.kernels.dp_clip import dp_clip
    dp_clip.reset_launches()
    t0 = time.perf_counter()
    p, lg = run_experiment("fedasync", cfg, engine_cfg=EngineConfig(
        staleness_window=120.0, max_cohort=4, mesh=mesh), **MAIN_ASYNC)
    torch.cuda.synchronize()
    return p, lg, time.perf_counter() - t0, (dp_clip.sqnorm_launches,
                                              dp_clip.scale_mean_launches)


def _mesh_log_equal(want, got, what):
    for f in MESH_BOOKKEEPING:
        require(getattr(want, f) == got[f], f"{what}: RunLog.{f} differs: "
                f"{getattr(want, f)} vs {got[f]}")


def _mesh_main_check(ranks, world, backend, s_max, log_main, l0, lj):
    """[mesh-main]'s requirements on the saved results of ``world``
    ranks: the backend, bookkeeping equal to the one-process runs',
    ``dp_clip`` at S_max x cohorts per rank and kernel, a bit-identical
    rerun, every rank's params bit-identical, and a K = 4 cohort split
    4 / W members per rank."""
    import torch
    for r, res in enumerate(ranks):
        what = f"[mesh-main] W={world} {backend} rank {r}"
        require(f"backend {backend}" in res["describe"]
                and ("host memory" in res["describe"]) == (backend == "gloo"),
                f"{what}: {res['describe']}")
        for tag in ("sigma1", "rerun"):
            _mesh_log_equal(log_main, res[tag]["log"], f"{what} {tag}")
        _mesh_log_equal(l0, res["sigma0"]["log"], f"{what} sigma0")
        _mesh_log_equal(lj, res["sigma0_jnp"]["log"], f"{what} sigma0 jnp")
        for tag, _, path in MESH_MAIN_RUNS:
            got = res[tag]
            want = s_max * got["cohorts"] if path == "pallas" else 0
            require(got["launches"] == (want, want), f"{what} {tag}: "
                    f"dp_clip launches {got['launches']}, expected S_max x "
                    f"cohorts = {want} each")
            require(path == "jnp" or got["info"]["kernel"] == "triton",
                    f"{what}: {got['info']}")
        for a, b in zip(res["sigma1"]["params"], res["rerun"]["params"]):
            require(torch.equal(a, b), f"{what}: rerun not bit-identical")
        for a, b in zip(ranks[0]["sigma1"]["params"], res["sigma1"]["params"]):
            require(torch.equal(a, b), f"{what}: differs from rank 0")
        rep = res["partition"]
        require(len(rep) == 12 and set(rep.values()) == {4 // world},
                f"{what}: partition report {rep}")


def _mesh_main_model_axis(smi, twins):
    """[mesh-main]'s (data 2, model 2) run: 4 gloo ranks on cuda:0, [main]'s
    FedAsync at sigma 1, the members of each data coordinate replicated
    over its model group.  Each rank against its data-axis twin in the
    (2, 1) run (``twins``, rank r's twin r // 2): RunLog and params
    bit-identical, ``dp_clip`` launched as often; the model ranks of a
    data coordinate bit-identical to each other; a cohort of 4 split 2
    per data coordinate.  Returns the ranks' dp_clip launches."""
    import torch
    out = ROOT / "build" / "mesh_main_model2"
    out.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    _mesh_spawn(_mesh_main_rank, 4, 4, "gloo", out, 2)
    wall = time.perf_counter() - t0
    ranks = [torch.load(out / f"rank{r}.pt", weights_only=False)
             for r in range(4)]
    MESH_MAIN_RANKS["(data 2, model 2) gloo"] = ranks
    launches = [0, 0]
    for r, res in enumerate(ranks):
        what = f"[mesh-main] (data 2, model 2) rank {r}"
        got, twin = res["sigma1"], twins[r // 2]["sigma1"]
        require(res["coords"] == (r // 2, r % 2), f"{what}: coordinates "
                f"{res['coords']}")
        require(got["launches"] == twin["launches"], f"{what}: dp_clip "
                f"launches {got['launches']}, its data-axis twin "
                f"{twin['launches']}")
        require(got["log"] == twin["log"], f"{what}: RunLog differs from "
                "the (2, 1) run's")
        require(got["cohorts"] == twin["cohorts"], f"{what}: cohorts")
        for a, b in zip(got["params"], twin["params"]):
            require(torch.equal(a, b), f"{what}: params differ from the "
                    "(2, 1) run's")
        for a, b in zip(got["params"], ranks[r ^ 1]["sigma1"]["params"]):
            require(torch.equal(a, b), f"{what}: differs from its model "
                    "group's other rank")
        require(set(res["partition"].values()) == {2},
                f"{what}: partition report {res['partition']}")
        launches = [launches[0] + got["launches"][0],
                    launches[1] + got["launches"][1]]
        log(f"[mesh-main] (data 2, model 2) rank {r}: {res['describe']}; "
            f"sigma-1 run {got['wall']:.3f} s (its (2, 1) twin "
            f"{twin['wall']:.3f} s), peak {got['peak'] / 2**30:.2f} GiB, "
            f"dp_clip launches {got['launches']}, collectives "
            f"{got['collectives']}")
    log(f"[mesh-main] {smi}; (data 2, model 2), 4 gloo ranks on one card: "
        f"each rank's RunLog, params and dp_clip launches bit-identical to "
        f"its data-axis twin's in the (2, 1) run, the model ranks of each "
        f"data coordinate bit-identical, a cohort of 4 split 2 per data "
        f"coordinate; spawn to exit {wall:.1f} s")
    for f in out.iterdir():
        f.unlink()
    return launches


def phase_mesh_main(smi, main_runs):
    """[mesh-main]: [main]'s FedAsync (the paper's SERConfig, D = 317,124,
    5 clients on T1..T5, B = 128, sigma 1, dp_path="pallas", window 120,
    max_cohort 4, 40 updates) on a mesh over the ranks of a process group:

    * W = 1 over NCCL, in this process: bookkeeping, engine stats' cohort
      count and params bit-identical to [main];
    * W = 2 over gloo, both ranks on cuda:0 (NCCL refuses two ranks on one
      card): on each rank the bookkeeping equal to [main]'s, the params
      within the run tolerance of [main]'s (sigma 1); at sigma 0 with
      clipping on, within 1e-5 of the one-process run on the member-major
      executor (``dp_path="jnp"``, each member's grads its own program)
      and within the run tolerance on the step-major one (per-example
      grads batched over K / 2 members round differently from K, and at
      sigma 0 Adam's first step turns that rounding into +-lr); a
      bit-identical rerun, both ranks' params bit-identical, ``dp_clip``
      launched S_max x cohorts times per kernel on each rank, a full
      cohort of 4 partitioned 2 per rank (``assert_cohort_partitioned``);
    * W = 2 and W = 4 over NCCL, one rank per card, where the machine has
      that many cards: the same requirements (at W = 4 a cohort of 4 holds
      one member per rank);
    * a (data 2, model 2) mesh of 4 gloo ranks on cuda:0
      (:func:`_mesh_main_model_axis`): every rank bit-identical to its
      data-axis twin in the W = 2 gloo run, dp_clip launches included.

    Member local steps/s at W = 1, W = 2 and in [main] (walls of whole
    runs, corpus and evals included), each rank's backend and
    collectives.  Returns the dp_clip launches (W = 1 and each gloo
    rank's sigma-1 run)."""
    import dataclasses

    import torch
    import torch.distributed as dist
    from repro_torch.launch import collectives as coll
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.pytree import tree_leaves
    cfg = _main_cfg()
    s_max = _steps(cfg)
    p_main, log_main, t_main = main_runs["fedasync"]
    rate = {"main": s_max * sum(log_main.cohort_sizes) / t_main}

    # W = 1 over NCCL (a real communicator of one rank)
    coll.init_group("nccl", 0, 1, coll.free_port(), torch.device("cuda", 0))
    try:
        coll.reset_stats()
        mesh = make_host_mesh(data=1)
        p1, l1, t1, n1 = _mesh_one(cfg, mesh)
        desc1, st1 = coll.describe(mesh.group, "cuda:0"), coll.stats()
    finally:
        dist.destroy_process_group()
    _same_run((p_main, log_main), (p1, l1), "[mesh-main] W=1 nccl")
    require(l1.engine_stats["cohorts"] == log_main.engine_stats["cohorts"],
            "[mesh-main] W=1: cohort count differs")
    want = s_max * l1.engine_stats["cohorts"]
    require(n1 == (want, want), f"[mesh-main] W=1: dp_clip launches {n1}, "
            f"expected S_max x cohorts = {want} each")
    require(st1.get("all_gather", {}).get("calls", 0) > 0,
            "[mesh-main] W=1: no collective ran")
    launches = [n1[0], n1[1]]
    rate["W1_nccl"] = s_max * sum(l1.cohort_sizes) / t1
    log(f"[mesh-main] {smi}; W=1 ({desc1}): bit-identical to [main] "
        f"(RunLog, params), dp_clip launches {n1} = S_max {s_max} x "
        f"{l1.engine_stats['cohorts']} cohorts each; collectives {st1}")

    # the one-process sigma-0 runs (clipping on) the mesh's are held to:
    # the step-major executor, and the member-major one on dp_path jnp
    p0, l0, _, _ = _mesh_one(dataclasses.replace(cfg, sigma=0.0), None)
    pj, lj, _, _ = _mesh_one(dataclasses.replace(cfg, sigma=0.0,
                                                 dp_path="jnp"), None)
    want_leaves = {"sigma1": [l.cpu() for l in tree_leaves(p_main)],
                   "sigma0": [l.cpu() for l in tree_leaves(p0)],
                   "sigma0_jnp": [l.cpu() for l in tree_leaves(pj)]}
    cards = torch.cuda.device_count()
    for world, backend in ((2, "gloo"), (2, "nccl"), (4, "nccl")):
        if backend == "nccl" and cards < world:
            log(f"[mesh-main] W={world} over NCCL with one rank per card: "
                f"not run, this machine has {cards} card(s)")
            continue
        out = ROOT / "build" / f"mesh_main_{backend}{world}"
        out.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        _mesh_spawn(_mesh_main_rank, world, world, backend, out)
        spawn_wall = time.perf_counter() - t0
        ranks = [torch.load(out / f"rank{r}.pt", weights_only=False)
                 for r in range(world)]
        _mesh_main_check(ranks, world, backend, s_max, log_main, l0, lj)
        MESH_MAIN_RANKS[f"W={world} {backend}"] = ranks
        d = {tag: max(float((a - b).abs().max())
                      for a, b in zip(ranks[0][tag]["params"], want))
             for tag, want in want_leaves.items()}
        per_leaf0 = [float((a - b).abs().max()) for a, b in
                     zip(ranks[0]["sigma0"]["params"], want_leaves["sigma0"])]
        log(f"[mesh-main] {smi}; W={world} {backend}"
            f"{' on one card' if backend == 'gloo' else ', a card per rank'}"
            f", max |dparam| from the one-process run: sigma 1 "
            f"{d['sigma1']:.3e} (tolerance {MESH_RUN_TOL}); sigma 0 with "
            f"clipping, member-major executor (dp_path jnp) "
            f"{d['sigma0_jnp']:.3e} (tolerance {MESH_TIGHT}); sigma 0 with "
            f"clipping, the step-major executor (dp_path pallas) "
            f"{d['sigma0']:.3e} (tolerance {MESH_RUN_TOL}: its per-example "
            f"grads batch K/{world} members per rank against K in one "
            f"process, and at sigma 0 Adam's first step turns their "
            f"rounding into +-lr; per leaf "
            f"{[f'{x:.2e}' for x in per_leaf0]}); rerun bit-identical; ranks "
            f"bit-identical; partition {ranks[0]['partition']}")
        require(d["sigma1"] <= MESH_RUN_TOL, f"[mesh-main] W={world} "
                f"{backend} sigma 1: {d['sigma1']}")
        require(d["sigma0_jnp"] <= MESH_TIGHT, f"[mesh-main] W={world} "
                f"{backend} sigma 0 jnp: {d['sigma0_jnp']}")
        require(d["sigma0"] <= MESH_RUN_TOL, f"[mesh-main] W={world} "
                f"{backend} sigma 0: {d['sigma0']}")
        for r, res in enumerate(ranks):
            got = res["sigma1"]
            steps = s_max * sum(got["log"]["cohort_sizes"])
            tag = f"W{world}_{backend}_rank{r}"
            rate[tag] = steps / got["wall"]
            rate[tag + "_rerun"] = steps / res["rerun"]["wall"]
            if backend == "gloo":
                launches[0] += got["launches"][0]
                launches[1] += got["launches"][1]
            log(f"[mesh-main] W={world} rank {r}: {res['describe']}; "
                f"sigma-1 run {got['wall']:.3f} s, rerun "
                f"{res['rerun']['wall']:.3f} s, peak "
                f"{got['peak'] / 2**30:.2f} GiB, collectives "
                f"{got['collectives']}")
        log(f"[mesh-main] W={world} {backend}: the ranks took "
            f"{spawn_wall:.1f} s from spawn to exit")
        if (world, backend) == (2, "gloo"):
            launches = [a + b for a, b in zip(launches, _mesh_main_model_axis(
                smi, ranks))]
    log(f"[mesh-main] {smi}; member local steps/s (whole runs, corpus and "
        f"evals included; [main] and each rank's first run cold, W=1 and "
        f"the ranks' reruns warm): "
        f"{ {k: round(v, 2) for k, v in rate.items()} }")
    return {"dp_clip_sqnorm": launches[0], "dp_clip_scale_mean": launches[1]}


def _fingerprint(tree):
    """Per leaf, the sum of its f32 words' bit patterns as int64 (on the
    card): equal fingerprints for bit-identical trees, and a flipped bit
    changes one."""
    import torch
    from repro_torch.pytree import tree_leaves
    return [int(l.detach().view(torch.int32).sum(dtype=torch.int64))
            for l in tree_leaves(tree)]


def _mesh_train_rank(rank, port, world, backend, arch, flags, out,
                     rerun_port=None):
    """One rank of [mesh-train]: ``run_spmd`` on a (world, 1) mesh through
    ``launch.train.spmd_rank``; saves per-round ssd_intra_chunk launches,
    walls, delta norms and fingerprints of this rank's master shards,
    peak memory and collectives, and (rank 0) the whole final master.
    With ``rerun_port`` the same process then reruns round 0 through a
    second ``spmd_rank`` (a new group at that port) and saves its
    fingerprints and delta norm."""
    _rank_setup(rank, world, port, backend, join=False)
    import torch
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.launch import collectives as coll
    from repro_torch.launch import train
    from repro_torch.pytree import tree_leaves

    def run(steps, at_port):
        args = _spmd_args(arch, flags + ["--devices", str(world)])
        args.steps = steps
        st = {"launches": [], "walls": [], "norms": [], "prints": [],
              "n": 0, "t": time.perf_counter()}

        def on_round(i, master, metrics):
            torch.cuda.synchronize()
            now = time.perf_counter()
            st["walls"].append(now - st["t"])
            st["launches"].append(ssd_scan.launches() - st["n"])
            st["norms"].append(float(metrics["delta_norm"]))
            st["prints"].append(_fingerprint(master))
            st["n"], st["t"] = ssd_scan.launches(), time.perf_counter()

        torch.cuda.reset_peak_memory_stats()
        ssd_scan.reset_launches()
        coll.reset_stats()
        t0 = time.perf_counter()
        whole = train.spmd_rank(args, rank, at_port, backend=backend,
                                on_round=on_round, cfg=_spmd_cfg(args))
        torch.cuda.synchronize()
        res = dict(launches=st["launches"], walls=st["walls"],
                   norms=st["norms"], prints=st["prints"],
                   total=ssd_scan.launches(),
                   wall=time.perf_counter() - t0,
                   peak=torch.cuda.max_memory_allocated(),
                   collectives=coll.stats())
        if rank == 0:
            res["master"] = [l.cpu() for l in tree_leaves(whole)]
        return res

    res = run(TRAIN_ROUNDS, port)
    if rerun_port is not None:
        again = run(1, rerun_port)
        res["rerun"] = {k: again[k] for k in ("norms", "prints", "walls",
                                              "wall")}
    torch.save(res, out / f"rank{rank}.pt",
               _use_new_zipfile_serialization=False)


def _mesh_train_ranks(arch, flags, world, backend, rerun):
    import torch
    from repro_torch.launch.collectives import free_port
    out = ROOT / "build" / "mesh_train"
    out.mkdir(parents=True, exist_ok=True)
    _free_card()
    log(f"[mesh-train] {arch}: this process holds "
        f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB of the card "
        f"(allocator) before the ranks start")
    rerun_port = free_port() if rerun else None
    t0 = time.perf_counter()
    _mesh_spawn(_mesh_train_rank, world, world, backend, arch, flags, out,
                rerun_port)
    ranks = [torch.load(out / f"rank{r}.pt", weights_only=False)
             for r in range(world)]
    for p in out.iterdir():
        p.unlink()
    return ranks, time.perf_counter() - t0


# (arch, spmd flags, ranks, backend, rerun): zamba2-1.2b at [train-zoo]'s
# flags and smollm-360m at G = 2 on two gloo ranks sharing the card; on a
# machine with more cards, zamba2 over NCCL at W = 2 and smollm at
# [train-zoo]'s flags (G = 4) over NCCL at W = 4
MESH_TRAIN = (
    ("zamba2-1.2b", TRAIN_ZOO["zamba2-1.2b"], 2, "gloo", True),
    ("smollm-360m", ["--data-axis", "2"], 2, "gloo", False),
    ("zamba2-1.2b", TRAIN_ZOO["zamba2-1.2b"], 2, "nccl", False),
    ("smollm-360m", TRAIN_ZOO["smollm-360m"], 4, "nccl", False),
)


def phase_mesh_train(smi, refs):
    """[mesh-train]: ``launch/train.py spmd --devices W --data-axis W`` at
    full width and depth, 2 rounds, the f32
    master and FedAdam's state sharded over the ranks (``MESH_TRAIN``).
    Requires ssd_intra_chunk launched on each rank 2 x n_layers x n_micro
    per round and client (the forward and its recompute) plus n_layers per
    loss eval on rank 0, the ranks'
    delta norms equal, the master and delta norms within 1e-5 (relative)
    of the W = 1 run from the same seed at W = 2 (``refs[arch]``:
    [train-zoo]'s first zamba2 run for the full-depth NCCL entry; the
    others run here) and within the run tolerance at W = 4 (a 4-term
    reduce-scatter sums in another order, which FedAdam's first step can
    turn into +-lr), and round 0 rerun bit-identical in the same rank
    processes (zamba2 on gloo: fingerprints of every shard).  Logs
    each rank's peak memory, walls, collectives and their host time.
    Returns the ssd_intra_chunk launches of the gloo runs' ranks."""
    import torch
    launches = 0
    cards = torch.cuda.device_count()
    for arch, flags, world, backend, rerun in MESH_TRAIN:
        if backend == "nccl" and cards < world:
            log(f"[mesh-train] {arch} --devices {world} over NCCL with one "
                f"rank per card: not run, this machine has {cards} card(s)")
            continue
        if arch in refs and flags == TRAIN_ZOO[arch]:
            ref, ref_norms = refs[arch]
        else:
            ref, _, st, _, _, _ = _train_spmd_once(arch, flags, smi)
            ref_norms = st["norms"]
        args = _spmd_args(arch, flags)
        cfg = _spmd_cfg(args)
        require(args.data_axis == world, f"[mesh-train] {arch}: G != W")
        ranks, wall = _mesh_train_ranks(arch, flags, world, backend, rerun)
        hybrid = cfg.family == "hybrid"
        per_round = (2 * cfg.n_layers * (args.data_axis // world)
                     * args.n_local * args.n_micro if hybrid else 0)
        evals = len(range(0, TRAIN_ROUNDS, args.log_every)) + 1
        for r, res in enumerate(ranks):
            want = [per_round] * TRAIN_ROUNDS
            if r == 0 and hybrid:
                want[0] += cfg.n_layers          # round 0's loss log
            require(res["launches"] == want, f"[mesh-train] {arch} rank "
                    f"{r}: ssd_intra_chunk per round {res['launches']}, "
                    f"expected {want}")
            total = TRAIN_ROUNDS * per_round + (
                evals * cfg.n_layers if r == 0 and hybrid else 0)
            require(res["total"] == total, f"[mesh-train] {arch} rank {r}: "
                    f"{res['total']} launches in all, expected {total}")
            require(res["norms"] == ranks[0]["norms"], f"[mesh-train] "
                    f"{arch}: the ranks' delta norms differ")
            if backend == "gloo":
                launches += res["total"]
        got = ranks[0]["master"]
        rel = max(_rel_l2(a, b) for a, b in zip(got, ref))
        rel_n = max(abs(a - b) / abs(b) for a, b in
                    zip(ranks[0]["norms"], ref_norms))
        tol = MESH_TRAIN_RTOL if world == 2 else MESH_RUN_TOL
        require(len(got) == len(ref) and rel <= tol,
                f"[mesh-train] {arch} W={world}: master {rel:.3e} from W=1")
        require(rel_n <= tol, f"[mesh-train] {arch} W={world}: delta_norm "
                f"{rel_n:.3e} from W=1")
        bitwise = all(torch.equal(a, b) for a, b in zip(got, ref))
        note = ""
        if rerun:
            # round 0 again in each rank's process: the same bits on every
            # shard (fingerprints) and the same delta norm
            for r, res in enumerate(ranks):
                again = res["rerun"]
                require(again["prints"][0] == res["prints"][0]
                        and again["norms"][0] == res["norms"][0],
                        f"[mesh-train] {arch} rank {r}: round 0 rerun "
                        "differs")
            note = (f"; round 0 rerun in the same processes bit-identical "
                    f"on every rank's shards ({ranks[0]['rerun']['wall']:.1f}"
                    f" s)")
        where = "on one card" if backend == "gloo" else "a card per rank"
        log(f"[mesh-train] {smi}; {arch} --devices {world} --data-axis "
            f"{world} (G={args.data_axis}, n_micro={args.n_micro}, "
            f"per_micro={args.per_micro}, seq {args.seq}, "
            f"{cfg.param_dtype} clients, f32 master sharded over {world} "
            f"{backend} ranks {where}): master max relative L2 {rel:.3e} "
            f"and delta_norm {rel_n:.3e} from W=1 (tolerance {tol}; "
            f"{'bit-identical' if bitwise else 'not bitwise'}); "
            f"ssd_intra_chunk per round {[r['launches'] for r in ranks]}; "
            f"spawn to exit {wall:.1f} s{note}")
        for r, res in enumerate(ranks):
            coll_s = sum(v["seconds"] for v in res["collectives"].values())
            log(f"[mesh-train] {arch} W={world} rank {r}: walls per round "
                f"{[round(w, 3) for w in res['walls']]} s (round 0 with "
                f"init and a loss eval), run {res['wall']:.1f} s of which "
                f"{coll_s:.1f} s in collectives (host clock), peak memory "
                f"{res['peak'] / 2**30:.2f} GiB, collectives "
                f"{res['collectives']}")
        del ranks, got, ref
        _free_card()
    return launches


# [mesh-model]: (arch, spmd flags, --devices, --data-axis, rerun): the
# model axis of 2, zamba2-1.2b at [train-zoo]'s flags with one client
# (G = 1, both ranks one model group), smollm-360m at the launcher's
# defaults on a 2 x 2 mesh; then one round of xlstm-350m (full depth) and
# olmoe-1b-7b (its router and experts; 2 of its 16 layers, where two ranks
# and the W = 1 round fit the card's 80 GB) at the launcher's defaults
# with one client; all at full width in the config's dtype, all ranks gloo
# on the one card.  With whisper-large-v3 and phi-3-vision-4.2b too the
# script took 1,066-1,151 s of its 1,200; those two (``MESH_MODEL_MORE``:
# 8 of 32 layers in each stack, where 24 took 143.6 s and 31.3 GiB per
# rank and 32 would not fit) run in scripts/torch_model_axis_control.py
MESH_MODEL = (
    ("zamba2-1.2b", TRAIN_ZOO["zamba2-1.2b"], 2, 1, True),
    ("smollm-360m", [], 4, 2, False),
    ("xlstm-350m", ["--steps", "1"], 2, 1, False),
    ("olmoe-1b-7b", ["--steps", "1", DEPTH, "2"], 2, 1, False),
)
MESH_MODEL_MORE = (
    ("whisper-large-v3", ["--steps", "1", DEPTH, "8"], 2, 1, False),
    ("phi-3-vision-4.2b", ["--steps", "1", DEPTH, "8"], 2, 1, False),
)
MESH_MODEL_ROUNDS = 2         # unless the entry's flags say --steps
# entries whose W = 1 runs go on in this process while their gloo ranks
# run (W = 1's peak and the ranks' fit the card together: 16 + 4 x 5.6
# and 20 + 2 x 10 GiB); their W = 1 walls are read beside the ranks
MESH_MODEL_BESIDE = ("smollm-360m", "xlstm-350m")
MESH_MODEL_SMALL = dict(G=2, n_micro=2, seq=32)
# the bounds at full width, set between the sound readings and a control
# whose tp_copy backward drops its all-reduce
# (scripts/torch_model_axis_control.py; PERF.md section 6).  One
# microbatch's f32 gradient at the seeded params on the model axis
# against W = 1's, relative L2, largest over the leaves: sound 2.3e-4
# (zamba2-1.2b) and 3.5e-6 (smollm-360m), the control 0.97-1.01.  The
# bf16 runs' update (final master minus the initial params) against
# W = 1's, relative L2 over the leaves: median sound 7.1e-3 and 5.9e-3,
# the control 2.1e-2 and 4.1e-2; the largest (sound 4.7e-2, the control
# 6.2e-2 and 8.0e-2) is only capped, since the noise, the same on both
# sides, swamps most of a bf16 update
MESH_MODEL_GRAD_RTOL = 1e-3
MESH_MODEL_UPDATE_MEDIAN = 1.2e-2
MESH_MODEL_UPDATE_MAX = 1e-1
# xlstm-350m's f32 gradient at full depth is chaotic in W = 1 itself: on
# the CPU a change of thread count (the sums' order) moves it by 0.13
# median, 0.30 max per leaf (24 layers, seq 128; the mLSTM stack, since 3
# sLSTM layers alone move 2e-6), and 1.6e-3 at 8 layers, 2.3e-5 at 4 with
# an sLSTM every 2.  Its gradient check runs that full-width 4-layer
# model (these flags on top of the entry's; the run stays full depth).
# The same chaos moves its bf16 update's largest per-leaf distance (the
# gate biases b_i, 84 entries) to 0.22 at W = 1 vs the model axis against
# the control's 0.31: the cap for it is 0.5, the median's limit is the
# others' (sound 2.8e-3, control 3.6e-2; PERF.md section 6)
MESH_MODEL_GRAD_FLAGS = {
    "xlstm-350m": [DEPTH, "4", "--reduce", "slstm_every=2"],
}
# the entry whose ranks, after its rounds, run one round under
# ``attn_shard="heads_padded"`` from the same initial master (smollm-360m's
# 15/5 heads padded to 8/3 slots on its model axis of 2, rank 1's query
# heads reading kv head 2 of rank 0), held with ``_full_width_bounds`` to
# the entry's W = 1 run after the same round, its padded master slots
# exactly zero
MESH_MODEL_PADDED = "smollm-360m"


def _padded_max(blocks, shardings, model_rank):
    """The largest |value| on a rank's padded slots of its master blocks
    (``shardings``: the master's, each with its whole shape)."""
    from repro_torch.launch.shardings import model_dim, real_range
    from repro_torch.pytree import tree_leaves
    worst = 0.0
    for leaf, s in zip(tree_leaves(blocks), tree_leaves(shardings)):
        d = model_dim(s)
        if d is None:
            continue
        lo, hi = real_range(s.shape[d], s.mesh.shape["model"], model_rank)
        pad = leaf.narrow(d, hi - lo, leaf.shape[d] - (hi - lo))
        if pad.numel():
            worst = max(worst, float(pad.abs().max()))
    return worst
MESH_MODEL_UPDATE_MAX_OF = {"xlstm-350m": 0.5}
SSD_BF16_RTOL = 5e-2          # [kernels-zoo]'s bf16 tolerance


def _mesh_model_flags(flags, world, data):
    return ["--steps", str(MESH_MODEL_ROUNDS)] + flags + ["--devices",
                    str(world), "--data-axis", str(data)]


def _small_tp_round(arch, dev, mesh=None):
    """One f32 round of the reduced ``arch`` on the card ([train-zoo-small]'s
    round: 2 clients x 2 microbatches, the injected noise, SGD at lr 1),
    on ``mesh`` (None: this process alone).  Returns the whole new master
    on the CPU, delta_norm and the ssd_intra_chunk launches."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.dp import DPConfig
    from repro_torch.core.fl_step import (
        FLStepConfig, gather_master, make_fl_train_step,
        make_server_optimizer, shard_master)
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.launch.shardings import tree_shardings
    from repro_torch.models import layers
    from repro_torch.models.base import get_family
    from repro_torch.pytree import tree_leaves, tree_map
    k = MESH_MODEL_SMALL
    cfg = get_config(arch).reduced().replace(param_dtype="float32")
    fam = get_family(cfg.family)
    fl = FLStepConfig(num_clients=k["G"], n_micro=k["n_micro"],
                      local_lr=0.05, server_lr=1.0, server_opt="sgd",
                      compute_dtype="float32",
                      dp=DPConfig(1.0, 0.5, "per_microbatch"))
    params = fam.init_params(cfg, seed=0, device=dev)
    client_sh = master_sh = None
    if mesh is not None:
        stacked = tree_map(lambda l: torch.empty(
            (k["G"],) + tuple(l.shape), device="meta"), params)
        client_sh = tree_shardings(stacked, cfg, mesh, role="client")
        master_sh = tree_shardings(params, cfg, mesh, role="master")
        layers.set_mesh_context(mesh, cfg=cfg)
    try:
        local = shard_master(params, master_sh)
        step = make_fl_train_step(lambda p, b: fam.loss(p, b, cfg), fl,
                                  client_shardings=client_sh,
                                  master_shardings=master_sh)
        batch = {key: torch.from_numpy(v).to(dev) for key, v in
                 _small_batch(cfg, k["G"] * k["n_micro"], k["seq"],
                              1).items()}
        n0 = ssd_scan.launches()
        new, _, met = step(local, make_server_optimizer(fl).init(local),
                           batch, torch.ones(k["G"], device=dev) / k["G"],
                           _small_noise)
        launched = ssd_scan.launches() - n0
        whole = gather_master(new, master_sh)
    finally:
        layers.clear_mesh_context()
    return ([l.cpu() for l in tree_leaves(whole)], float(met["delta_norm"]),
            launched)


def _full_grad(arch, flags, world, data, device, mesh=None):
    """The gradient of one microbatch's loss (the run's first batch's first
    per_micro rows; no clip, no noise) at the seeded full-width params in
    f32, per leaf whole on the CPU; on ``mesh`` through its model axis,
    each rank on its model blocks of the params (the master's placement),
    the gradient's blocks gathered over the model group (rank 0 returns
    them, the others None)."""
    import torch
    from repro_torch.core.fl_step import loss_grad, master_model_dims
    from repro_torch.data.tokens import TokenDataConfig, make_batches
    from repro_torch.launch import collectives as coll
    from repro_torch.launch import train
    from repro_torch.launch.shardings import (NamedSharding, block,
                                             tree_shardings)
    from repro_torch.models import layers
    from repro_torch.models.base import get_family
    from repro_torch.pytree import tree_leaves, tree_unflatten_like
    args = _spmd_args(arch, _mesh_model_flags(
        flags + MESH_MODEL_GRAD_FLAGS.get(arch, []), world, data))
    cfg = _spmd_cfg(args).replace(param_dtype="float32")
    fam = get_family(cfg.family)
    params = fam.init_params(cfg, seed=args.seed, device=device)
    (batch,) = make_batches(TokenDataConfig(
        vocab=cfg.vocab, seq_len=args.seq, seed=args.seed), num_batches=1,
        batch_size=args.per_micro)
    batch.update(train.stub_inputs(cfg, args.per_micro, [args.seed, 0]))
    batch = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}

    def loss(p, b):
        return fam.loss(p, b, cfg)

    if mesh is None:
        return [g.cpu() for g in tree_leaves(loss_grad(loss, params, batch))]
    # the master's model blocks (its ZeRO data dim left whole)
    shs = [NamedSharding(s.mesh, tuple(e if e == "model" else None
                                       for e in s.spec), s.shape)
           for s in tree_leaves(tree_shardings(params, cfg, mesh,
                                               role="master"))]
    dims = master_model_dims(shs)
    whole = [tuple(l.shape) for l in tree_leaves(params)]
    params = tree_unflatten_like(params, [
        l if d is None else block(l, s, 0, mesh.model_rank).contiguous()
        for l, d, s in zip(tree_leaves(params), dims, shs)])
    layers.set_mesh_context(mesh, cfg=cfg)
    try:
        grads = loss_grad(loss, params, batch)
    finally:
        layers.clear_mesh_context()
    del params
    grads = coll.all_gather_tree(grads, dims, mesh.model_group)
    if mesh.rank or mesh.model_rank:
        return None
    # padded blocks (heads_padded) narrowed to the whole leaves
    return [(g if d is None else g.narrow(d, 0, n[d])).cpu()
            for g, d, n in zip(tree_leaves(grads), dims, whole)]


def _per_leaf(names, pairs):
    """(relative L2, leaf name) per leaf, sorted; its median and largest."""
    rels = sorted((_rel_l2(a, b), n) for n, (a, b) in zip(names, pairs))
    return rels, rels[len(rels) // 2][0], rels[-1]


def _full_width_bounds(arch, args, cfg, got, ref, grad, grad_ref, tag=""):
    """[mesh-model]'s bounds at full width: the f32 gradient on the model
    axis (``grad``) against W = 1's (``grad_ref``; for an arch of
    ``MESH_MODEL_GRAD_FLAGS``, of the model those flags make), per leaf
    within ``MESH_MODEL_GRAD_RTOL``; and each leaf's update in the bf16
    runs (``got`` minus the initial params) against W = 1's (``ref``
    minus them), median and largest within ``MESH_MODEL_UPDATE_MEDIAN`` /
    ``_MAX`` (or the arch's ``MESH_MODEL_UPDATE_MAX_OF``).  The master
    alone would hide a wrong update behind the
    initial weights, and delta_norm behind the noise, which is the same
    on both sides; the noise still swamps most of a bf16 update, so the
    f32 gradient is the sharper of the two.  Logs both before requiring
    either."""
    import torch
    from repro_torch.models.base import get_family
    from repro_torch.pytree import tree_leaves, tree_paths
    init = get_family(cfg.family).init_params(cfg, seed=args.seed,
                                              device="cuda")
    names = ["/".join(map(str, p)) for p in tree_paths(init)]
    init = [l.float().cpu() for l in tree_leaves(init)]
    label = f"{arch} {tag}".strip()
    for name, a in zip(names, got):
        require(bool(torch.isfinite(a).all()),
                f"[mesh-model] {label}: nonfinite master at {name}")
    g_rels, g_med, (g_top, g_at) = _per_leaf(names, zip(grad, grad_ref))
    u_rels, u_med, (u_top, u_at) = _per_leaf(
        names, [(a - i, b - i) for a, b, i in zip(got, ref, init)])
    cut = MESH_MODEL_GRAD_FLAGS.get(arch)
    log(f"[mesh-model] {label}: f32 gradient of one microbatch at full "
        f"width{f' (spmd flags {cut})' if cut else ''}, relative L2 per "
        f"leaf from W=1 over {len(g_rels)} leaves: "
        f"median {g_med:.4e}, max {g_top:.4e} at {g_at}, largest five "
        f"{[(float(f'{r:.4e}'), n) for r, n in g_rels[-5:]]}")
    log(f"[mesh-model] {label}: update (master - init) relative L2 per "
        f"leaf from W=1 over {len(u_rels)} leaves: median {u_med:.4e}, max "
        f"{u_top:.4e} at {u_at}, largest five "
        f"{[(float(f'{r:.4e}'), n) for r, n in u_rels[-5:]]}")
    require(g_top <= MESH_MODEL_GRAD_RTOL,
            f"[mesh-model] {label}: gradient bound: max {g_top:.4e} at "
            f"{g_at} (limit {MESH_MODEL_GRAD_RTOL}) from W=1")
    u_cap = MESH_MODEL_UPDATE_MAX_OF.get(arch, MESH_MODEL_UPDATE_MAX)
    require(u_med <= MESH_MODEL_UPDATE_MEDIAN and u_top <= u_cap,
            f"[mesh-model] {label}: update bound: median {u_med:.4e} (limit "
            f"{MESH_MODEL_UPDATE_MEDIAN}), max {u_top:.4e} at {u_at} (limit "
            f"{u_cap}) from W=1")


def _mesh_model_rank(rank, port, world, backend, arch, flags, data, out,
                     rerun_port, small_port, grad=True, serve=None,
                     dp_port=None, padded_port=None):
    """One rank of [mesh-model]: ``run_spmd`` on a data x model mesh through
    ``launch.train.spmd_rank`` (gloo, every rank on cuda:0), recording
    each ssd_intra_chunk launch's head count and holding the first launch
    against the plain version on the same inputs; then, with
    ``rerun_port``, round 0 again in this process; then the f32
    reduced round of the same family on the same mesh shape and the f32
    gradient of one microbatch at full width (``_full_grad``); with
    ``serve`` (W = 1's tokens of each ``SERVE_MESH`` entry), [serve-mesh]
    on the same mesh (``_serve_mesh_ranks``); with ``dp_port``, one round
    of ``MESH_MODEL_DP`` with one client per rank (``_mesh_dp_run``);
    with ``padded_port``, one round under ``heads_padded`` after the
    rounds (its master's padded slots, prints and collectives) and its
    f32 gradient.  Saves what it measured to ``out/rank<r>.pt``."""
    device = _rank_setup(rank, world, port, backend, join=False)
    import torch
    import torch.distributed as dist
    from repro_torch.kernels.ssd_scan import ref as sref, ssd_scan
    from repro_torch.launch import collectives as coll
    from repro_torch.launch import train
    from repro_torch.launch.mesh import HostMesh, make_host_mesh
    from repro_torch.launch.shardings import (set_sharding_options,
                                             tree_shardings)
    from repro_torch.models.base import get_family
    from repro_torch.pytree import tree_leaves

    launch = ssd_scan.ssd_intra_chunk
    seen = {"heads": set(), "err": None}

    def counted(xr, ar, Br, Cr):
        y = launch(xr, ar, Br, Cr)
        seen["heads"].add(int(xr.shape[3]))
        if seen["err"] is None:
            want = sref.ssd_intra_chunk_ref(xr, ar, Br, Cr)
            top = float(want.abs().max())
            seen["err"] = (float((y.float() - want).abs().max()), top,
                           tuple(xr.shape), bool(torch.allclose(
                               y.float(), want, rtol=SSD_BF16_RTOL,
                               atol=1e-2 * top)))
        return y

    ssd_scan.ssd_intra_chunk = counted

    def run(at_port, steps=None):
        args = _spmd_args(arch, _mesh_model_flags(flags, world, data))
        args.steps = steps or args.steps
        st = {"launches": [], "walls": [], "norms": [], "prints": [],
              "n": 0, "t": time.perf_counter()}

        def on_round(i, master, metrics):
            torch.cuda.synchronize()
            now = time.perf_counter()
            st["walls"].append(now - st["t"])
            st["launches"].append(ssd_scan.launches() - st["n"])
            st["norms"].append(float(metrics["delta_norm"]))
            st["prints"].append(_fingerprint(master))
            if padded["sh"] is not None:
                st.setdefault("padded_max", []).append(_padded_max(
                    master, padded["sh"], rank % (world // data)))
            st["n"], st["t"] = ssd_scan.launches(), time.perf_counter()

        torch.cuda.reset_peak_memory_stats()
        ssd_scan.reset_launches()
        coll.reset_stats()
        t0 = time.perf_counter()
        whole = train.spmd_rank(args, rank, at_port, backend=backend,
                                on_round=on_round, cfg=_spmd_cfg(args))
        torch.cuda.synchronize()
        res = dict(launches=st["launches"], walls=st["walls"],
                   norms=st["norms"], prints=st["prints"],
                   total=ssd_scan.launches(),
                   wall=time.perf_counter() - t0,
                   peak=torch.cuda.max_memory_allocated(),
                   collectives=coll.stats(),
                   padded_max=st.get("padded_max"))
        if rank == 0:
            res["master"] = [l.cpu() for l in tree_leaves(whole)]
        return res

    padded = {"sh": None}
    res = run(port)
    res["heads"], res["kernel_err"] = sorted(seen["heads"]), seen["err"]
    if rerun_port is not None:
        again = run(rerun_port, steps=1)
        res["rerun"] = {k: again[k] for k in ("norms", "prints", "wall")}
    if padded_port is not None:
        _free_card()
        set_sharding_options(attn_shard="heads_padded")
        try:
            cfg = _spmd_cfg(_spmd_args(arch, _mesh_model_flags(
                flags, world, data)))
            padded["sh"] = tree_shardings(
                get_family(cfg.family).init_params(cfg, 0, device="meta"),
                cfg, HostMesh.abstract(data, world // data), role="master")
            res["padded"] = run(padded_port, steps=1)
        finally:
            set_sharding_options(attn_shard="even")
            padded["sh"] = None
    coll.init_group(backend, rank, world, small_port, device)
    try:
        mesh = make_host_mesh(data=data, model=world // data)
        small, dn, n = _small_tp_round(arch, device, mesh)
        res["small"] = {"delta_norm": dn, "launches": n,
                        "master": small if rank == 0 else None}
        torch.cuda.empty_cache()
        if grad:
            res["grad"] = _full_grad(arch, flags, world, data, device, mesh)
        if padded_port is not None:
            torch.cuda.empty_cache()
            set_sharding_options(attn_shard="heads_padded")
            try:
                res["padded"]["grad"] = _full_grad(arch, flags, world, data,
                                                   device, mesh)
            finally:
                set_sharding_options(attn_shard="even")
        if serve is not None:
            _free_card()
            t0 = time.perf_counter()
            res["serve"] = _serve_mesh_ranks(mesh, device, serve)
            res["serve_wall"] = time.perf_counter() - t0
    finally:
        dist.destroy_process_group()
    if dp_port is not None:
        _free_card()
        res["dp"] = _mesh_dp_run(rank, world, data, backend, dp_port)
    torch.save(res, out / f"rank{rank}.pt",
               _use_new_zipfile_serialization=False)


def _mesh_padded_check(smi, arch, args, cfg, ranks, st, grad_ref, world,
                       data):
    """[mesh-model]'s heads_padded round (``MESH_MODEL_PADDED``): rank 0's
    master after it and the f32 gradient against W = 1's after the same
    round (``_full_width_bounds``); every rank's padded master slots
    exactly zero; the blocks of the leaves the padded placement leaves
    whole bit-identical across each model group; the ranks' delta norms
    equal.  Logs each rank's collectives of the even rounds and of the
    padded round side by side."""
    from repro_torch.launch.mesh import HostMesh
    from repro_torch.launch.shardings import (model_dim, set_sharding_options,
                                             tree_shardings)
    from repro_torch.models.base import get_family
    from repro_torch.pytree import tree_leaves
    m = world // data
    got = ranks[0]["padded"]
    _full_width_bounds(arch, args, cfg, got["master"], st["kept"],
                       got["grad"], grad_ref, tag="heads_padded")
    set_sharding_options(attn_shard="heads_padded")
    try:
        dims = [model_dim(s) for s in tree_leaves(tree_shardings(
            get_family(cfg.family).init_params(cfg, 0, device="meta"), cfg,
            HostMesh.abstract(data, m), role="master"))]
    finally:
        set_sharding_options(attn_shard="even")
    for r, res in enumerate(ranks):
        hp = res["padded"]
        require(hp["padded_max"] == [0.0], f"[mesh-model] {arch} "
                f"heads_padded rank {r}: padded master slots "
                f"{hp['padded_max']}, not zero")
        require(hp["norms"] == got["norms"], f"[mesh-model] {arch} "
                "heads_padded: the ranks' delta norms differ")
    for lead in range(0, world, m):
        for r in range(lead + 1, lead + m):
            for j, d in enumerate(dims):
                if d is None:
                    require(ranks[r]["padded"]["prints"][-1][j]
                            == ranks[lead]["padded"]["prints"][-1][j],
                            f"[mesh-model] {arch} heads_padded: leaf {j} "
                            f"(whole on the model axis) differs in the "
                            f"model group of rank {lead}")
    rel_n = abs(got["norms"][0] - st["norms"][0]) / abs(st["norms"][0])
    log(f"[mesh-model] {smi}; {arch} heads_padded: one round from the "
        f"same initial master, delta_norm {rel_n:.3e} from W=1's first "
        f"round; padded master slots zero on every rank; "
        f"{sum(d is not None for d in dims)} of {len(dims)} leaves cut on "
        f"the model axis, the blocks of the other "
        f"{sum(d is None for d in dims)} bit-identical across each model "
        f"group")

    def calls(c):
        return {k: (v["calls"], v["bytes"], round(v["seconds"], 3))
                for k, v in c.items()}

    for r, res in enumerate(ranks):
        hp = res["padded"]
        log(f"[mesh-model] {arch} rank {r}: collectives (calls, bytes, host "
            f"s) of the even run's {args.steps} round(s) "
            f"{calls(res['collectives'])} | of the heads_padded round "
            f"{calls(hp['collectives'])}; heads_padded round wall "
            f"{[round(w, 3) for w in hp['walls']]} s (with init and a loss "
            f"eval), run {hp['wall']:.1f} s, peak "
            f"{hp['peak'] / 2**30:.2f} GiB")


# [mesh-model]'s one-client-per-rank round (``client_placement="dp"``),
# in the ranks of the zamba2-1.2b entry (data 1 x model 2): one round of
# smollm-360m at full width and depth at the launcher's defaults, G = the
# ranks, each client's model whole on its rank; held to the one-process
# round of the same G
MESH_MODEL_DP = ("smollm-360m", ["--steps", "1"])


def _mesh_dp_args(world, data, placement=True):
    arch, flags = MESH_MODEL_DP
    extra = (["--devices", str(world), "--data-axis", str(data)]
             if placement else ["--data-axis", str(world)])
    return _spmd_args(arch, flags + extra)


def _mesh_dp_run(rank, world, data, backend, port):
    """This rank's run of the ``MESH_MODEL_DP`` round through
    ``launch.train.spmd_rank``: its delta norm, wall, peak memory and
    collectives, and on rank 0 the whole final master."""
    import torch
    from repro_torch.launch import collectives as coll
    from repro_torch.launch import train
    from repro_torch.pytree import tree_leaves
    args = _mesh_dp_args(world, data)
    norms = []
    torch.cuda.reset_peak_memory_stats()
    coll.reset_stats()
    t0 = time.perf_counter()
    whole = train.spmd_rank(
        args, rank, port, backend=backend, cfg=_spmd_cfg(args),
        client_placement="dp",
        on_round=lambda i, m, met: norms.append(float(met["delta_norm"])))
    torch.cuda.synchronize()
    res = dict(norms=norms, wall=time.perf_counter() - t0,
               peak=torch.cuda.max_memory_allocated(),
               collectives=coll.stats())
    if rank == 0:
        res["master"] = [l.cpu() for l in tree_leaves(whole)]
    return res


def _mesh_dp_ref(world, data):
    """The one-process round of ``MESH_MODEL_DP`` at G = ``world``: its
    whole final master on the CPU, delta norms, wall and peak."""
    import torch
    from repro_torch.launch import train
    from repro_torch.pytree import tree_leaves
    args = _mesh_dp_args(world, data, placement=False)
    norms = []
    _free_card()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    master = train.run_spmd(
        args, cfg=_spmd_cfg(args),
        on_round=lambda i, m, met: norms.append(float(met["delta_norm"])))
    torch.cuda.synchronize()
    ref = dict(master=[l.cpu() for l in tree_leaves(master)], norms=norms,
               wall=time.perf_counter() - t0,
               peak=torch.cuda.max_memory_allocated())
    del master
    _free_card()
    return ref


def _mesh_dp_check(smi, ref, ranks, world, data):
    """The ``MESH_MODEL_DP`` round on the ranks against the one-process
    round of the same G (``ref``: its master and delta norms): bit-identical,
    or within ``MESH_TIGHT``; equal delta norms on every rank."""
    import torch
    got = [r["dp"] for r in ranks]
    for leaf in got[0]["master"]:
        require(bool(torch.isfinite(leaf).all()),
                "[mesh-model] dp: nonfinite master")
    same = all(torch.equal(a, b) for a, b in zip(got[0]["master"],
                                                 ref["master"]))
    worst = max(float((a - b).abs().max())
                for a, b in zip(got[0]["master"], ref["master"]))
    require(same or worst <= MESH_TIGHT, f"[mesh-model] dp: master "
            f"{worst:.3e} from the one-process round")
    for r, res in enumerate(got):
        require(res["norms"] == got[0]["norms"], f"[mesh-model] dp rank "
                f"{r}: delta norms differ")
    rel = abs(got[0]["norms"][0] - ref["norms"][0]) / ref["norms"][0]
    require(rel <= MESH_TIGHT, f"[mesh-model] dp: delta_norm {rel:.3e} "
            "from the one-process round")
    arch = MESH_MODEL_DP[0]
    log(f"[mesh-model] {smi}; {arch} client_placement dp on (data "
        f"{data}, model {world // data}), {world} gloo ranks on one card, "
        f"G={world} (one client per rank, its model whole there), one "
        f"round, full depth: master "
        + ("bit-identical to" if same else f"{worst:.3e} from")
        + f" the one-process round of G={world} (delta_norm {rel:.3e}); "
        f"one process {ref['wall']:.1f} s, peak {ref['peak'] / 2**30:.2f} "
        f"GiB; per rank " + "; ".join(
            f"rank {r} run {res['wall']:.1f} s, peak "
            f"{res['peak'] / 2**30:.2f} GiB, collectives (calls, bytes, s) "
            + str({k: (v['calls'], v['bytes'], round(v['seconds'], 2))
                   for k, v in res['collectives'].items()})
            for r, res in enumerate(got)))


def phase_mesh_model(smi, configs=MESH_MODEL, backend="gloo",
                     reference=True, serve=False):
    """[mesh-model]: ``launch/train.py spmd --devices N --data-axis G`` with
    a model axis of N / G = 2 at full width (``MESH_MODEL``: full depth,
    or the depth cut the entry's ``DEPTH`` makes, logged), every rank
    a gloo process on the one card, 2 rounds (or the entry's
    ``--steps``); the same run at W = 1 (``--devices 1``) in this
    process is the reference (for ``MESH_MODEL_BESIDE``'s entries, run
    while their ranks run).  Requires
    per rank: ssd_intra_chunk launched per round as often as the W = 1
    run per client, at H / 2 = 32 heads, its first launch within the
    bf16 tolerance of the plain version on the same inputs; the ranks'
    delta norms equal; the blocks of the leaves the model axis leaves
    whole bit-identical across each model group; zamba2's round 0 rerun
    in the same processes bit-identical; a finite master; the full-width
    bounds of ``_full_width_bounds`` (held first: one microbatch's f32
    gradient per leaf, and the bf16 runs' update per leaf, against
    W = 1's); and the f32 round of each reduced config on the same mesh
    shape within 1e-5 of its W = 1 round on the card.  Logs each
    rank's walls, peak memory and collectives (calls and bytes).
    ``backend="nccl"`` puts each rank on its own card
    (``scripts/torch_model_axis_cards.py``); ``reference=False`` runs no
    W = 1 run at full width (for a model whose W = 1 round does not fit
    one card; dense families only), and then all it checks is the ranks'
    equal delta norms, the whole leaves bit-identical across each model
    group, a finite master and the reduced f32 round.  With ``serve``,
    the zamba2-1.2b entry's ranks also run [serve-mesh] (W = 1's runs in
    this process first; ``_serve_mesh_check``).  Returns the launches of
    the ranks' main runs, per kernel."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.collectives import free_port
    from repro_torch.launch.mesh import HostMesh
    from repro_torch.launch.shardings import model_dim, tree_shardings
    from repro_torch.models.base import get_family
    from repro_torch.models.mamba2 import n_heads_ssm
    from repro_torch.pytree import tree_leaves
    launches = {"ssd_intra_chunk": 0, "flash_decode": 0}
    out = ROOT / "build" / "mesh_model"
    out.mkdir(parents=True, exist_ok=True)
    for arch, flags, world, data, rerun in configs:
        t_phase = time.perf_counter()
        args = _spmd_args(arch, _mesh_model_flags(flags, world, data))
        cfg = _spmd_cfg(args)
        m = world // data
        hybrid = cfg.family == "hybrid"
        require(reference or not hybrid, f"[mesh-model] {arch}: the hybrid's "
                "launch check needs the W = 1 run")
        whole_depth = get_config(arch)
        depth = (f"depth cut to {cfg.n_layers} of {whole_depth.n_layers} "
                 f"layers" if args.depth else "full depth")
        log(f"[mesh-model] {arch}: {depth}, full width, "
            f"{cfg.param_dtype} clients")

        padded = reference and arch == MESH_MODEL_PADDED

        def w1(arch=arch, flags=flags, world=world, data=data,
               padded=padded):
            """This entry's W = 1 runs, in this process."""
            run = (_train_spmd_once(arch, _mesh_model_flags(flags, 1, data),
                                    smi, keep_round=0 if padded else None)
                   if reference else (None,) * 6)
            return (run, _small_tp_round(arch, "cuda"),
                    _full_grad(arch, flags, world, data, "cuda")
                    if reference else None)

        beside = backend == "gloo" and arch in MESH_MODEL_BESIDE
        refs = None if beside else w1()
        serve_refs = dp_ref = None
        if serve and arch == "zamba2-1.2b":
            t0 = time.perf_counter()
            serve_refs = _serve_mesh_refs()
            log(f"[serve-mesh] W=1 runs {time.perf_counter() - t0:.1f} s")
            dp_ref = _mesh_dp_ref(world, data)
        _free_card()
        t0 = time.perf_counter()
        got = _mesh_spawn(_mesh_model_rank, world, world, backend, arch,
                          flags, data, out, free_port() if rerun else None,
                          free_port(), reference, None if serve_refs is None
                          else [r["tokens"] for r in serve_refs],
                          None if dp_ref is None else free_port(),
                          free_port() if padded else None,
                          during=w1 if beside else None)
        (ref, _, st, ref_peak, _, _), (small_ref, small_dn, small_n), \
            grad_ref = refs or got
        ranks = [torch.load(out / f"rank{r}.pt", weights_only=False)
                 for r in range(world)]
        wall = time.perf_counter() - t0
        for f in out.iterdir():
            f.unlink()
        if reference:
            _full_width_bounds(arch, args, cfg, ranks[0]["master"], ref,
                               ranks[0]["grad"], grad_ref)
        else:
            require(all(bool(torch.isfinite(a).all())
                        for a in ranks[0]["master"]),
                    f"[mesh-model] {arch}: nonfinite master")
        dims = [model_dim(s) for s in tree_leaves(tree_shardings(
            get_family(cfg.family).init_params(cfg, 0, device="meta"), cfg,
            HostMesh.abstract(data, m), role="master"))]
        # W = 1's launches per client (its last round has no loss eval);
        # a rank runs G / data clients, and every rank evaluates the loss
        w1_launches = st["launches"] if reference else [0]
        per_client = w1_launches[-1] // args.data_axis
        require(per_client == (2 * cfg.n_layers * args.n_local * args.n_micro
                               if hybrid else 0),
                f"[mesh-model] {arch} W=1: {w1_launches} launches")
        want = [per_client * (args.data_axis // data)] * args.steps
        evals = cfg.n_layers if hybrid else 0
        want[0] += evals
        for r, res in enumerate(ranks):
            require(res["launches"] == want
                    and res["total"] == sum(want) + evals,
                    f"[mesh-model] {arch} rank {r}: ssd_intra_chunk per "
                    f"round {res['launches']} ({res['total']} in all), "
                    f"expected {want} (W=1 {w1_launches}, "
                    f"{per_client} per client)")
            require(res["norms"] == ranks[0]["norms"], f"[mesh-model] "
                    f"{arch}: the ranks' delta norms differ")
            if hybrid:
                require(res["heads"] == [n_heads_ssm(cfg) // m],
                        f"[mesh-model] {arch} rank {r}: ssd_intra_chunk "
                        f"heads {res['heads']}")
                err, top, shape, ok = res["kernel_err"]
                require(ok, f"[mesh-model] {arch} rank {r}: ssd_intra_chunk "
                        f"{shape} max |err| {err} vs plain (max {top})")
                launches["ssd_intra_chunk"] += res["total"]
            if rerun:
                require(res["rerun"]["prints"][0] == res["prints"][0]
                        and res["rerun"]["norms"][0] == res["norms"][0],
                        f"[mesh-model] {arch} rank {r}: the rerun of round "
                        "0 differs")
        for lead in range(0, world, m):
            for r in range(lead + 1, lead + m):
                for j, d in enumerate(dims):
                    if d is None:
                        require(ranks[r]["prints"][-1][j]
                                == ranks[lead]["prints"][-1][j],
                                f"[mesh-model] {arch}: leaf {j} (whole on "
                                f"the model axis) differs in the model "
                                f"group of rank {lead}")
        # the walls of an entry whose W = 1 run goes on beside its ranks
        # are taken with both on the card and the host at once
        overlap = (" (overlapped: W=1 ran beside the ranks on the same "
                   "card and host)" if beside else "")
        if reference:
            rel_n = max(abs(a - b) / abs(b) for a, b in
                        zip(ranks[0]["norms"], st["norms"]))
            w1 = (f"delta_norm {rel_n:.3e} from W=1; W=1 walls "
                  f"{[round(w, 3) for w in st['walls']]} s{overlap}, peak "
                  f"{ref_peak / 2**30:.2f} GiB")
        else:
            w1 = "no W=1 run at full width (its round does not fit a card)"
        small = ranks[0]["small"]
        d_small = max(float((a - b).abs().max())
                      for a, b in zip(small["master"], small_ref))
        require(d_small <= MESH_TIGHT and abs(
            small["delta_norm"] - small_dn) <= MESH_TIGHT * small_dn,
                f"[mesh-model] reduced {arch} (f32): {d_small:.3e} from W=1")
        require(small["launches"] == small_n // data,
                f"[mesh-model] reduced {arch}: ssd_intra_chunk launches "
                f"{small['launches']} per rank, W=1 {small_n} for "
                f"{data} data rank(s)")
        heads = (f"ssd_intra_chunk per rank per round {ranks[0]['launches']}"
                 f" (W=1 {w1_launches}, "
                 f"{per_client} per client, +"
                 f"{evals} per loss eval), at {ranks[0]['heads']} of "
                 f"{n_heads_ssm(cfg)} heads (first launch "
                 f"{ranks[0]['kernel_err'][2]} max |err| "
                 f"{ranks[0]['kernel_err'][0]:.3e} of "
                 f"{ranks[0]['kernel_err'][1]:.3e} vs plain)"
                 if hybrid else "no ssd_intra_chunk (dense)")
        note = ("; round 0 rerun in the same processes bit-identical on "
                f"every rank's blocks ({ranks[0]['rerun']['wall']:.1f} s)"
                if rerun else "")
        where = "on one card" if backend == "gloo" else "a card per rank"
        log(f"[mesh-model] {smi}; {arch} --devices {world} --data-axis "
            f"{data} (model axis {m}, G={args.data_axis}, n_micro="
            f"{args.n_micro}, per_micro={args.per_micro}, seq {args.seq}, "
            f"{cfg.param_dtype} clients, f32 master; {world} {backend} "
            f"ranks {where}), {args.steps} round(s), {depth}: {heads}; "
            f"the blocks "
            f"of the {sum(d is None for d in dims)} leaves whole on the "
            f"model axis bit-identical across each model group; {w1}; "
            f"reduced f32 round on the same "
            f"mesh shape {d_small:.3e} from W=1 (tolerance {MESH_TIGHT}); "
            f"spawn to exit {wall:.1f} s{note}; phase "
            f"{time.perf_counter() - t_phase:.1f} s")
        for r, res in enumerate(ranks):
            coll_s = sum(v["seconds"] for v in res["collectives"].values())
            calls = {k: (v["calls"], v["bytes"])
                     for k, v in res["collectives"].items()}
            log(f"[mesh-model] {arch} rank {r}: walls per round "
                f"{[round(w, 3) for w in res['walls']]} s (round 0 with "
                f"init and a loss eval){overlap}, run {res['wall']:.1f} s "
                f"of which {coll_s:.1f} s in collectives (host clock), "
                f"peak memory "
                f"{res['peak'] / 2**30:.2f} GiB, collectives (calls, "
                f"bytes) {calls}")
        if padded:
            _mesh_padded_check(smi, arch, args, cfg, ranks, st, grad_ref,
                               world, data)
        if dp_ref is not None:
            _mesh_dp_check(smi, dp_ref, ranks, world, data)
        if serve_refs is not None:
            launches["flash_decode"] += _serve_mesh_check(
                smi, serve_refs, ranks, max(r["serve_wall"] for r in ranks))
            for r, res in enumerate(ranks):
                launches["ssd_intra_chunk"] += sum(
                    e["ssd"] for e in res["serve"])
        del ranks, ref, grad_ref, serve_refs, dp_ref
        _free_card()
    return launches


# [serve-mesh]: serving on a model axis of 2 (``launch/serve.py``) in the
# two gloo ranks of [mesh-model]'s zamba2-1.2b entry (data 1 x model 2,
# both on the one card), against W = 1 in this process, full width and
# depth, seeded weights.  (arch, dtype, batch, prompt length, decode
# steps, held to W = 1's logits): zamba2 in f32 runs ssd_intra_chunk on 32
# of its 64 SSM heads in the prefill and flash_decode on 16 of its 32 kv
# heads; smollm-360m's 5 kv heads do not divide 2, so its K/V blocks are
# cut on head_dim and gathered whole for each step; zamba2 in bf16 gives
# the numbers at 2 rows (bf16 rounding moves a deep random model far from
# f32: PERF.md section 6), so only finite logits, launches and cache bytes
# are required of it.  The fourth entry serves smollm-360m again under
# ``attn_shard="heads_padded"`` (its 15/5 heads padded to 8/3 slots a
# rank, each rank's query heads through flash_decode on the whole GQA
# groups they read: 9/3 heads a launch on both ranks), fed and held to
# the second entry's W = 1 run (an entry's optional seventh field names
# the option; W = 1 has no model axis, so it runs once)
SERVE_MESH = (("zamba2-1.2b", "float32", 2, 2048, 16, True),
              ("smollm-360m", "float32", 2, 2048, 16, True),
              ("zamba2-1.2b", "bfloat16", 2, 2048, 16, False),
              ("smollm-360m", "float32", 2, 2048, 16, True, "heads_padded"))
SERVE_MESH_TOL = 1e-3            # [serve-zoo-small]'s bound
SERVE_MESH_SEED = 5


def _attn_applications(cfg):
    """flash_decode launches per decode step of ``cfg``."""
    if cfg.family == "hybrid":
        from repro_torch.models.hybrid import segment_plan
        return segment_plan(cfg)[0]
    return _attn_per_step(cfg)


def _serve_entry(entry):
    """A ``SERVE_MESH`` entry as (arch, dtype, B, S, steps, checked,
    attn_shard): the option is "even" unless the entry names it."""
    return tuple(entry[:6]) + ((entry[6] if len(entry) > 6 else "even"),)


def _serve_mesh_one(arch, dtype, B, S, steps, forced=None, mesh=None,
                    device="cuda", attn="even"):
    """A prefill of B x S prompt tokens and ``steps`` decode steps of the
    full-width ``arch`` in ``dtype``: W = 1 (``mesh`` None) or this rank
    of ``mesh`` (``launch/serve.py``).  The tokens fed are ``forced``
    ((B, steps), teacher forcing) or the greedy ones.  The kernels'
    counters are read just before the prefill and after the last step;
    the first flash_decode launch is held against the plain version on
    the same inputs (that call launches nothing).  Returns the logits of
    every step (CPU, f32), the launches, the heads each kernel saw, the
    cache's bytes and the wall times.  ``attn``: the sharding option the
    params are placed and served under (restored after)."""
    import contextlib
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attn import flash_attn, ref as fref
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.launch import collectives as coll
    from repro_torch.launch import serve
    from repro_torch.launch.shardings import set_sharding_options
    from repro_torch.models.base import get_family
    from repro_torch.pytree import tree_leaves
    cfg = get_config(arch).replace(param_dtype=dtype)
    fam = get_family(cfg.family)
    params = fam.init_params(cfg, 0, device)
    prompt = _prompts(cfg, B, S, SERVE_MESH_SEED).to(device)
    set_sharding_options(attn_shard=attn)
    if mesh is None:
        cache = fam.init_cache(cfg, B, S + steps, device)
        ctx = contextlib.nullcontext()
    else:
        params = serve.place_params(params, cfg, mesh)
        cache = serve.init_cache(cfg, B, S + steps, mesh, device)
        ctx = serve.context(mesh, cfg, B)
    seen = {"ssd": set(), "flash": set(), "flash_err": None}
    ssd_launch, flash_launch = ssd_scan.ssd_intra_chunk, flash_attn.flash_decode

    def ssd(xr, *rest):
        seen["ssd"].add(int(xr.shape[3]))
        return ssd_launch(xr, *rest)

    def flash(q, k, v, pos, **kw):
        out = flash_launch(q, k, v, pos, **kw)
        seen["flash"].add((int(q.shape[1]), int(k.shape[2]),
                           int(k.shape[3])))
        if seen["flash_err"] is None:
            # [kernels-zoo]'s tolerances
            want = fref.flash_decode_ref(q, k, v, pos, **kw).float()
            tol = 1e-5 if q.dtype == torch.float32 else 2e-2
            seen["flash_err"] = (float((out.float() - want).abs().max()),
                                 bool(torch.allclose(out.float(), want,
                                                     rtol=tol, atol=tol)))
        return out

    ssd_scan.ssd_intra_chunk, flash_attn.flash_decode = ssd, flash
    _free_card()
    torch.cuda.reset_peak_memory_stats()
    coll.reset_stats()
    n_ssd, n_flash = ssd_scan.launches(), flash_attn.launches()
    logits, walls = [], []
    try:
        with ctx, torch.no_grad():
            t0 = time.perf_counter()
            lg, cache = fam.prefill(params, {"tokens": prompt}, cfg, cache)
            torch.cuda.synchronize()
            t_prefill = time.perf_counter() - t0
            ssd_prefill = ssd_scan.launches() - n_ssd
            logits.append(lg.float().cpu())
            for t in range(steps):
                feed = (lg.argmax(-1) if forced is None
                        else forced[:, t].to(device))
                pos = torch.full((B,), S + t, dtype=torch.int32,
                                 device=device)
                t0 = time.perf_counter()
                lg, cache = fam.decode_step(
                    params, cache, feed[:, None].to(torch.int32), pos, cfg)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
                logits.append(lg.float().cpu())
    finally:
        ssd_scan.ssd_intra_chunk, flash_attn.flash_decode = (ssd_launch,
                                                             flash_launch)
        set_sharding_options(attn_shard="even")
    logits = torch.stack(logits)                    # (steps + 1, B, V)
    return {"logits": logits, "tokens": logits.argmax(-1),
            "ssd": ssd_prefill, "flash": flash_attn.launches() - n_flash,
            "ssd_heads": sorted(seen["ssd"]),
            "flash_shapes": sorted(seen["flash"]),
            "flash_err": seen["flash_err"],
            "cache_bytes": sum(t.numel() * t.element_size()
                               for t in tree_leaves(cache)),
            "prefill_s": t_prefill, "step_s": walls,
            "peak": torch.cuda.max_memory_allocated(),
            "collectives": coll.stats(), "attn": _attn_applications(cfg),
            "n_layers": cfg.n_layers, "family": cfg.family,
            "heads": (cfg.n_heads, cfg.n_kv_heads, cfg.head_dim)}


def _serve_mesh_ranks(mesh, device, forced, entries=SERVE_MESH):
    """[serve-mesh] on this rank: every ``SERVE_MESH`` entry, teacher-forced
    with W = 1's greedy tokens ``forced[i]`` ((steps + 1, B): the prefill's
    and each step's; the last is never fed)."""
    out = []
    for entry, toks in zip(entries, forced):
        arch, dtype, B, S, steps, _, attn = _serve_entry(entry)
        out.append(_serve_mesh_one(arch, dtype, B, S, steps,
                                   toks[:-1].t(), mesh, device, attn))
        _free_card()
    return out


def _serve_mesh_refs(entries=SERVE_MESH):
    """W = 1 of every entry in this process (greedy); an entry that differs
    from an earlier one only in its sharding option shares that one's
    run."""
    refs, runs = [], {}
    for entry in entries:
        key = _serve_entry(entry)[:5]
        if key not in runs:
            runs[key] = _serve_mesh_one(*key)
            _free_card()
        refs.append(runs[key])
    return refs


def _serve_mesh_check(smi, refs, ranks, wall, entries=SERVE_MESH,
                      where="gloo, one card"):
    """Hold each rank's [serve-mesh] entries to W = 1; log the numbers.
    Returns the flash_decode launches of the ranks."""
    import torch
    from repro_torch.launch.shardings import real_range
    launches = 0
    for i, entry in enumerate(entries):
        arch, dtype, B, S, steps, checked, attn = _serve_entry(entry)
        ref = refs[i]
        H, Hkv, Dh = ref["heads"]
        m = len(ranks)
        kv_cut = Hkv % m == 0
        want_flash = ([(H // m, Hkv // m, Dh)] if kv_cut
                      else [(H, Hkv, Dh)])
        opt = "" if attn == "even" else f" {attn}"
        name = f"[serve-mesh] {arch} {dtype}{opt} B={B} S={S} x {steps} steps"
        for r, res in enumerate(ranks):
            if attn == "heads_padded":
                # the whole GQA groups of the kv heads this rank's real
                # query heads read
                rep_, (qlo, qhi) = H // Hkv, real_range(H, m, r)
                lo, hi = qlo // rep_, -(-qhi // rep_)
                want_flash = [((hi - lo) * rep_, hi - lo, Dh)]
            got = res["serve"][i]
            d = float((got["logits"] - ref["logits"]).abs().max())
            require(bool(torch.isfinite(got["logits"]).all()),
                    f"{name} rank {r}: nonfinite logits")
            if checked:
                require(d <= SERVE_MESH_TOL, f"{name} rank {r}: logits "
                        f"{d:.3e} from W=1 (bound {SERVE_MESH_TOL})")
                require(torch.equal(got["tokens"], ref["tokens"]),
                        f"{name} rank {r}: greedy tokens differ from W=1")
            require(got["cache_bytes"] * m == ref["cache_bytes"],
                    f"{name} rank {r}: cache {got['cache_bytes']} bytes, "
                    f"W=1 {ref['cache_bytes']}")
            require(got["flash"] == got["attn"] * steps == ref["flash"],
                    f"{name} rank {r}: flash_decode {got['flash']} launches,"
                    f" W=1 {ref['flash']}, expected {got['attn']} per step")
            require(got["flash_shapes"] == want_flash,
                    f"{name} rank {r}: flash_decode (heads, kv heads, "
                    f"head_dim) {got['flash_shapes']}, expected {want_flash}")
            require(got["flash_err"][1], f"{name} rank {r}: flash_decode "
                    f"{got['flash_err'][0]:.3e} from the plain version")
            hybrid = got["family"] == "hybrid"
            want_ssd = got["n_layers"] if hybrid else 0
            require(got["ssd"] == want_ssd == ref["ssd"]
                    and got["ssd_heads"] == ([ref["ssd_heads"][0] // m]
                                             if hybrid else []),
                    f"{name} rank {r}: ssd_intra_chunk {got['ssd']} launches "
                    f"at {got['ssd_heads']} heads, W=1 {ref['ssd']} at "
                    f"{ref['ssd_heads']}")
            launches += got["flash"]
            st = got["collectives"]
            log(f"[serve-mesh] {smi}; {arch} {dtype} ({attn}) rank {r} of a "
                f"model axis of {m} ({where}): B={B} prompt {S}, prefill "
                f"{got['prefill_s'] * 1e3:.1f} ms (W=1 "
                f"{ref['prefill_s'] * 1e3:.1f}), decode "
                f"{sum(got['step_s']) / steps * 1e3:.1f} ms per step (W=1 "
                f"{sum(ref['step_s']) / steps * 1e3:.1f}), peak "
                f"{got['peak'] / 2**30:.2f} GiB (W=1 "
                f"{ref['peak'] / 2**30:.2f}), cache {got['cache_bytes']} "
                f"bytes = W=1's / {m}; logits {d:.3e} from W=1"
                f"{'' if checked else ' (not bounded: bf16)'}; tokens "
                f"{'equal' if torch.equal(got['tokens'], ref['tokens']) else 'differ'}"
                f"; flash_decode {got['flash']} launches "
                f"({got['attn']} per step) at (heads, kv heads, Dh) "
                f"{got['flash_shapes']}, first within "
                f"{got['flash_err'][0]:.2e} of plain; ssd_intra_chunk "
                f"{got['ssd']} per prefill at {got['ssd_heads']} heads; "
                f"collectives (calls, bytes, host s) "
                f"{ {k: (v['calls'], v['bytes'], round(v['seconds'], 3)) for k, v in st.items()} }")
    log(f"[serve-mesh] the ranks' serving took {wall:.1f} s")
    return launches


# [dryrun]'s combinations: (arch, shape, run_one's knobs)
DRYRUN = (("zamba2-1.2b", "decode_32k", {}),
          ("smollm-360m", "train_4k", {"remat_policy": "dots",
                                       "client_placement": "dp"}),
          # the reference's own padded example: 56 query heads -> 64 slots
          # over 16 ranks, 8 kv heads -> 16
          ("deepseek-coder-33b", "decode_32k",
           {"attn_shard": "heads_padded"}))
DRYRUN_OUT = ROOT / "build" / "dryrun_smoke.json"


# ---------------------------------------------------------------------------
# [analysis]: the port's program audits and lint over what the phases above
# produced
# ---------------------------------------------------------------------------

# (label, RunLog.engine_stats) of every engine run of this process since
# _record_engine_stats, labelled by the phase that ran it
ENGINE_STATS = []
_LABEL = [None]
# [main]'s cohorts: (arenas before, arenas after) per submitted cohort
MAIN_ARENAS = []
# [mesh-main]'s spawned ranks' saved results, by mesh
MESH_MAIN_RANKS = {}
# the phases whose engine runs [analysis] audits
AUDITED = ("main", "rerun", "api", "legacy", "robust", "modes",
           "mesh-main")


def _stats_label(label):
    _LABEL[0] = label


def _record_engine_stats():
    """Keep every engine run's stats as the engine validates them at the
    end of the run (``engine.validate_engine_stats``), labelled with the
    running phase."""
    from repro_torch.engine import engine
    real = engine.validate_engine_stats

    def recorded(stats, *a, **kw):
        out = real(stats, *a, **kw)
        if _LABEL[0] is not None:
            ENGINE_STATS.append((_LABEL[0], out))
        return out

    engine.validate_engine_stats = recorded


@contextlib.contextmanager
def _arena_recorder():
    """Keep each cohort's client-state arenas (the tensors themselves)
    before and after its submission, for the in-place audit."""
    from repro_torch.engine.engine import CohortRunner
    real = CohortRunner.submit_cohort

    def submit(self, staged):
        before = (self._arena_params, self._arena_opt)
        out = real(self, staged)
        if staged.arena and not staged.degenerate:
            MAIN_ARENAS.append((before, (self._arena_params,
                                         self._arena_opt)))
        return out

    CohortRunner.submit_cohort = submit
    try:
        yield
    finally:
        CohortRunner.submit_cohort = real


def phase_analysis(smi):
    """[analysis]: no new run.  ``audit_engine_stats`` on every engine
    RunLog of [main], [rerun], [api], [legacy], [robust], the run modes
    and [mesh-main] (this process's, and each spawned rank's);
    ``audit_donation(expect=True)`` on each of [main]'s cohorts (the
    arenas written in place); ``audit_sharding`` and
    ``audit_collectives`` on [mesh-main]'s spawned ranks (the cohort's
    rows on each rank; all-gathers at most 3 per cohort, one per dtype
    run of the gathered params and Adam state, and no other kind); the
    port's lint over ``src/repro_torch``."""
    from repro_torch.analysis import (
        audit_collectives, audit_donation, audit_engine_stats,
        audit_sharding)
    from repro_torch.analysis import lint
    from repro_torch.pytree import tree_leaves
    t0 = time.perf_counter()
    counts = {}
    for label, st in ENGINE_STATS:
        if label in AUDITED:
            audit_engine_stats(st, label=f"[{label}] engine_stats")
            counts[label] = counts.get(label, 0) + 1
    require(set(counts) == set(AUDITED),
            f"[analysis] engine runs audited per phase: {counts}")
    n_rank_runs = 0
    for mesh_name, ranks in MESH_MAIN_RANKS.items():
        for r, res in enumerate(ranks):
            for tag, _, _ in MESH_MAIN_RUNS:
                if tag not in res:
                    continue
                what = f"[mesh-main] {mesh_name} rank {r} {tag}"
                st = audit_engine_stats(res[tag]["engine_stats"], label=what)
                budget = 3 * st["cohorts"]
                got = audit_collectives(
                    res[tag]["collectives"], label=what,
                    forbid=("all-reduce", "reduce-scatter", "broadcast"),
                    max_counts={"all-gather": budget})
                require(got.get("all-gather", 0) > 0,
                        f"{what}: no all-gather")
                n_rank_runs += 1
    require("W=2 gloo" in MESH_MAIN_RANKS, "[analysis] no W = 2 ranks")
    sharded = []
    for r, res in enumerate(MESH_MAIN_RANKS["W=2 gloo"]):
        k, rows = res["cohort_rows"]
        sharded.append(audit_sharding(
            rows, client_dim=k, min_partition=2,
            label=f"[mesh-main] W=2 gloo rank {r}"))
    require(MAIN_ARENAS, "[analysis] [main] recorded no cohort")
    n_cohorts, n_leaves = len(MAIN_ARENAS), len(tree_leaves(
        MAIN_ARENAS[0][0]))
    n_arena = sum(audit_donation(before, after, expect=True,
                                 label="[main] cohort arenas")
                  for before, after in MAIN_ARENAS)
    MAIN_ARENAS.clear()
    t_lint = time.perf_counter()
    findings = lint.run([str(ROOT / "src" / "repro_torch")])
    t_lint = time.perf_counter() - t_lint
    require(not findings, "[analysis] lint findings:\n" + "\n".join(
        f.format() for f in findings))
    log(f"[analysis] {smi}; engine_stats audited: {counts} in this process, "
        f"{n_rank_runs} runs of [mesh-main]'s spawned ranks (each also "
        f"within its collective budget of 3 all-gathers per cohort); "
        f"[main]'s {n_cohorts} cohorts wrote "
        f"all {n_leaves} arena leaves in place ({n_arena} aliases); the "
        f"W = 2 cohort partitioned on each rank ({sharded} leaves "
        f"audited); lint of src/repro_torch clean in {t_lint:.2f} s; "
        f"phase wall {time.perf_counter() - t0:.2f} s")


def _dryrun_child():
    """The child process of [dryrun]: every ``DRYRUN`` combination, the
    results written to ``DRYRUN_OUT``."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.launch import dryrun
    out = []
    for arch, shape, kw in DRYRUN:
        t0 = time.perf_counter()
        res = dryrun.run_one(arch, shape, "single", **kw)
        res["wall_s"] = time.perf_counter() - t0
        out.append(res)
    DRYRUN_OUT.write_text(json.dumps(out))


def start_dryrun():
    """[dryrun], started: ``launch/dryrun.py``'s combinations in a child
    process on the host (the card machine's torch has the fake process
    group), beside the phases on the card."""
    DRYRUN_OUT.parent.mkdir(parents=True, exist_ok=True)
    DRYRUN_OUT.unlink(missing_ok=True)
    env = dict(os.environ, OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="")
    return subprocess.Popen(
        [sys.executable, "-c", "import chip_smoke; "
         "chip_smoke._dryrun_child()"], cwd=str(ROOT), env=env), \
        time.perf_counter()


def phase_dryrun(smi, started):
    """[dryrun], read: each combination ``"ok"``; the JSON's memory,
    FLOPs and collectives (the train combination: one client per rank,
    ``n_micro`` capped at its one row, the dots policy)."""
    proc, t0 = started
    t_wait = time.perf_counter()
    rc = proc.wait(timeout=600)
    require(rc == 0 and DRYRUN_OUT.exists(), f"[dryrun] child exit {rc}")
    results = json.loads(DRYRUN_OUT.read_text())
    DRYRUN_OUT.unlink()
    for (arch, shape, kw), res in zip(DRYRUN, results):
        require(res["status"] == "ok", f"[dryrun] {arch} x {shape} {kw}: "
                f"{res.get('error')}")
        if kw.get("attn_shard"):
            require(res["attn_shard"] == kw["attn_shard"],
                    f"[dryrun] {arch} x {shape}: ran {res['attn_shard']}")
        if shape == "train_4k":
            require(res["client_placement"] == "dp"
                    and res["remat_policy"] == "dots"
                    and res["n_micro"] == 1,
                    f"[dryrun] {arch} x {shape}: {res['client_placement']}, "
                    f"{res['remat_policy']}, n_micro {res['n_micro']}")
        log(f"[dryrun] {arch} x {shape} x single {kw} (rank 0 of a fake "
            f"group of 256, meta tensors): memory {res['memory']}, flops "
            f"{res['cost']['flops']}, collectives {res['collectives']}; "
            f"trace {res['trace_s']} s, {res['wall_s']:.1f} s in the child")
    log(f"[dryrun] the child ran {time.perf_counter() - t0:.1f} s beside "
        f"the card's phases; waited {time.perf_counter() - t_wait:.1f} s "
        f"for it at the end")


def main():
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    sys.path.insert(0, str(ROOT / "src"))
    t_start = time.perf_counter()
    dev, smi = phase_device()
    start_rank_server()
    build_job = start_build()
    dry = start_dryrun()
    try:
        _phases(dev, smi, t_start, build_job, dry)
    finally:
        if dry[0].poll() is None:
            dry[0].kill()
            dry[0].wait()
        build_job[0].join()


def _phases(dev, smi, t_start, build_job, dry):
    errs = phase_kernels(dev)
    times = phase_times(dev, smi)
    _record_engine_stats()
    _stats_label("main")
    with _arena_recorder():
        launches, main_runs = phase_main_path()
    for label, phase in (("small", phase_small_vs_cpu),
                         ("rerun", phase_rerun)):
        _stats_label(label)
        phase()
    for label, phase in (("api", phase_api), ("legacy", phase_legacy),
                         ("robust", phase_robust)):
        _stats_label(label)
        phase(smi)
    _stats_label("modes")
    t_modes = time.perf_counter()
    sess = _modes_session()
    for phase in (phase_resume, phase_hostfed, phase_pipeline):
        t0 = time.perf_counter()
        phase(smi, main_runs, sess)
        log(f"[{phase.__name__[6:]}] phase wall "
            f"{time.perf_counter() - t0:.1f} s")
    del sess
    t0 = time.perf_counter()
    phase_tiered(smi)
    log(f"[tiered] phase wall {time.perf_counter() - t0:.1f} s; the run "
        f"modes took {time.perf_counter() - t_modes:.1f} s in all")
    _stats_label("breakdown")
    phase_breakdown(smi)
    _stats_label("mesh-main")
    t0 = time.perf_counter()
    mesh_launches = phase_mesh_main(smi, main_runs)
    for name, n in mesh_launches.items():
        launches[name] += n
    log(f"[mesh-main] phase wall {time.perf_counter() - t0:.1f} s")
    _stats_label(None)
    phase_analysis(smi)
    errs.update(phase_kernels_zoo(dev, build_job))
    times.update(phase_times_zoo(dev, smi))
    params, cfg, tokens, logits, toks, serve_launches = phase_serve(dev, smi)
    launches.update(serve_launches)
    phase_serve_small(dev)
    phase_serve_rerun(params, cfg, tokens, logits, toks)
    phase_serve_breakdown(params, cfg, tokens, smi)
    del params, tokens, logits, toks
    t0 = time.perf_counter()
    zoo_launches, first = phase_serve_zoo(dev, smi)
    launches["flash_decode"] += zoo_launches
    phase_serve_zoo_small(dev)
    phase_serve_zoo_rerun(dev, smi, first)
    log(f"[serve-zoo] the zoo phases took {time.perf_counter() - t0:.1f} s; "
        f"flash_decode launches: zamba2 {serve_launches['flash_decode']}, "
        f"zoo {zoo_launches}")
    _free_card()
    t0 = time.perf_counter()
    train_launches, _, train_refs = phase_train_zoo(dev, smi)
    t1 = time.perf_counter()
    launches["ssd_intra_chunk"] += train_launches
    phase_remat(smi)
    t_remat = time.perf_counter()
    phase_train_zoo_small(dev)
    t2 = time.perf_counter()
    phase_axes(smi)
    t3 = time.perf_counter()
    mesh_train_launches = phase_mesh_train(smi, train_refs)
    del train_refs
    launches["ssd_intra_chunk"] += mesh_train_launches
    t4 = time.perf_counter()
    mesh_model_launches = phase_mesh_model(smi, serve=True)
    for name, n in mesh_model_launches.items():
        launches[name] += n
    t5 = time.perf_counter()
    phase_dryrun(smi, dry)
    log(f"[train-zoo] phase walls: [train-zoo] {t1 - t0:.1f} s, [remat] "
        f"{t_remat - t1:.1f} s, "
        f"[train-zoo-small] {t2 - t_remat:.1f} s, [axes] {t3 - t2:.1f} s, "
        f"[mesh-train] {t4 - t3:.1f} s, [mesh-model] with [serve-mesh] "
        f"{t5 - t4:.1f} s, [dryrun] {time.perf_counter() - t5:.1f} s; "
        f"ssd_intra_chunk launches: serving "
        f"{serve_launches['ssd_intra_chunk']}, training {train_launches}, "
        f"the mesh's ranks {mesh_train_launches}, the model axis's ranks "
        f"(with [serve-mesh]) {mesh_model_launches}")
    from repro_torch.kernels.dp_clip import dp_clip
    from repro_torch.kernels.flash_attn import flash_attn
    from repro_torch.kernels.ssd_scan import ssd_scan
    kernels = [
        ("dp_clip_sqnorm", dp_clip.ROUTE,
         "src/repro_torch/kernels/dp_clip/dp_clip.py",
         "src/repro/kernels/dp_clip/dp_clip.py:88"),
        ("dp_clip_scale_mean", dp_clip.ROUTE,
         "src/repro_torch/kernels/dp_clip/dp_clip.py",
         "src/repro/kernels/dp_clip/dp_clip.py:104"),
        ("ssd_intra_chunk", ssd_scan.ROUTE,
         "src/repro_torch/kernels/csrc/ssd_intra_tc.cu",
         "src/repro/kernels/ssd_scan/ssd_scan.py:39"),
        ("flash_decode", flash_attn.ROUTE,
         "src/repro_torch/kernels/csrc/flash_decode.cu",
         "src/repro/kernels/flash_attn/flash_attn.py:61"),
    ]
    for _, _, source, _ in kernels:
        require((ROOT / source).exists(), f"missing kernel source {source}")
    kernels = [dict(name=name, route=route, source=source, replaces=replaces,
                    launches=launches[name], max_abs_err=errs[name],
                    **times[name])
               for name, route, source, replaces in kernels]
    log(f"[done] {time.perf_counter() - t_start:.1f} s in all")
    import torch
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
