"""Chip smoke test of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Drives the port only (``src/repro_torch``; nothing of ``jax`` or the JAX
package ``repro``) and fails with a non-zero exit on the first problem:

1. device: requires CUDA, prints the card's name and power limit and the
   numerics flags;
2. kernels vs plain: the Triton ``dp_clip`` kernels (built here, at first
   launch, into ``build/triton``) against their plain PyTorch version on
   the card, at the main path's shapes (K in {1, 4}, B = 128,
   D = 317,124, with and without noise) and at awkward ones (B = 1, prime
   B and D, D below one block);
3. times at the main path's shape (CUDA events): kernel, plain version,
   one PyTorch library call, and the bytes/operations bound;
4. the main path at full width: FedAsync (staleness window with K > 1
   cohorts) and FedAvg through ``run_experiment`` with
   ``dp_path="pallas"`` on the paper's default CNN and corpus; kernel
   launches must equal S_max x cohorts per kernel;
5. a small-input check of the card's run against the CPU plain route
   (which the CPU tests hold to the JAX reference);
6. a bit-identical rerun;
7. where one full-width cohort's time goes (profiled cohort step, idle
   share, the fused step's stages).

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet, 700 W
F32_FLOPS = 67e12              # H100 SXM data sheet, f32 outside tensor cores

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
    shapes = [(1, 128, 317124), (4, 128, 317124),       # main path
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


def _time_ms(fn, iters=30):
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
    """Kernel / plain / library times at the main path's shape (K=4)."""
    import torch
    from repro_torch.kernels.dp_clip import dp_clip, ref
    k, b, d = 4, 128, 317124
    g, z = _inputs(k, b, d, 7, dev)
    flat = g.view(k * b, d)
    scales = ref.clip_scales(torch.sqrt(ref.sqnorms_ref(flat)), 1.0)
    std = torch.tensor([1.0 / b], device=dev)
    t = {}
    # in turns: kernel, plain, kernel, plain — keep the better of each
    for _ in range(2):
        t.setdefault("sq", []).append(_time_ms(lambda: dp_clip.sqnorms(flat)))
        t.setdefault("sq_plain", []).append(
            _time_ms(lambda: ref.sqnorms_ref(flat)))
        t.setdefault("mean", []).append(_time_ms(
            lambda: dp_clip.cohort_scale_mean(flat, scales, k=k,
                                              inv_b=1.0 / b, z=z, stddev=std)))
        t.setdefault("mean_plain", []).append(_time_ms(
            lambda: ref.cohort_scale_mean_ref(flat, scales, k=k,
                                              inv_b=1.0 / b, z=z, stddev=std)))
    t["sq_lib"] = [_time_ms(lambda: torch.linalg.vector_norm(flat, dim=1))]
    t["mean_lib"] = [_time_ms(lambda: torch.bmm(scales.view(k, 1, b), g))]
    best = {key: min(v) for key, v in t.items()}

    def bound(nbytes, flops):
        tb, tf = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS * 1e3
        return (tb, "bytes") if tb >= tf else (tf, "operations")

    sq_bound = bound(k * b * d * 4 + k * b * 4, 2 * k * b * d)
    mean_bound = bound(k * b * d * 4 + k * b * 4 + k * d * 4 + 4 + k * d * 4,
                       2 * k * b * d + 3 * k * d)
    log(f"[times] {smi}; K={k} B={b} D={d}: "
        f"sqnorm kernel {best['sq']:.4f} ms plain {best['sq_plain']:.4f} ms "
        f"library {best['sq_lib']:.4f} ms bound {sq_bound[0]:.4f} ms; "
        f"scale_mean kernel {best['mean']:.4f} ms plain "
        f"{best['mean_plain']:.4f} ms library {best['mean_lib']:.4f} ms "
        f"bound {mean_bound[0]:.4f} ms")
    return {
        "dp_clip_sqnorm": dict(ms=best["sq"], plain_ms=best["sq_plain"],
                               library_ms=best["sq_lib"],
                               bound_ms=sq_bound[0], bound_by=sq_bound[1]),
        "dp_clip_scale_mean": dict(ms=best["mean"],
                                   plain_ms=best["mean_plain"],
                                   library_ms=best["mean_lib"],
                                   bound_ms=mean_bound[0],
                                   bound_by=mean_bound[1]),
    }


def _check_run(params, log_, name):
    import torch
    from repro_torch.pytree import tree_leaves
    for leaf in tree_leaves(params):
        require(bool(torch.isfinite(leaf).all()), f"{name}: nonfinite params")
    info = log_.engine_stats["pallas_interpret"]
    require(info is not None and info["backend"] == "cuda"
            and info["kernel"] == "triton",
            f"{name}: engine_stats does not record the CUDA kernel: {info}")
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
    return launches


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
        "dp_clip op (2 Triton kernels + glue)":
            lambda: dp_clip_mean_noise_cohort(flat, 1.0, std, z),
        "batched Adam": lambda: clients[0].opt.update(grads, o, p),
        "eval: pooled-test accuracy": lambda: acc_fn(params, pooled),
    }
    for name, fn in stages.items():
        log(f"[breakdown] stage {name}: {_time_ms(fn, iters=5):.3f} ms")


def main():
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    sys.path.insert(0, str(ROOT / "src"))
    t_start = time.perf_counter()
    dev, smi = phase_device()
    errs = phase_kernels(dev)
    times = phase_times(dev, smi)
    launches = phase_main_path()
    phase_small_vs_cpu()
    phase_rerun()
    phase_breakdown(smi)
    replaces = {
        "dp_clip_sqnorm": "src/repro/kernels/dp_clip/dp_clip.py:88",
        "dp_clip_scale_mean": "src/repro/kernels/dp_clip/dp_clip.py:104",
    }
    kernels = [dict(
        name=name, route="triton",
        source="src/repro_torch/kernels/dp_clip/dp_clip.py",
        replaces=replaces[name], launches=launches[name],
        max_abs_err=errs[name], **times[name]) for name in replaces]
    log(f"[done] {time.perf_counter() - t_start:.1f} s in all")
    import torch
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
