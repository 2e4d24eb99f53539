"""Tests of the PyTorch port that need the card (marked ``gpu``; they
skip on a machine without CUDA).  Run them on the GPU machine with

    python -m pytest -q -m gpu --noconftest -p no:cacheprovider tests/test_torch_gpu.py

(``--noconftest``: the suite's conftest imports the JAX package, which
the GPU machine does not have).  Nothing here imports ``jax``/``repro``.
"""
import pytest
import torch

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.device import resolve_device
    return resolve_device(None)


@pytest.mark.parametrize("k,b,d", [(4, 128, 317124), (2, 128, 317124),
                                   (1, 128, 317124), (1, 1, 37),
                                   (3, 13, 1031), (2, 7, 4096)])
@pytest.mark.parametrize("noise", [False, True])
def test_dp_clip_kernels_match_plain_on_card(cuda, k, b, d, noise):
    from repro_torch.kernels.dp_clip import dp_clip, ops, ref
    gen = torch.Generator(cuda).manual_seed(k * b + d)
    g = torch.randn((k, b, d), generator=gen, device=cuda) * (2.0 / d ** 0.5)
    g[:, : (b + 1) // 2] *= 3.0
    z = torch.randn((k, d), generator=gen, device=cuda)
    kw = dict(noise_stddev=1.0 / b, z=z) if noise else {}
    n0 = dp_clip.launches()
    got = ops.dp_clip_mean_noise_cohort(g, 1.0, **kw)
    want = ref.dp_clip_mean_noise_cohort_ref(g, 1.0, **kw)
    assert dp_clip.launches() == n0 + 2
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=0)
    assert torch.equal(got[2], want[2])
    # fixed-order sums: a relaunch is bit-identical
    again = ops.dp_clip_mean_noise_cohort(g, 1.0, **kw)
    assert all(torch.equal(a, b_) for a, b_ in zip(got, again))


@pytest.mark.parametrize("r,d", [(1, 317124), (13, 1031), (131, 4093),
                                 (3, 37), (256, 317124), (512, 317124)],
                         ids=str)
def test_sqnorms_kernel_matches_plain_on_card(cuda, r, d):
    """The split-D norms pass at R = 1, prime R and prime D and the main
    path's R = 256 and 512: within 1e-5 of the plain version (f32 sums in
    another order), one launch counted, and bit-identical on a rerun (the
    partials are added in split order)."""
    from repro_torch.kernels.dp_clip import dp_clip, ref
    gen = torch.Generator(cuda).manual_seed(r + d)
    flat = torch.randn((r, d), generator=gen, device=cuda) * (2.0 / d ** 0.5)
    n0 = dp_clip.sqnorm_launches
    got = dp_clip.sqnorms(flat)
    torch.cuda.synchronize()
    assert dp_clip.sqnorm_launches == n0 + 1
    torch.testing.assert_close(got, ref.sqnorms_ref(flat), rtol=1e-5, atol=0)
    assert torch.equal(got, dp_clip.sqnorms(flat))


def test_kernels_refuse_wrong_inputs_on_card(cuda):
    from repro_torch.kernels.dp_clip import dp_clip
    g = torch.zeros(6, 5, device=cuda)
    with pytest.raises(ValueError, match="float32"):
        dp_clip.sqnorms(g.double())
    with pytest.raises(ValueError, match="contiguous"):
        dp_clip.sqnorms(g.t())


def test_small_run_on_card_matches_cpu_route(cuda):
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
    kw = dict(max_updates=6, eval_every=3,
              engine_cfg=EngineConfig(staleness_window=1e9, max_cohort=2))
    p_g, l_g = run_experiment("fedasync", cfg, **kw)
    p_c, l_c = run_experiment("fedasync", cfg, device="cpu", **kw)
    assert l_g.update_counts == l_c.update_counts
    assert l_g.eps_trajectory == l_c.eps_trajectory
    assert l_g.engine_stats["pallas_interpret"]["kernel"] == "triton"
    assert l_g.engine_stats["pallas_interpret"]["launches"] > 0
    for a, b in zip(tree_leaves(p_g), tree_leaves(p_c)):
        torch.testing.assert_close(a.cpu(), b, rtol=0, atol=1e-2)


def _tiny_testbed(**kw):
    from repro_torch.core.testbed import TestbedConfig
    from repro_torch.data.synthetic_ser import SERDataConfig
    from repro_torch.models.ser_cnn import SERConfig
    dims = dict(time_frames=12, n_mels=12)
    return TestbedConfig(
        batch_size=16, seed=3, dp_path="pallas",
        data=SERDataConfig(n_total=360, **dims),
        model=SERConfig(channels1=8, channels2=16, fc_dim=32, **dims), **kw)


def test_local_train_launches_dp_clip_at_k1_matching_plain(cuda,
                                                           monkeypatch):
    """The legacy loop's client step: one K = 1 dp_clip call per local
    step, launched on the card, each agreeing with the plain version on
    the same inputs (1e-5: f32 sums in another order)."""
    from repro_torch.core.testbed import build_testbed
    from repro_torch.engine.cohort import steps_per_round
    from repro_torch.kernels.dp_clip import dp_clip, ops, ref
    real = ops.dp_clip_mean_noise_cohort
    seen = []

    def checked(g, clip, noise_stddev=None, z=None):
        out = real(g, clip, noise_stddev, z)
        want = ref.dp_clip_mean_noise_cohort_ref(g, clip, noise_stddev, z)
        torch.testing.assert_close(out[0], want[0], rtol=1e-5, atol=1e-6)
        seen.append(g.shape[0])
        return out

    monkeypatch.setattr(ops, "dp_clip_mean_noise_cohort", checked)
    clients, params, _, _ = build_testbed(_tiny_testbed(sigma=1.0), cuda)
    c = clients[0]
    n0 = (dp_clip.sqnorm_launches, dp_clip.scale_mean_launches)
    new, info = c.local_train(params, 1234)
    steps = steps_per_round(c.n_train, c.batch_size, c.local_epochs)
    assert info["dp_steps"] == steps == len(seen) > 0
    assert set(seen) == {1}
    assert (dp_clip.sqnorm_launches - n0[0],
            dp_clip.scale_mean_launches - n0[1]) == (steps, steps)
    for leaf in new.values():
        for v in leaf.values():
            assert v.device.type == "cuda" and torch.isfinite(v).all()


def test_screened_fedasync_on_card_matches_cpu_route(cuda):
    """Faults + screening: the same spec on the card and on the CPU gives
    equal fault events, screen counters and bookkeeping, and params
    within the CPU tests' run-level tolerance."""
    import dataclasses
    from repro_torch.api import ExperimentSpec, RunBudget, Session, \
        StrategySpec
    from repro_torch.core.faults import FaultModel
    from repro_torch.core.screening import ScreeningConfig
    from repro_torch.pytree import tree_leaves
    tb = dataclasses.replace(
        _tiny_testbed(sigma=0.0),
        faults=FaultModel(seed=1, failure_prob=0.1, upload_loss_prob=0.2,
                          late_prob=0.1, duplicate_prob=0.1, leave_prob=0.1,
                          corrupt_prob=0.3, corrupt_scale=50.0),
        screening=ScreeningConfig(max_update_norm=1.0, quarantine_after=2))
    spec = ExperimentSpec(testbed=tb, strategy=StrategySpec(
        "fedasync_normbound", alpha=0.4, norm_bound=0.1),
        run=RunBudget(max_updates=10, eval_every=5))
    p_g, l_g = Session().run(spec)
    p_c, l_c = Session(device="cpu").run(spec)
    for f in ("fault_events", "times", "update_counts", "staleness",
              "eps_trajectory", "cohort_sizes", "influence"):
        assert getattr(l_g, f) == getattr(l_c, f), f
    keys = [k for k in l_c.engine_stats if k.startswith(("fault_", "screen_"))]
    assert {k: l_g.engine_stats[k] for k in keys} == \
        {k: l_c.engine_stats[k] for k in keys}
    assert l_g.engine_stats["screen_rejections"] > 0
    assert l_g.engine_stats["pallas_interpret"]["kernel"] == "triton"
    for a, b in zip(tree_leaves(p_g), tree_leaves(p_c)):
        torch.testing.assert_close(a.cpu(), b, rtol=0, atol=1e-2)


# ---------------------------------------------------------------------------
# the zoo's CUDA C++ kernels: ssd_intra_chunk and flash_decode
# ---------------------------------------------------------------------------

# (b, c, q, h, p, n): zamba2-1.2b's prefill shape, then tests/test_kernels.py's,
# then ragged ones: q and n not multiples of 16 (element copies where n or
# p is not a multiple of 8), p of two 64-column chunks with n past 128
SSD_SHAPES = [(8, 16, 128, 64, 64, 64), (1, 2, 32, 2, 16, 16),
              (2, 4, 64, 4, 64, 64), (1, 1, 128, 8, 64, 32),
              (1, 1, 20, 2, 16, 12), (2, 3, 36, 3, 24, 40),
              (1, 2, 64, 2, 128, 160)]
# (B, S, H, Hkv, Dh, window, softcap, pos range): zamba2-1.2b's decode
# shape, then GQA, windows, softcap, S below one tile, ragged S, pos = 0
FLASH_CASES = [(8, 2112, 32, 32, 64, 0, 0.0, (2048, 2112)),
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


def _ssd_inputs(shape, dtype, dev, seed=0):
    b, c, q, h, p, n = shape
    gen = torch.Generator(dev).manual_seed(seed)
    xr = torch.randn((b, c, q, h, p), generator=gen, device=dev).to(dtype)
    ar = -torch.rand((b, h, c, q), generator=gen, device=dev) * 0.2
    Br = torch.randn((b, c, q, n), generator=gen, device=dev).to(dtype)
    Cr = torch.randn((b, c, q, n), generator=gen, device=dev).to(dtype)
    return xr, ar, Br, Cr


def _flash_inputs(case, dtype, dev, seed=0):
    B, S, H, Hkv, Dh, _, softcap, (lo, hi) = case
    gen = torch.Generator(dev).manual_seed(seed)
    q = torch.randn((B, H, Dh), generator=gen, device=dev)
    q = (q * (4.0 if softcap else 1.0)).to(dtype)
    k = torch.randn((B, S, Hkv, Dh), generator=gen, device=dev).to(dtype)
    v = torch.randn((B, S, Hkv, Dh), generator=gen, device=dev).to(dtype)
    pos = torch.randint(lo, hi, (B,), generator=gen, device=dev,
                        dtype=torch.int32)
    return q, k, v, pos


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", SSD_SHAPES, ids=str)
def test_ssd_intra_chunk_kernel_matches_plain_on_card(cuda, shape, dtype):
    """Tolerances of tests/test_kernels.py: f32 1e-4; bf16 rtol 5e-2 and
    atol 1e-2 * max|plain| (the plain version rounds C.B^T to bf16)."""
    from repro_torch.kernels.ssd_scan import ops, ref, ssd_scan
    xr, ar, Br, Cr = _ssd_inputs(shape, dtype, cuda)
    n0 = ssd_scan.launches()
    got = ops.ssd_intra_chunk(xr, ar, Br, Cr)
    torch.cuda.synchronize()
    assert ssd_scan.launches() == n0 + 1
    assert got.dtype == dtype and got.shape == xr.shape
    want = ref.ssd_intra_chunk_ref(xr, ar, Br, Cr)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    else:
        torch.testing.assert_close(got.float(), want, rtol=5e-2,
                                   atol=1e-2 * float(want.abs().max()))
    assert torch.equal(got, ops.ssd_intra_chunk(xr, ar, Br, Cr))  # rerun


@pytest.mark.parametrize(
    "case,dtype", [(c, d) for c in FLASH_CASES
                   for d in (torch.float32, torch.bfloat16)
                   if not (c[6] and d == torch.bfloat16)], ids=str)
def test_flash_decode_kernel_matches_plain_on_card(cuda, case, dtype):
    """Tolerances of tests/test_kernels.py: 1e-5 in f32, 2e-2 in bf16.
    The softcap case runs in f32 only, as there: its q is scaled by 4,
    and the plain version's bf16 logits are then off by more than 2e-2
    (the kernel computes them in f32)."""
    from repro_torch.kernels.flash_attn import flash_attn, ops, ref
    q, k, v, pos = _flash_inputs(case, dtype, cuda)
    window, softcap = case[5], case[6]
    n0 = flash_attn.launches()
    got = ops.flash_decode(q, k, v, pos, window=window, softcap=softcap)
    torch.cuda.synchronize()
    assert flash_attn.launches() == n0 + 1
    want = ref.flash_decode_ref(q, k, v, pos, window=window, softcap=softcap)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    again = ops.flash_decode(q, k, v, pos, window=window, softcap=softcap)
    assert torch.equal(got, again)


# (B, S, H, Hkv, Dh, window, softcap, pos range): the zoo's decode shapes
# (gemma2-2b's local and global layers past its 4096 window, phi-3-vision
# at Dh 96, GQA 3 of llama3.2-3b and smollm-360m, deepseek's 56/8, the
# MoE models, Whisper's self- and cross-attention at pos = F - 1), then
# Dh 96 at every heads-per-block count with a window, softcap and pos 0.
# q is not scaled here, so the softcap cases run in bf16 as well.
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


@pytest.mark.parametrize(
    "case,dtype", [(c, d) for c in ZOO_FLASH_CASES
                   for d in (torch.float32, torch.bfloat16)], ids=str)
def test_flash_decode_kernel_matches_plain_at_zoo_shapes(cuda, case, dtype):
    """As above (1e-5 in f32, 2e-2 in bf16), with q unscaled."""
    from repro_torch.kernels.flash_attn import flash_attn, ops, ref
    q, k, v, pos = _flash_inputs(case[:6] + (0.0, case[7]), dtype, cuda)
    kw = dict(window=case[5], softcap=case[6])
    n0 = flash_attn.launches()
    got = ops.flash_decode(q, k, v, pos, **kw)
    torch.cuda.synchronize()
    assert flash_attn.launches() == n0 + 1
    want = ref.flash_decode_ref(q, k, v, pos, **kw)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    assert torch.equal(got, ops.flash_decode(q, k, v, pos, **kw))


def test_cuda_kernels_refuse_wrong_inputs_on_card(cuda):
    from repro_torch.kernels.flash_attn import flash_attn
    from repro_torch.kernels.ssd_scan import ssd_scan
    xr, ar, Br, Cr = _ssd_inputs((1, 2, 32, 2, 16, 16), torch.float32, cuda)
    with pytest.raises(ValueError, match="dtype"):
        ssd_scan.ssd_intra_chunk(xr.double(), ar, Br, Cr)
    with pytest.raises(ValueError, match="shape"):
        ssd_scan.ssd_intra_chunk(xr, ar[:, :, :1], Br, Cr)
    with pytest.raises(ValueError, match="contiguous"):
        ssd_scan.ssd_intra_chunk(xr, ar, Br.transpose(-1, -2).contiguous()
                                 .transpose(-1, -2), Cr)
    with pytest.raises(ValueError, match="lies on"):
        ssd_scan.ssd_intra_chunk(xr, ar.cpu(), Br, Cr)
    with pytest.raises(ValueError, match="multiples of 4"):
        ssd_scan.ssd_intra_chunk(*_ssd_inputs((1, 1, 30, 2, 16, 16),
                                              torch.float32, cuda))
    q, k, v, pos = _flash_inputs(FLASH_CASES[1], torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="dtype"):
        flash_attn.flash_decode(q, k, v, pos.long())
    with pytest.raises(ValueError, match="dtype"):
        flash_attn.flash_decode(q.float(), k, v, pos)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attn.flash_decode(q, k.transpose(1, 2).contiguous()
                                .transpose(1, 2), v, pos)
    with pytest.raises(ValueError, match="lies on"):
        flash_attn.flash_decode(q, k, v.cpu(), pos)
    with pytest.raises(ValueError, match="head dim"):
        flash_attn.flash_decode(q[..., :48].contiguous(),
                                k[..., :48].contiguous(),
                                v[..., :48].contiguous(), pos)


def test_reduced_hybrid_on_card_matches_cpu_route(cuda):
    """The reduced zamba2 (one segment, one trailing layer, f32) on the card
    (both CUDA kernels) vs the CPU plain route, same weights: prefill and
    4 decode logits within 1e-3 (f32 with the kernels' own summation
    order; the CPU route is held to the JAX package at 1e-4), the same
    greedy tokens, and one launch per Mamba2 layer / shared block."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attn import flash_attn
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.models import hybrid
    from repro_torch.pytree import tree_map
    cfg = get_config("zamba2-1.2b").reduced().replace(
        param_dtype="float32", n_layers=3)
    p_cpu = hybrid.init_params(cfg, seed=0, device="cpu")
    p_gpu = tree_map(lambda t: t.to(cuda), p_cpu)
    toks = torch.randint(0, cfg.vocab, (2, 64), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(0))
    outs = {}
    for dev, params in (("cpu", p_cpu), (cuda, p_gpu)):
        ssd_scan.reset_launches()
        flash_attn.reset_launches()
        cache = hybrid.init_cache(cfg, 2, 68, device=dev)
        lg, cache = hybrid.prefill(params, {"tokens": toks.to(dev)}, cfg,
                                   cache)
        seq = [lg.cpu()]
        for t in range(4):
            tok = lg.argmax(-1).to(torch.int32)[:, None]
            pos = torch.full((2,), 64 + t, dtype=torch.int32, device=dev)
            lg, cache = hybrid.decode_step(params, cache, tok, pos, cfg)
            seq.append(lg.cpu())
        outs[str(dev)] = (seq, ssd_scan.launches(), flash_attn.launches())
    (cpu_seq, cpu_ssd, cpu_fl), (gpu_seq, gpu_ssd, gpu_fl) = outs.values()
    assert (cpu_ssd, cpu_fl) == (0, 0) and (gpu_ssd, gpu_fl) == (3, 4)
    for a, b in zip(gpu_seq, cpu_seq):
        torch.testing.assert_close(a, b, rtol=1e-3, atol=1e-3)
        assert torch.equal(a.argmax(-1), b.argmax(-1))


# ---------------------------------------------------------------------------
# the engine's run modes on the card: pipelined, host-fed, tiered, resumed
# ---------------------------------------------------------------------------

def _mode_run(dev, engine=None, **kw):
    """The tiny testbed through the engine on ``dev``: FedAsync, 12
    updates, K = 2 cohorts."""
    from repro_torch.core.aggregation import FedAsync
    from repro_torch.core.testbed import TestbedConfig, build_testbed
    from repro_torch.data.synthetic_ser import SERDataConfig
    from repro_torch.engine.engine import EngineConfig, run_async_engine
    from repro_torch.models.ser_cnn import SERConfig
    dims = dict(time_frames=12, n_mels=12)
    cfg = TestbedConfig(
        batch_size=16, sigma=0.5, dp_path="pallas", seed=3,
        data=SERDataConfig(n_total=360, **dims),
        model=SERConfig(channels1=8, channels2=16, fc_dim=32, **dims))
    clients, params, acc_fn, pooled = build_testbed(cfg, device=dev)
    ecfg = EngineConfig(staleness_window=30.0, max_cohort=2,
                        **(engine or {}))
    return run_async_engine(clients, params, acc_fn, pooled,
                            FedAsync(alpha=0.4), max_updates=12,
                            eval_every=4, seed=cfg.seed, engine_cfg=ecfg,
                            **kw)


def _bitwise(a, b):
    from repro_torch.pytree import tree_leaves
    return all(torch.equal(x, y) for x, y in zip(tree_leaves(a),
                                                 tree_leaves(b)))


_LOG = ("times", "global_acc", "update_counts", "staleness",
        "eps_trajectory", "influence", "cohort_sizes", "local_acc")


@pytest.mark.parametrize("mode", [
    dict(pipeline_depth=2), dict(device_arena=False),
    dict(pipeline_depth=2, device_arena=False),
    dict(pipeline_depth=2, store={"hot_slots": 2, "lookahead": 2}),
    dict(store={"hot_slots": 3, "lookahead": 0})], ids=str)
def test_engine_modes_on_card_equal_serial_bitwise(cuda, mode):
    """Every mode runs the dp_clip kernels and equals the serial
    all-resident run on the card bit for bit; the pipelined ones make no
    host sync between evals."""
    from repro_torch.engine.statestore import StoreConfig
    from repro_torch.kernels.dp_clip import dp_clip
    mode = dict(mode)
    if "store" in mode:
        mode["store"] = StoreConfig(**mode["store"])
    p0, l0 = _mode_run(cuda)
    n0 = dp_clip.launches()
    p1, l1 = _mode_run(cuda, mode)
    assert dp_clip.launches() > n0
    assert l1.engine_stats["pallas_interpret"]["kernel"] == "triton"
    assert _bitwise(p0, p1)
    for f in _LOG:
        assert getattr(l0, f) == getattr(l1, f), f
    st = l1.engine_stats
    if mode.get("pipeline_depth", 1) > 1:
        assert st["host_syncs_between_evals"] == 0
        assert st["blocking_submits"] == 0
    if "store" in mode:
        assert st["store_fetches"] == (st["store_hot_hits"]
                                       + st["store_prefetch_hits"]
                                       + st["store_stall_waits"])
        assert st["store_evictions"] > 0 and st["store_sync_reads"] > 0


@pytest.mark.parametrize("tiered", [False, True], ids=["resident", "tiered"])
def test_resume_on_card_bit_identical(cuda, tmp_path, tiered):
    from repro_torch.engine.resilience import CheckpointPolicy, SimulatedCrash
    from repro_torch.engine.statestore import StoreConfig
    mode = (dict(pipeline_depth=2, store=StoreConfig(hot_slots=2,
                                                     lookahead=2))
            if tiered else {})
    p0, l0 = _mode_run(cuda, mode)
    with pytest.raises(SimulatedCrash):
        _mode_run(cuda, mode, checkpoint=CheckpointPolicy(
            str(tmp_path), every=4, crash_after_saves=2))
    p1, l1 = _mode_run(cuda, mode, resume_from=str(tmp_path))
    assert _bitwise(p0, p1)
    for f in _LOG:
        assert getattr(l0, f) == getattr(l1, f), f
    drop = ("drain_waits",)
    assert ({k: v for k, v in l0.engine_stats.items() if k not in drop}
            == {k: v for k, v in l1.engine_stats.items() if k not in drop})
