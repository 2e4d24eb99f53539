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


@pytest.mark.parametrize("k,b,d", [(4, 128, 317124), (1, 1, 37),
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
