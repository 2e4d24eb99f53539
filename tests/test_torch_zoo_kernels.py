"""The port's ``ssd_intra_chunk`` and ``flash_decode`` (plain route, on
the CPU) against the JAX package's Pallas kernels, run in interpret mode
as ``tests/test_kernels.py`` runs them, and against the JAX oracles.

Inputs are made with numpy from a seed and fed to both packages.
Tolerances: f32 as in ``tests/test_kernels.py`` (1e-4 for the SSD block,
whose q-term sums run in another order; 1e-5 for flash decode); bf16
against the JAX oracle at the bf16 tolerances of that file.
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attn.ops import flash_decode as r_flash
from repro.kernels.flash_attn.ref import flash_decode_ref as r_flash_ref
from repro.kernels.ssd_scan.ops import ssd_intra_chunk as r_ssd
from repro.kernels.ssd_scan.ref import ssd_intra_chunk_ref as r_ssd_ref

from repro_torch.kernels import build
from repro_torch.kernels.flash_attn import flash_attn as t_flash_launcher
from repro_torch.kernels.flash_attn import ops as t_flash_ops
from repro_torch.kernels.flash_attn.ref import flash_decode_ref
from repro_torch.kernels.ssd_scan import ops as t_ssd_ops
from repro_torch.kernels.ssd_scan import ssd_scan as t_ssd_launcher
from repro_torch.kernels.ssd_scan.ref import ssd_intra_chunk_ref

SSD_SHAPES = [(1, 2, 32, 2, 16, 16), (2, 4, 64, 4, 64, 64),
              (1, 1, 128, 8, 64, 32)]          # tests/test_kernels.py:221-226
FLASH_SHAPES = [(2, 128, 4, 4, 64, 0), (2, 256, 8, 2, 64, 0),
                (1, 512, 4, 4, 128, 128), (3, 384, 6, 2, 32, 100)]  # :164-172


def _ssd_inputs(b, c, q, h, p, n, seed=0):
    rng = np.random.default_rng(seed + q * h)
    xr = rng.standard_normal((b, c, q, h, p)).astype(np.float32)
    ar = (-np.abs(rng.standard_normal((b, h, c, q))) * 0.1).astype(np.float32)
    Br = rng.standard_normal((b, c, q, n)).astype(np.float32)
    Cr = rng.standard_normal((b, c, q, n)).astype(np.float32)
    return xr, ar, Br, Cr


def _flash_inputs(B, S, H, Hkv, Dh, seed=0, pos=None):
    rng = np.random.default_rng(seed + S + H)
    q = rng.standard_normal((B, H, Dh)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, Dh)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, Dh)).astype(np.float32)
    if pos is None:
        pos = rng.integers(S // 2, S, size=(B,))
    return q, k, v, np.asarray(pos, np.int32)


def _t(*arrays, dtype=None):
    out = [torch.from_numpy(a) for a in arrays]
    return [o.to(dtype) if dtype is not None and o.is_floating_point()
            else o for o in out]


# ---------------------------------------------------------------------------
# ssd_intra_chunk
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("against", ["pallas_interpret", "jnp_oracle"])
@pytest.mark.parametrize("shape", SSD_SHAPES, ids=str)
def test_ssd_intra_chunk_plain_matches_jax_f32(shape, against):
    xr, ar, Br, Cr = _ssd_inputs(*shape)
    fn = r_ssd if against == "pallas_interpret" else r_ssd_ref
    want = np.asarray(fn(*map(jnp.asarray, (xr, ar, Br, Cr))))
    got = t_ssd_ops.ssd_intra_chunk(*_t(xr, ar, Br, Cr))
    assert got.dtype == torch.float32 and got.shape == xr.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("shape", SSD_SHAPES, ids=str)
def test_ssd_intra_chunk_plain_matches_jax_oracle_bf16(shape):
    """bf16 inputs: the C.B^T scores round to bf16 in both packages; the
    plain route returns bf16 (the kernel's dtype), the JAX oracle f32, so
    the tolerance is bf16's, scaled by the output's size as in
    ``tests/test_kernels.py``."""
    xr, ar, Br, Cr = _ssd_inputs(*shape, seed=5)
    bf = [jnp.asarray(a).astype(jnp.bfloat16) for a in (xr, Br, Cr)]
    want = np.asarray(r_ssd_ref(bf[0], jnp.asarray(ar), bf[1], bf[2]),
                      np.float32)
    xt, at, bt, ct = _t(xr, ar, Br, Cr)
    got = t_ssd_ops.ssd_intra_chunk(xt.bfloat16(), at, bt.bfloat16(),
                                    ct.bfloat16())
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=5e-2,
                               atol=1e-2 * float(np.abs(want).max()))


def test_ssd_plain_route_is_the_ref_and_masks_before_exp():
    """The wrapper's CPU route is ref.py; a strongly decaying ``a`` (whose
    upper-triangle segment sums overflow exp) stays finite."""
    xr, ar, Br, Cr = _t(*_ssd_inputs(1, 2, 32, 2, 16, 16))
    ar = ar * 1e4
    got = t_ssd_ops.ssd_intra_chunk(xr, ar, Br, Cr)
    assert torch.isfinite(got).all()
    assert torch.equal(got, ssd_intra_chunk_ref(xr, ar, Br, Cr))


@pytest.mark.parametrize("bad", ["a_dtype", "a_layout", "B_shape",
                                 "C_dtype", "x_rank", "x_int"])
def test_ssd_wrapper_refuses_wrong_inputs(bad):
    xr, ar, Br, Cr = _t(*_ssd_inputs(1, 2, 32, 2, 16, 16))
    if bad == "a_dtype":
        ar = ar.double()
    elif bad == "a_layout":
        ar = ar.permute(0, 2, 3, 1)              # (b,c,q,h), not (b,h,c,q)
    elif bad == "B_shape":
        Br = Br[:, :, :16]
    elif bad == "C_dtype":
        Cr = Cr.bfloat16()
    elif bad == "x_rank":
        xr = xr[0]
    else:
        xr = xr.int()
    with pytest.raises(ValueError):
        t_ssd_ops.ssd_intra_chunk(xr, ar, Br, Cr)


def test_ssd_launcher_never_runs_a_cpu_tensor():
    """The CUDA launcher refuses a CPU tensor (no silent plain route)."""
    xr, ar, Br, Cr = _t(*_ssd_inputs(1, 2, 32, 2, 16, 16))
    n0 = t_ssd_launcher.launches()
    with pytest.raises(ValueError, match="CUDA"):
        t_ssd_launcher.ssd_intra_chunk(xr, ar, Br, Cr)
    assert t_ssd_launcher.launches() == n0


# ---------------------------------------------------------------------------
# flash_decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("against", ["pallas_interpret", "jnp_oracle"])
@pytest.mark.parametrize("B,S,H,Hkv,Dh,window", FLASH_SHAPES, ids=str)
def test_flash_decode_plain_matches_jax_f32(B, S, H, Hkv, Dh, window,
                                            against):
    q, k, v, pos = _flash_inputs(B, S, H, Hkv, Dh)
    args = [jnp.asarray(a) for a in (q, k, v, pos)]
    want = (r_flash(*args, window=window, ts=128)
            if against == "pallas_interpret"
            else r_flash_ref(*args, window=window))
    got = t_flash_ops.flash_decode(*_t(q, k, v, pos), window=window)
    assert got.dtype == torch.float32 and got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


# (B, S, H, Hkv, Dh, window, pos, ts): the zoo's decode shapes the Pallas
# tests do not reach: Dh 96 (phi-3-vision), GQA 3 (llama3.2-3b 24/8,
# smollm-360m 15/5) and Whisper's cross-attention over 1500 frames at
# pos = 1499 (the Pallas tile must divide S)
ZOO_FLASH_SHAPES = [(2, 256, 8, 8, 96, 0, None, 128),
                    (2, 384, 8, 2, 96, 100, None, 128),
                    (2, 256, 6, 2, 64, 0, None, 128),
                    (2, 256, 15, 5, 64, 0, None, 128),
                    (2, 1500, 4, 4, 64, 0, [1499, 1499], 500)]


@pytest.mark.parametrize("against", ["pallas_interpret", "jnp_oracle"])
@pytest.mark.parametrize("B,S,H,Hkv,Dh,window,pos,ts", ZOO_FLASH_SHAPES,
                         ids=str)
def test_flash_decode_plain_matches_jax_at_zoo_shapes(B, S, H, Hkv, Dh,
                                                      window, pos, ts,
                                                      against):
    q, k, v, pos = _flash_inputs(B, S, H, Hkv, Dh, seed=13, pos=pos)
    args = [jnp.asarray(a) for a in (q, k, v, pos)]
    want = (r_flash(*args, window=window, ts=ts)
            if against == "pallas_interpret"
            else r_flash_ref(*args, window=window))
    got = t_flash_ops.flash_decode(*_t(q, k, v, pos), window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_flash_decode_plain_softcap_matches_jax():
    q, k, v, _ = _flash_inputs(2, 128, 4, 4, 64, seed=7)
    q = q * 4
    pos = np.array([100, 64], np.int32)
    args = [jnp.asarray(a) for a in (q, k, v, pos)]
    want = r_flash(*args, softcap=50.0, ts=64)
    got = t_flash_ops.flash_decode(*_t(q, k, v, pos), softcap=50.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("case", ["pos0", "short_S", "ragged_S",
                                  "window_past_start", "window1"])
def test_flash_decode_plain_awkward_shapes_match_jax(case):
    """pos = 0, S below one tile, an S that is no multiple of any tile,
    and windows at the start of the cache (f32, 1e-5)."""
    B, S, H, Hkv, Dh, window, pos = {
        "pos0": (2, 128, 4, 2, 64, 0, [0, 0]),
        "short_S": (2, 20, 4, 4, 32, 0, [19, 7]),
        "ragged_S": (2, 2112 // 8 + 3, 8, 2, 64, 0, [266, 100]),
        "window_past_start": (2, 96, 4, 4, 64, 40, [10, 95]),
        "window1": (1, 64, 4, 1, 128, 1, [33]),
    }[case]
    q, k, v, pos = _flash_inputs(B, S, H, Hkv, Dh, seed=3, pos=pos)
    want = r_flash_ref(*[jnp.asarray(a) for a in (q, k, v, pos)],
                       window=window)
    got = t_flash_ops.flash_decode(*_t(q, k, v, pos), window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("B,S,H,Hkv,Dh,window", FLASH_SHAPES[:2], ids=str)
def test_flash_decode_plain_matches_jax_oracle_bf16(B, S, H, Hkv, Dh, window):
    q, k, v, pos = _flash_inputs(B, S, H, Hkv, Dh, seed=11)
    bf = [jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v)]
    want = np.asarray(r_flash_ref(*bf, jnp.asarray(pos), window=window),
                      np.float32)
    qt, kt, vt, pt = _t(q, k, v, pos, dtype=torch.bfloat16)
    got = t_flash_ops.flash_decode(qt, kt, vt, pt, window=window)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2e-2,
                               atol=2e-2)


@pytest.mark.parametrize("bad", ["pos_int64", "kv_dtype", "gqa_ratio",
                                 "v_shape", "q_rank"])
def test_flash_wrapper_refuses_wrong_inputs(bad):
    q, k, v, pos = _t(*_flash_inputs(2, 64, 4, 2, 64))
    if bad == "pos_int64":
        pos = pos.long()
    elif bad == "kv_dtype":
        k = k.bfloat16()
    elif bad == "gqa_ratio":
        q = q[:, :3]
    elif bad == "v_shape":
        v = v[:, :32]
    else:
        q = q[:, None]
    with pytest.raises(ValueError):
        t_flash_ops.flash_decode(q, k, v, pos)


def test_flash_launcher_never_runs_a_cpu_tensor():
    q, k, v, pos = _t(*_flash_inputs(2, 64, 4, 2, 64))
    n0 = t_flash_launcher.launches()
    with pytest.raises(ValueError, match="CUDA"):
        t_flash_launcher.flash_decode(q, k, v, pos)
    assert t_flash_launcher.launches() == n0
    assert torch.equal(t_flash_ops.flash_decode(q, k, v, pos),
                       flash_decode_ref(q, k, v, pos))


# ---------------------------------------------------------------------------
# the CUDA build (static checks: this machine has no nvcc)
# ---------------------------------------------------------------------------

def test_build_declares_every_c_entry_point_the_sources_define():
    defined = set()
    for src in build.CSRC.glob("*.cu"):
        defined |= set(re.findall(r'extern "C" [^(]*?(\w+)\(',
                                  src.read_text()))
    assert set(build.SIGNATURES) | {"repro_cuda_error_string"} == defined
    assert {p.name for p in build.CSRC.glob("*.cu")} == {
        "errors.cu", "flash_decode.cu", "ssd_intra.cu", "ssd_intra_tc.cu"}


def test_build_dir_is_keyed_by_sources_and_ignored_by_git():
    d = build.build_dir()
    root = build.CSRC.parents[3]
    assert d.parent == root / "build" / "cuda"
    assert "build/" in (root / ".gitignore").read_text().split()
    assert "sm_90a" in " ".join(build.COMPILE_FLAGS)
    assert d == build.build_dir()          # stable for unchanged sources


def test_kernel_modules_name_their_route():
    from repro_torch.kernels.common import kernel_info
    from repro_torch.kernels.dp_clip import dp_clip
    assert kernel_info("cuda", dp_clip, 3) == {
        "backend": "cuda", "kernel": "triton", "launches": 3}
    assert kernel_info("cuda", t_ssd_launcher, 1)["kernel"] == "cuda"
    assert kernel_info("cuda", t_flash_launcher, 1)["kernel"] == "cuda"
    assert kernel_info("cpu", t_flash_launcher, 0)["kernel"] == "plain"
