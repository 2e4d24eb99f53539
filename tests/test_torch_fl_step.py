"""The port's production round (``repro_torch.core.fl_step``) against the
JAX package's, its gradient pieces and the kernels' autograd rules.

* ``tests/test_fl_step.py``'s six tests, ported: ``split_batch``'s layout
  and messages, the step's bad-batch message, the local phase's step
  count from the batch and its ``n_steps`` mask, and the microbatch
  divisor from the batch.
* The client-level round against ``repro.core.fl_step.make_fl_train_step``
  on a hybrid and a dense reduced config, the reference's noise injected
  (``test_torch_train_zoo.py`` has the per-microbatch round on all ten):
  with ``server_opt="sgd"`` at ``server_lr=1`` the new master is master +
  Delta, held at 1e-5 element by element, so the client-level clip, the
  one noise draw per leaf and the weighted mean are each held; with
  FedAdam, ``delta_norm`` within 1e-5 and the params within 1e-6 on every
  entry whose reference Delta exceeds 1e-4 (there the sign, and so Adam's
  first step of about +-lr, is stable; near zero a ~1e-7 difference may
  flip it, ROADMAP.md queue 3), which must be at least 99% of them.
* The bf16 round (clients in bfloat16 from the f32 master, per-microbatch
  DP, SGD at lr 1) on the same two configs and on one config of each
  other family (the MoE router and the xLSTM gates, f32 at init, are
  bf16 in a client and promoted to f32 in their products, as the JAX
  package's are): each leaf's Delta within 5e-3 relative L2 of the
  reference's.  bf16 rounding alone moves Delta by 8.5e-3 (dense) to
  0.15 (hybrid) from the f32 round's in either package, and the two
  packages' bf16 rounds agree to 9.1e-4 (3.3e-3 for xlstm).
* ``ssd_intra_chunk_bwd_ref`` against ``jax.vjp`` of the JAX package's
  plain SSD block and against autograd of the port's, at 1e-5; the
  ``autograd.Function`` of the CUDA route wired to it (its forward stood
  in by the plain version, which is what it is held to on the card).
* ``check_no_grad`` raises, and the ``flash_decode`` and ``dp_clip``
  CUDA wrappers call it.
"""
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fl_step as r_fl
from repro.kernels.ssd_scan.ref import ssd_intra_chunk_ref as r_ssd_ref

from repro_torch.core.dp import DPConfig, clip_tree
from repro_torch.core.fl_step import (
    FLStepConfig, loss_grad, make_fl_train_step, make_local_phase,
    make_server_optimizer, split_batch)
from repro_torch.kernels import common
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.kernels.ssd_scan.ref import (
    ssd_intra_chunk_bwd_ref, ssd_intra_chunk_ref)
from repro_torch.pytree import tree_leaves

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
import test_torch_train_zoo as Z  # noqa: E402

_NOCLIP = DPConfig(clip_norm=1e9, noise_multiplier=0.0,
                   granularity="per_microbatch")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


# ---------------------------------------------------------------------------
# tests/test_fl_step.py, ported
# ---------------------------------------------------------------------------

def test_split_batch_layout():
    y = split_batch(torch.zeros((24, 5)), G=2, n_local=3, n_micro=2)
    assert y.shape == (2, 3, 2, 2, 5)


def test_split_batch_rejects_indivisible_global_batch():
    with pytest.raises(ValueError, match=r"num_clients G=3"):
        split_batch(torch.zeros((20, 5)), G=3, n_local=1, n_micro=2)


def test_split_batch_rejects_indivisible_per_client_slice():
    with pytest.raises(ValueError, match=r"n_local\*n_micro = 2\*3") as e:
        split_batch(torch.zeros((20, 5)), G=2, n_local=2, n_micro=3)
    with pytest.raises(ValueError) as ref:
        r_fl.split_batch(jnp.zeros((20, 5)), G=2, n_local=2, n_micro=3)
    assert str(e.value) == str(ref.value)


def test_fl_train_step_names_bad_batch_config():
    """The step raises the ValueError before any work, naming the
    offending shape and config values."""
    fl = FLStepConfig(num_clients=2, n_local=2, n_micro=2, dp=_NOCLIP)

    def loss(p, b):
        return torch.mean((b["x"] @ p["w"]) ** 2)

    params = {"w": torch.ones((4, 2))}
    step = make_fl_train_step(loss, fl)
    opt_state = make_server_optimizer(fl).init(params)
    batch = {"x": torch.zeros((12, 4))}    # 12/G=6 not divisible by 2*2
    with pytest.raises(ValueError, match=r"global batch 12 over G=2"):
        step(params, opt_state, batch, torch.ones((2,)) / 2, 0)


def test_local_phase_step_count_from_batch_and_mask():
    """make_local_phase takes its step count from the batch's leading dim
    and n_steps masks trailing steps without touching params — the cohort
    engine pads every member to a common step count this way."""
    fl = FLStepConfig(num_clients=1, n_local=3, n_micro=1, local_lr=0.1,
                      dp=_NOCLIP)

    def loss(p, b):
        return torch.mean((p["w"] - b["x"]) ** 2)

    lp = make_local_phase(loss, fl)
    params = {"w": torch.zeros((3,))}
    gen = torch.Generator().manual_seed(0)
    batch3 = {"x": torch.ones((3, 1, 2, 3))}   # (n_local, n_micro, per, feat)
    full = lp(params, batch3, gen)
    masked = lp(params, batch3, gen, n_steps=2)
    ref2 = lp(params, {"x": torch.ones((2, 1, 2, 3))}, gen)
    np.testing.assert_allclose(masked["w"].numpy(), ref2["w"].numpy(),
                               rtol=1e-6)
    assert not np.allclose(full["w"].numpy(), masked["w"].numpy())


def test_local_phase_micro_divisor_from_batch():
    """Both divisors (the accumulated gradients' and the Eq. 5 noise
    stddev's) come from the batch's microbatch dim, not from
    ``fl.n_micro``: two configs differing only in ``n_micro`` give the
    same update from the same batch and noise, and with noise off the
    update is local_lr times the mean of the 2 clipped microbatch grads."""
    def loss(p, b):
        return torch.mean((p["w"] - b["x"]) ** 2)

    params = {"w": torch.zeros((3,))}
    batch = {"x": torch.linspace(-1.0, 1.0, 12).reshape(1, 2, 2, 3)}
    dp = DPConfig(clip_norm=0.5, noise_multiplier=1.3,
                  granularity="per_microbatch")
    out = {}
    for n_micro in (2, 8):       # 8 disagrees with the batch's 2
        fl = FLStepConfig(num_clients=1, n_local=1, n_micro=n_micro,
                          local_lr=0.1, dp=dp)
        out[n_micro] = make_local_phase(loss, fl)(
            params, batch, torch.Generator().manual_seed(1))
    np.testing.assert_allclose(out[2]["w"].numpy(), out[8]["w"].numpy(),
                               rtol=1e-6)
    fl0 = FLStepConfig(num_clients=1, n_local=1, n_micro=8, local_lr=0.1,
                       dp=DPConfig(clip_norm=0.5, noise_multiplier=0.0,
                                   granularity="per_microbatch"))
    got = make_local_phase(loss, fl0)(params, batch,
                                      torch.Generator().manual_seed(1))
    acc = torch.zeros((3,))
    for m in range(2):
        g = loss_grad(loss, params, {"x": batch["x"][0, m]})
        acc = acc + clip_tree(g, 0.5)[0]["w"]
    np.testing.assert_allclose(got["w"].numpy(), (-0.1 * acc / 2).numpy(),
                               rtol=1e-5, atol=1e-7)


# ---------------------------------------------------------------------------
# the round against the JAX package's
# ---------------------------------------------------------------------------

def test_local_phase_matches_reference_with_its_noise():
    """A toy model's local phase, 2 steps x 2 microbatches, DP on, the
    reference's draws injected: equal to the JAX local phase at 1e-6."""
    dp = dict(clip_norm=0.5, noise_multiplier=1.3,
              granularity="per_microbatch")
    from repro.core.dp import DPConfig as RDPConfig
    rng = np.random.default_rng(0)
    w0 = rng.standard_normal((4, 3)).astype(np.float32)
    x = rng.standard_normal((2, 2, 3, 4)).astype(np.float32)

    def r_loss(p, b):
        return jnp.mean(jnp.tanh(b["x"] @ p["w"]) ** 2)

    def t_loss(p, b):
        return torch.mean(torch.tanh(b["x"] @ p["w"]) ** 2)

    key = jax.random.PRNGKey(3)
    r_out = r_fl.make_local_phase(r_loss, r_fl.FLStepConfig(
        num_clients=1, local_lr=0.3, dp=RDPConfig(**dp)))(
        {"w": jnp.asarray(w0)}, {"x": jnp.asarray(x)}, key)
    step_keys = jax.random.split(key, 2)

    def source(step, leaf, shape):
        return np.array(jax.random.normal(
            jax.random.split(step_keys[step], 1)[leaf], shape))

    t_out = make_local_phase(t_loss, FLStepConfig(
        num_clients=1, local_lr=0.3, dp=DPConfig(**dp)))(
        {"w": torch.from_numpy(w0)}, {"x": torch.from_numpy(x)}, source)
    np.testing.assert_allclose(t_out["w"].numpy(), np.asarray(r_out["w"]),
                               rtol=1e-6, atol=1e-6)


# client-level clipping and noise, and the compute dtype, do not depend on
# the family: one hybrid and one dense config
ROUND_ARCHS = ("zamba2-1.2b", "smollm-360m")
# the other families' bf16 rounds (the Whisper and VLM stub inputs in bf16)
BF16_ARCHS = ROUND_ARCHS + ("olmoe-1b-7b", "qwen2-moe-a2.7b", "xlstm-350m",
                            "whisper-large-v3", "phi-3-vision-4.2b")
ADAM_STABLE = 1e-4      # |reference Delta| above which Adam's sign holds
BF16_TOL = 5e-3         # per-leaf relative L2 of the bf16 round's Delta
_ROUNDS = {}


def _round(*key):
    """``Z.run_both(*key)``, once per key in this module."""
    if key not in _ROUNDS:
        _ROUNDS[key] = Z.run_both(*key)
    return _ROUNDS[key]


def _deltas(master, p0):
    """Each leaf's ``master - p0`` as numpy, ``master`` from either
    package (both flatten dicts in sorted-key order)."""
    return [np.asarray(a.detach() if torch.is_tensor(a) else a) - b.numpy()
            for a, b in zip(tree_leaves(master), tree_leaves(p0))]


@pytest.mark.parametrize("arch", ROUND_ARCHS)
def test_client_level_round_matches_reference(arch):
    """SGD at lr 1: master + Delta within 1e-5 of the JAX round's element
    by element, the round moved the params, and the metrics agree."""
    r_master, t_master, r_met, t_met, p0 = _round(
        arch, "client_level", "sgd", 1.0)
    Z.assert_tree_close(r_master, t_master, Z.TOL)
    assert max(float(np.abs(d).max()) for d in _deltas(t_master, p0)) > 1e-3
    np.testing.assert_allclose(float(t_met["delta_norm"]),
                               float(r_met["delta_norm"]), rtol=1e-5)
    assert float(t_met["weight_sum"]) == pytest.approx(1.0)


@pytest.mark.parametrize("arch", ROUND_ARCHS)
def test_client_level_round_with_fedadam_matches_reference(arch):
    """FedAdam on the same Delta (the SGD round's, same key and noise):
    ``delta_norm`` within 1e-5, and the params within 1e-6 wherever the
    reference's Delta is far enough from zero for Adam's first step to
    keep its sign."""
    r_master, t_master, r_met, t_met, p0 = _round(
        arch, "client_level", "adam", 1e-3)
    np.testing.assert_allclose(float(t_met["delta_norm"]),
                               float(r_met["delta_norm"]), rtol=1e-5)
    r_sgd = _round(arch, "client_level", "sgd", 1.0)[0]
    stable = [np.abs(d) > ADAM_STABLE for d in _deltas(r_sgd, p0)]
    n_stable = sum(int(m.sum()) for m in stable)
    assert n_stable >= 0.99 * sum(m.size for m in stable)
    moved = 0.0
    for a, b, m, p in zip(jax.tree_util.tree_leaves(r_master),
                          tree_leaves(t_master), stable, tree_leaves(p0)):
        got, want = b.detach().numpy(), np.asarray(a)
        np.testing.assert_allclose(got[m], want[m], rtol=0, atol=1e-6)
        moved = max(moved, float(np.abs(got - p.numpy()).max()))
    assert moved == pytest.approx(1e-3, rel=1e-2)   # Adam's step is ~lr


@pytest.mark.parametrize("arch", BF16_ARCHS)
def test_bf16_round_matches_reference(arch):
    """Clients in bf16 from the f32 master (the launcher's full-width
    dtype), per-microbatch DP with the reference's noise, SGD at lr 1:
    each leaf's Delta within ``BF16_TOL`` relative L2 of the JAX round's,
    and ``delta_norm`` within 1e-5."""
    r_master, t_master, r_met, t_met, p0 = _round(
        arch, "per_microbatch", "sgd", 1.0, "bfloat16")
    for i, (t, r) in enumerate(zip(_deltas(t_master, p0),
                                   _deltas(r_master, p0))):
        assert np.isfinite(t).all()
        rel = np.linalg.norm(t - r) / np.linalg.norm(r)
        assert rel <= BF16_TOL, f"{arch} leaf {i}: {rel:.3e}"
    np.testing.assert_allclose(float(t_met["delta_norm"]),
                               float(r_met["delta_norm"]), rtol=1e-5)


def test_shardings_are_the_distributed_half():
    """Shardings on a mesh over no process group (W = 1) change nothing:
    the round is bit for bit the unsharded one.  A mesh with a model
    axis above 1 is taken (here it then wants the mesh's two ranks;
    ``tests/test_torch_model_axis.py`` and
    ``tests/test_torch_model_axis_zoo.py`` run it on them)."""
    from repro_torch.launch.mesh import HostMesh, make_host_mesh
    from repro_torch.launch.shardings import tree_shardings
    fl = FLStepConfig(num_clients=2, n_micro=1, local_lr=0.1, dp=DPConfig(
        clip_norm=0.5, noise_multiplier=1.0, granularity="per_microbatch"),
        compute_dtype="float32")

    class Cfg:
        family, d_model, d_ff, vocab = "dense", 4, 0, 7
        n_heads = n_kv_heads = head_dim = 0

    def loss(p, b):
        return torch.mean((b["x"] @ p["w"]) ** 2)

    params = {"w": torch.linspace(-1.0, 1.0, 8).reshape(4, 2)}
    batch = {"x": torch.linspace(0.0, 1.0, 16).reshape(4, 4)}
    out = []
    for mesh in (None, make_host_mesh()):
        sh = (None if mesh is None
              else tree_shardings(params, Cfg, mesh, role="master"))
        step = make_fl_train_step(loss, fl, client_shardings=sh and {
            "w": type(sh["w"])(mesh, ("data", None, None))},
            master_shardings=sh)
        out.append(step(params, make_server_optimizer(fl).init(params),
                        batch, torch.ones(2) / 2, 3))
    assert torch.equal(out[0][0]["w"], out[1][0]["w"])
    assert torch.equal(out[0][2]["delta_norm"], out[1][2]["delta_norm"])
    model2 = tree_shardings(params, Cfg, HostMesh(1, 2, world=1),
                            role="master")
    with pytest.raises(ValueError, match="spans 2 of the process group's 1"):
        make_fl_train_step(loss, fl, master_shardings=model2)


def test_round_draws_from_per_client_generators_reproducibly():
    """An int key seeds the round's generators: the same key gives the
    same bits, another key other noise."""
    fl = FLStepConfig(num_clients=2, n_micro=1, compute_dtype="float32",
                      dp=DPConfig(1.0, 1.0, "per_microbatch"))

    def loss(p, b):
        return torch.mean((b["x"] @ p["w"]) ** 2)

    params = {"w": torch.ones((4, 2))}
    step = make_fl_train_step(loss, fl)
    batch = {"x": torch.ones((4, 4))}
    w = torch.ones(2) / 2
    outs = [step(params, make_server_optimizer(fl).init(params), batch, w,
                 key)[0]["w"] for key in (5, 5, 6)]
    assert torch.equal(outs[0], outs[1])
    assert not torch.equal(outs[0], outs[2])


# ---------------------------------------------------------------------------
# the SSD block's backward and the kernels' autograd rules
# ---------------------------------------------------------------------------

def _ssd_inputs(seed=0, shape=(2, 3, 16, 4, 8, 6)):
    b, c, q, h, p, n = shape
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, c, q, h, p)).astype(np.float32),
            -rng.random((b, h, c, q)).astype(np.float32),
            rng.standard_normal((b, c, q, n)).astype(np.float32) / 2,
            rng.standard_normal((b, c, q, n)).astype(np.float32) / 2,
            rng.standard_normal((b, c, q, h, p)).astype(np.float32))


def test_ssd_backward_matches_jax_vjp_and_autograd():
    xr, ar, Br, Cr, dY = _ssd_inputs()
    _, vjp = jax.vjp(r_ssd_ref, *map(jnp.asarray, (xr, ar, Br, Cr)))
    want = vjp(jnp.asarray(dY))
    got = ssd_intra_chunk_bwd_ref(*map(torch.from_numpy, (xr, ar, Br, Cr,
                                                          dY)))
    ts = [torch.from_numpy(a).requires_grad_() for a in (xr, ar, Br, Cr)]
    auto = torch.autograd.grad(ssd_intra_chunk_ref(*ts), ts,
                               torch.from_numpy(dY))
    for name, g, w, a in zip(("dxr", "dar", "dBr", "dCr"), got, want, auto):
        assert g.dtype == torch.float32 and g.shape == a.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5, err_msg=name)
        np.testing.assert_allclose(g.numpy(), a.numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=name)


def test_ssd_backward_returns_each_input_dtype():
    xr, ar, Br, Cr, dY = map(torch.from_numpy, _ssd_inputs(1))
    bf = torch.bfloat16
    got = ssd_intra_chunk_bwd_ref(xr.to(bf), ar, Br.to(bf), Cr.to(bf),
                                  dY.to(bf))
    assert [g.dtype for g in got] == [bf, torch.float32, bf, bf]


def test_ssd_function_backward_is_the_closed_form(monkeypatch):
    """The CUDA route's ``autograd.Function``: with its kernel stood in by
    the plain forward, its gradients equal native autograd of the plain
    version, and its forward's value is the kernel's (grad mode changes
    no number)."""
    monkeypatch.setattr(ssd_scan, "ssd_intra_chunk",
                        lambda *a: ssd_intra_chunk_ref(*a))
    xr, ar, Br, Cr, dY = map(torch.from_numpy, _ssd_inputs(2))
    ts = [t.clone().requires_grad_() for t in (xr, ar, Br, Cr)]
    y = ssd_ops.SSDIntraChunk.apply(*ts)
    assert torch.equal(y.detach(), ssd_intra_chunk_ref(xr, ar, Br, Cr))
    got = torch.autograd.grad(y, ts, dY)
    us = [t.clone().requires_grad_() for t in (xr, ar, Br, Cr)]
    want = torch.autograd.grad(ssd_intra_chunk_ref(*us), us, dY)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5,
                                   atol=1e-5)


def test_check_no_grad_raises_naming_the_kernel():
    t = torch.zeros(3, requires_grad=True)
    with pytest.raises(ValueError, match="flash_decode has no backward"):
        common.check_no_grad("flash_decode", torch.zeros(3), t)
    common.check_no_grad("flash_decode", t.detach(), None)
    with torch.no_grad():
        common.check_no_grad("flash_decode", t)


def test_cuda_wrappers_call_the_guard(monkeypatch):
    """With the device checks stood down, the CUDA wrappers of
    ``flash_decode`` and both ``dp_clip`` passes reach the guard before
    any launch."""
    from repro_torch.kernels.dp_clip import dp_clip
    from repro_torch.kernels.flash_attn import flash_attn
    monkeypatch.setattr(flash_attn, "check_launchable", lambda *a: None)
    monkeypatch.setattr(dp_clip, "_check_cuda_f32", lambda *a: None)
    q = torch.zeros((1, 2, 32), requires_grad=True)
    kv = torch.zeros((1, 4, 2, 32))
    with pytest.raises(ValueError, match="flash_decode has no backward"):
        flash_attn.flash_decode(q, kv, kv, torch.zeros(1, dtype=torch.int32))
    flat = torch.zeros((2, 8), requires_grad=True)
    with pytest.raises(ValueError, match="dp_clip sqnorms has no backward"):
        dp_clip.sqnorms(flat)
    with pytest.raises(ValueError,
                       match="dp_clip cohort_scale_mean has no backward"):
        dp_clip.cohort_scale_mean(flat, torch.ones(2), k=1, inv_b=0.5)


def test_loss_grad_gives_zeros_for_an_unused_leaf():
    g = loss_grad(lambda p, b: torch.sum(p["a"] * b), {
        "a": torch.ones(2), "b": torch.ones(3)}, torch.ones(2))
    assert torch.equal(g["b"], torch.zeros(3))
    assert torch.equal(g["a"], torch.ones(2))
    assert len(tree_leaves(g)) == 2
