"""The port's model, DP primitives, dp_clip op, Adam and one fused
cohort step vs the JAX reference on the CPU, from identical numpy-seeded
inputs and the reference's own initial params.

Tolerance 1e-5 (absolute, on O(1e-2..1) values) everywhere below except
params after an Adam step: f32 sums are taken in other orders than XLA's
(conv, matmul, per-row norms over D), which moves results by ~1e-7
relative; nothing here is stochastic (noise is injected).

Reference per-example gradients are taken UN-jitted (or as jitted
single-example grads): on the installed JAX, ``jax.jit`` of
``vmap(grad)`` through this tiny CNN returns wrong conv-weight gradients
(XLA:CPU's algebraic simplifier; ROADMAP.md queue 3), while eager
``vmap(grad)`` and single-example grads agree with each other and with
the port."""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dp as r_dp
from repro.engine.cohort_step import _unflatten_members
from repro.kernels.dp_clip.ops import dp_clip_mean_noise_cohort as r_clip
from repro.models import ser_cnn as r_cnn
from repro.optim.optimizers import Adam as RAdam
from repro.pytree import tree_gaussian_vector_like

from repro_torch.core import dp as t_dp
from repro_torch.engine.cohort_step import make_cohort_step
from repro_torch.kernels.dp_clip import dp_clip as t_kernel
from repro_torch.kernels.dp_clip import ops as t_ops
from repro_torch.kernels.dp_clip import ref as t_ref
from repro_torch.models import convert, ser_cnn as t_cnn
from repro_torch.optim.optimizers import Adam as TAdam
from repro_torch.pytree import (
    tree_flatten_to_vector, tree_leaves, tree_map, tree_size)

TOL = 1e-5
_DIMS = dict(time_frames=12, n_mels=12)
R_CFG = r_cnn.SERConfig(channels1=8, channels2=16, fc_dim=32, **_DIMS)
T_CFG = t_cnn.SERConfig(channels1=8, channels2=16, fc_dim=32, **_DIMS)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _ref_params(seed=0):
    return r_cnn.init(jax.random.PRNGKey(seed), R_CFG)


def _batch(n, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 12, 12)).astype(np.float32)
    y = rng.integers(0, 4, size=n).astype(np.int32)
    return x, y


def _t_batch(x, y):
    return {"x": torch.from_numpy(x), "y": torch.from_numpy(y).long()}


_single_grad = jax.jit(jax.grad(
    lambda p, ex: r_cnn.loss_fn(p, ex, R_CFG)))


def _ref_per_example_grads(loss, params, batch):
    """Reference per-example grads as a stack of jitted single-example
    grads (see the module docstring)."""
    assert loss.keywords["cfg"] == R_CFG
    n = batch["y"].shape[0]
    return jax.tree_util.tree_map(
        lambda *ls: jnp.stack(ls),
        *[_single_grad(params, {"x": batch["x"][i], "y": batch["y"][i]})
          for i in range(n)])


def _assert_trees_close(ref_tree, port_tree, atol=TOL):
    for a, b in zip(jax.tree_util.tree_leaves(ref_tree),
                    tree_leaves(port_tree)):
        np.testing.assert_allclose(np.asarray(a), b.detach().numpy(),
                                   rtol=0, atol=atol)


# ---------------------------------------------------------------------------
# model
# ---------------------------------------------------------------------------

def test_logits_and_accuracy_match():
    p_r = _ref_params(1)
    p_t = convert.params_from_numpy(_np(p_r))
    x, y = _batch(40)
    ref = jax.jit(jax.vmap(lambda e: r_cnn.apply(p_r, e, R_CFG)))(
        jnp.asarray(x))
    port = t_cnn.apply_batch(p_t, torch.from_numpy(x), T_CFG)
    np.testing.assert_allclose(np.asarray(ref), port.numpy(), rtol=0, atol=TOL)
    one = t_cnn.apply(p_t, torch.from_numpy(x[3]), T_CFG)
    np.testing.assert_allclose(np.asarray(ref[3]), one.numpy(), rtol=0,
                               atol=TOL)
    data = {"x": x, "y": y}
    assert float(r_cnn.make_accuracy_fn(R_CFG)(p_r, data)) == float(
        t_cnn.make_accuracy_fn(T_CFG, batch=16)(p_t, data))


def test_per_example_loss_and_grads_match():
    p_r = _ref_params(2)
    p_t = convert.params_from_numpy(_np(p_r))
    x, y = _batch(16, seed=1)
    r_loss = partial(r_cnn.loss_fn, cfg=R_CFG)
    t_loss = partial(t_cnn.loss_fn, cfg=T_CFG)
    batch_r = {"x": jnp.asarray(x), "y": jnp.asarray(y)}
    losses_r = jax.jit(jax.vmap(lambda ex: r_loss(p_r, ex)))(batch_r)
    losses_t = torch.stack([t_loss(p_t, {"x": torch.from_numpy(x[i]),
                                          "y": torch.tensor(int(y[i]))})
                            for i in range(16)])
    np.testing.assert_allclose(np.asarray(losses_r), losses_t.numpy(),
                               rtol=0, atol=TOL)
    g_r = _ref_per_example_grads(r_loss, p_r, batch_r)
    g_t = t_dp.per_example_grads(t_loss, p_t, _t_batch(x, y))
    _assert_trees_close(g_r, g_t)


# ---------------------------------------------------------------------------
# dp_clip op: plain version (CPU route) vs the reference kernel, run
# interpreted as the reference's own tests run it
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k,b,d", [(2, 16, 300),     # K > 1
                                   (1, 1, 37),       # B = 1, D < a tile
                                   (3, 13, 1031),    # prime B and D
                                   (2, 7, 513)])     # ragged D tile
@pytest.mark.parametrize("noise", [False, True])
def test_dp_clip_cohort_matches_reference(k, b, d, noise):
    rng = np.random.default_rng(k * 1000 + b + d)
    g = (rng.standard_normal((k, b, d)) * 0.05).astype(np.float32)
    g[:, : (b + 1) // 2] *= 40.0       # half the rows clip
    if noise:
        z = rng.standard_normal((k, d)).astype(np.float32)
        std = np.float32(1.0 / b)
        ref = r_clip(jnp.asarray(g), 1.0, jnp.float32(std), jnp.asarray(z))
        port = t_ops.dp_clip_mean_noise_cohort(
            torch.from_numpy(g), 1.0, torch.tensor([std]),
            torch.from_numpy(z))
    else:
        ref = r_clip(jnp.asarray(g), 1.0)
        port = t_ops.dp_clip_mean_noise_cohort(torch.from_numpy(g), 1.0)
    for a, t in zip(ref, port):
        np.testing.assert_allclose(np.asarray(a), t.numpy(), rtol=TOL,
                                   atol=1e-6)


def test_dp_clip_k1_views_and_plain_halves():
    rng = np.random.default_rng(3)
    flat = torch.from_numpy(
        (rng.standard_normal((9, 77)) * 0.3).astype(np.float32))
    mean, nrm, frac = t_ops.dp_clip_mean_flat(flat, 1.0)
    norms = torch.sqrt(t_ref.sqnorms_ref(flat))
    scales = t_ref.clip_scales(norms, 1.0)
    torch.testing.assert_close(t_ops.scale_mean(flat, scales), mean)
    torch.testing.assert_close(nrm, norms.mean())
    torch.testing.assert_close(frac, (norms > 1.0).float().mean())
    from repro.kernels.dp_clip.ref import dp_clip_mean_flat_ref
    r_mean, r_nrm, r_frac = dp_clip_mean_flat_ref(jnp.asarray(flat.numpy()),
                                                  1.0)
    np.testing.assert_allclose(np.asarray(r_mean), mean.numpy(), atol=1e-6)
    assert abs(float(r_nrm) - float(nrm)) < TOL
    assert float(r_frac) == float(frac)


def test_dp_clip_wrapper_validates_inputs():
    g = torch.zeros(2, 3, 5)
    with pytest.raises(ValueError, match="K, B, D"):
        t_ops.dp_clip_mean_noise_cohort(g[0], 1.0)
    with pytest.raises(ValueError, match="float32"):
        t_ops.dp_clip_mean_noise_cohort(g.double(), 1.0)
    with pytest.raises(ValueError, match="z must be"):
        t_ops.dp_clip_mean_noise_cohort(g, 1.0, 0.1, torch.zeros(2, 4))
    with pytest.raises(ValueError, match="noise_stddev"):
        t_ops.dp_clip_mean_noise_cohort(g, 1.0, None, torch.zeros(2, 5))
    # the kernel launchers themselves refuse CPU tensors (no silent route)
    with pytest.raises(ValueError, match="CUDA"):
        t_kernel.sqnorms(g.view(6, 5))
    with pytest.raises(ValueError, match="CUDA"):
        t_kernel.cohort_scale_mean(g.view(6, 5), torch.ones(6), k=2,
                                   inv_b=1 / 3)


# ---------------------------------------------------------------------------
# dp_mean_gradient, both paths, with the reference's noise injected
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dp_path", ["jnp", "pallas"])
@pytest.mark.parametrize("sigma", [0.0, 1.0])
def test_dp_mean_gradient_matches_reference(dp_path, sigma):
    p_r = _ref_params(3)
    p_t = convert.params_from_numpy(_np(p_r))
    x, y = _batch(16, seed=4)
    key = jax.random.PRNGKey(11)
    cfg_r = r_dp.DPConfig(clip_norm=1.0, noise_multiplier=sigma)
    cfg_t = t_dp.DPConfig(clip_norm=1.0, noise_multiplier=sigma)
    g_r, aux_r = r_dp.dp_mean_gradient(
        partial(r_cnn.loss_fn, cfg=R_CFG), p_r,
        {"x": jnp.asarray(x), "y": jnp.asarray(y)}, key, cfg_r,
        dp_path="jnp")
    z = torch.from_numpy(np.array(tree_gaussian_vector_like(key, p_r)))
    g_t, aux_t = t_dp.dp_mean_gradient(
        partial(t_cnn.loss_fn, cfg=T_CFG), p_t, _t_batch(x, y), cfg_t,
        dp_path=dp_path, z=z)
    _assert_trees_close(g_r, g_t)
    assert abs(float(aux_r["mean_grad_norm"])
               - float(aux_t["mean_grad_norm"])) < TOL
    assert float(aux_r["clip_fraction"]) == float(aux_t["clip_fraction"])


def test_noise_generator_draws_flat_leaf_order():
    """A generator-drawn z is the flat vector the kernel path adds."""
    p_t = convert.params_from_numpy(_np(_ref_params(4)))
    zero = tree_map(torch.zeros_like, p_t)
    noised = t_dp.noise_tree(zero, 0.5,
                             generator=torch.Generator().manual_seed(9))
    z = torch.randn(tree_size(p_t), generator=torch.Generator().manual_seed(9))
    assert torch.equal(tree_flatten_to_vector(noised), z * 0.5)
    clipped, nrm = t_dp.clip_tree(p_t, 0.5)
    assert float(nrm) > 0.5
    assert abs(float(torch.sqrt(sum((l * l).sum()
                                    for l in tree_leaves(clipped)))) - 0.5) < TOL


# ---------------------------------------------------------------------------
# Adam
# ---------------------------------------------------------------------------

def test_adam_matches_reference_and_stacks():
    rng = np.random.default_rng(5)
    shapes = {"a": (7, 3), "b": (5,)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    grads = [{k: (rng.standard_normal(s) * 0.1).astype(np.float32)
              for k, s in shapes.items()} for _ in range(3)]
    r_opt, t_opt = RAdam(lr=1e-3), TAdam(lr=1e-3)
    p_r = jax.tree_util.tree_map(jnp.asarray, params)
    s_r = r_opt.init(p_r)
    p_t = convert.params_from_numpy(params)
    s_t = t_opt.init(p_t)
    for g in grads:
        p_r, s_r = r_opt.update(jax.tree_util.tree_map(jnp.asarray, g),
                                s_r, p_r)
        p_t, s_t = t_opt.update(convert.params_from_numpy(g), s_t, p_t)
        _assert_trees_close(p_r, p_t, atol=1e-6)
        _assert_trees_close(s_r.mu, s_t.mu, atol=1e-7)
        _assert_trees_close(s_r.nu, s_t.nu, atol=1e-7)
    assert int(s_t.step) == 3
    # stacked (K=2) update == per-member updates
    stk = tree_map(lambda l: torch.stack([l, 2 * l]), p_t)
    g_stk = tree_map(lambda l: torch.stack([l, -l]),
                     convert.params_from_numpy(grads[0]))
    st_stk = t_opt.init(stk, stack_shape=(2,))
    new_stk, _ = t_opt.update(g_stk, st_stk, stk)
    for i in range(2):
        one, _ = t_opt.update(tree_map(lambda l: l[i], g_stk),
                              t_opt.init(tree_map(lambda l: l[i], stk)),
                              tree_map(lambda l: l[i], stk))
        for a, b in zip(tree_leaves(one), tree_leaves(new_stk)):
            assert torch.equal(a, b[i])


# ---------------------------------------------------------------------------
# one DP-SGD step of the fused step-major executor, K = 2
# ---------------------------------------------------------------------------

def test_one_fused_cohort_step_matches_reference(monkeypatch):
    """Port's cohort step (gather -> per-example grads -> dp_clip -> batched
    Adam -> scatter) vs the reference's step-major math composed by hand:
    ``per_example_grads`` -> ``dp_clip_mean_noise_cohort`` -> ``Adam.update``.

    DP mean gradients are held to 1e-5.  Params after the step are held to
    2 * lr: Adam's first step is ``lr * m/(sqrt(v) + eps)`` with
    ``m/sqrt(v) = g/|g|``, i.e. ``+-lr`` per element, so a gradient entry
    within ~1e-8 of zero can come out with the opposite sign from a
    different f32 summation order and move that param by up to 2 * lr;
    every other entry agrees to ~1e-9 (checked on the 99th percentile)."""
    k, b, sigma, clip = 2, 16, 1.0, 1.0
    p_r = [_ref_params(10), _ref_params(11)]
    stacked_np = jax.tree_util.tree_map(
        lambda *ls: np.stack([np.asarray(l) for l in ls]), *p_r)
    rng = np.random.default_rng(6)
    n = 40
    data_x = rng.standard_normal((k + 1, n, 12, 12)).astype(np.float32)
    data_y = rng.integers(0, 4, size=(k + 1, n)).astype(np.int32)
    batch_idx = np.stack([rng.permutation(n)[:b] for _ in range(k)])[:, None]
    seeds = [123, 456]

    # -- port: one call of the arena cohort step (s_max = 1)
    opt_t = TAdam(lr=1e-3)
    arena_p = convert.params_from_numpy(stacked_np)
    arena_p = tree_map(lambda l: torch.cat([l, l[:1]]), arena_p)  # + pad slot
    arena_o = opt_t.init(arena_p, stack_shape=(k + 1,))
    arena_d = {"x": torch.from_numpy(data_x),
               "y": torch.from_numpy(data_y).long()}
    captured = {}
    real = t_ops.dp_clip_mean_noise_cohort

    def spy(*a, **kw):
        out = real(*a, **kw)
        captured["means"] = out[0]
        return out

    monkeypatch.setattr(t_ops, "dp_clip_mean_noise_cohort", spy)
    step, _merge = make_cohort_step(
        partial(t_cnn.loss_fn, cfg=T_CFG),
        t_dp.DPConfig(clip_norm=clip, noise_multiplier=sigma), opt_t,
        use_dp=True, dp_path="pallas", add_noise=True)
    slots = torch.arange(k)
    std = np.float32(sigma * clip / b)
    upload, arena_o2, (finite, norm) = step(
        arena_p, arena_o, arena_d, slots, slots,
        torch.from_numpy(batch_idx).long(),
        [torch.Generator().manual_seed(s) for s in seeds],
        np.ones(k, np.int32), torch.tensor([std]), torch.ones(k))

    # -- reference: the same step's math, the same z injected
    d = tree_size(arena_p) // (k + 1)
    z = np.stack([torch.randn(d, generator=torch.Generator().manual_seed(s))
                  .numpy() for s in seeds])
    r_loss = partial(r_cnn.loss_fn, cfg=R_CFG)
    bx = np.stack([data_x[i][batch_idx[i, 0]] for i in range(k)])
    by = np.stack([data_y[i][batch_idx[i, 0]] for i in range(k)])
    stacked_r = jax.tree_util.tree_map(jnp.asarray, stacked_np)
    g_per = jax.tree_util.tree_map(
        lambda *ls: jnp.stack(ls),
        *[_ref_per_example_grads(
            r_loss, jax.tree_util.tree_map(lambda l: l[i], stacked_r),
            {"x": jnp.asarray(bx[i]), "y": jnp.asarray(by[i])})
          for i in range(k)])
    flat = jnp.concatenate([l.reshape(k, b, -1)
                            for l in jax.tree_util.tree_leaves(g_per)], axis=2)
    means_r, _, _ = r_clip(flat, clip, jnp.float32(std), jnp.asarray(z))
    np.testing.assert_allclose(np.asarray(means_r),
                               captured["means"].numpy(), rtol=0, atol=TOL)
    template = jax.tree_util.tree_map(lambda l: l[0], stacked_r)
    grads_r = _unflatten_members(means_r, template)
    opt_r = RAdam(lr=1e-3)
    new_r, state_r = jax.jit(jax.vmap(opt_r.update))(
        grads_r, jax.vmap(opt_r.init)(stacked_r), stacked_r)

    lr = 1e-3
    diffs = np.concatenate([
        np.abs(np.asarray(a) - t.numpy()).ravel()
        for a, t in zip(jax.tree_util.tree_leaves(new_r),
                        tree_leaves(upload))])
    assert diffs.max() <= 2 * lr + 1e-7
    assert np.quantile(diffs, 0.99) < 1e-6
    # opt state scattered back into the members' slots, pad slot untouched
    assert torch.equal(arena_o2.step, torch.tensor([1, 1, 0], dtype=torch.int32))
    _assert_trees_close(state_r.mu, tree_map(lambda l: l[:k], arena_o2.mu),
                        atol=1e-6)
    assert bool(finite.all())
    ref_norm = np.sqrt(sum(
        np.sum((np.asarray(a) - np.asarray(p0)) ** 2, axis=tuple(
            range(1, np.asarray(a).ndim)))
        for a, p0 in zip(jax.tree_util.tree_leaves(new_r),
                         jax.tree_util.tree_leaves(stacked_r))))
    np.testing.assert_allclose(ref_norm, norm.numpy(), rtol=1e-2)


def test_merge_masks_zero_coefficient_members():
    """0 * NaN must not poison the fused merge (reference cohort_step.py:607)."""
    _step, merge = make_cohort_step(
        partial(t_cnn.loss_fn, cfg=T_CFG), t_dp.DPConfig(), TAdam())
    g = {"w": torch.ones(3)}
    st = {"w": torch.stack([torch.full((3,), 2.0),
                            torch.full((3,), float("nan"))])}
    out = merge(g, st, torch.tensor([0.5, 0.0]), 0.5)
    assert torch.equal(out["w"], torch.full((3,), 1.5))


# ---------------------------------------------------------------------------
# the rest of core/dp.py and the ser_linear workload
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fn", ["accumulate_noise", "client_delta",
                                "microbatch"])
def test_dp_unit_level_mechanisms_match_reference(fn):
    p_r = _ref_params(5)
    p_t = convert.params_from_numpy(_np(p_r))
    key = jax.random.PRNGKey(21)
    z = torch.from_numpy(np.array(tree_gaussian_vector_like(key, p_r)))
    cfg_r = r_dp.DPConfig(clip_norm=0.5, noise_multiplier=1.3)
    cfg_t = t_dp.DPConfig(clip_norm=0.5, noise_multiplier=1.3)
    if fn == "accumulate_noise":
        out_r = r_dp.dp_accumulate_noise(p_r, key, cfg_r, 4)
        out_t = t_dp.dp_accumulate_noise(p_t, cfg_t, 4, z=z)
    elif fn == "client_delta":
        out_r, nrm_r = r_dp.dp_client_delta(p_r, key, cfg_r)
        out_t, nrm_t = t_dp.dp_client_delta(p_t, cfg_t, z=z)
        assert abs(float(nrm_r) - float(nrm_t)) < TOL
    else:
        out_r, nrm_r = r_dp.dp_microbatch_gradient(p_r, key, cfg_r, 4)
        out_t, nrm_t = t_dp.dp_microbatch_gradient(p_t, cfg_t, 4)
        assert abs(float(nrm_r) - float(nrm_t)) < TOL
    _assert_trees_close(out_r, out_t)


def test_ser_linear_workload_matches_reference():
    from repro.api.workloads import get_workload as r_get
    from repro_torch.api.workloads import get_workload as t_get
    p_r = r_get("ser_linear").init(jax.random.PRNGKey(3), R_CFG)
    p_t = convert.params_from_numpy(_np(p_r))
    x, y = _batch(24, seed=8)
    r_loss = r_get("ser_linear").loss(R_CFG)
    t_loss = t_get("ser_linear").loss(T_CFG)
    g_r = r_dp.per_example_grads(r_loss, p_r,
                                 {"x": jnp.asarray(x), "y": jnp.asarray(y)})
    g_t = t_dp.per_example_grads(t_loss, p_t, _t_batch(x, y))
    _assert_trees_close(g_r, g_t)
    data = {"x": x, "y": y}
    assert float(r_get("ser_linear").accuracy(R_CFG)(p_r, data)) == float(
        t_get("ser_linear").accuracy(T_CFG)(p_t, data))
    assert tuple(t_get("ser_linear").init(0, T_CFG)["w"].shape) == (144, 4)
