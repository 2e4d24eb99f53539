"""The production round (``core/fl_step.py``) trains every family of the
architecture zoo through autograd, held to the JAX package's
``make_fl_train_step`` on all ten ``reduced()`` configs in f32.

Both packages start from the same params (the port's seeded init, carried
to JAX as numpy) and the same batch (numpy from a seed), and the port's
round draws the reference's own ``jax.random.normal`` noise, injected
through the round's noise-source hook, so a DP-on round is compared draw
for draw.  The reference step runs jitted in this process: no family's
gradient needs the ``algsimp`` flag of the SER CNN's
``jit(vmap(grad))`` (the rounds agree to ~1e-7).

* Per-microbatch DP (clip 1, sigma 0.5), 2 clients x 2 microbatches,
  ``server_opt="sgd"`` at ``server_lr=1``: the new master is master +
  Delta, so holding it at 1e-5 holds the aggregated delta, and with it
  every family's gradient, clipping and noise.
* ``tests/test_torch_fl_step.py`` holds the client-level round (SGD and
  FedAdam) and the bf16 round on a hybrid and a dense config: client-level
  clipping and noise, and the compute dtype, do not depend on the family,
  whose gradients the per-microbatch round holds here.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS
from repro.configs import get_config as r_get_config
from repro.core import fl_step as r_fl
from repro.core.dp import DPConfig as RDPConfig
from repro.models.base import get_family as r_get_family

from repro_torch.configs import get_config as t_get_config
from repro_torch.core import fl_step as t_fl
from repro_torch.core.dp import DPConfig as TDPConfig
from repro_torch.models import convert
from repro_torch.models.base import get_family as t_get_family
from repro_torch.pytree import tree_leaves

SEQ, G, N_MICRO, PER_MICRO = 16, 2, 2, 1
TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def setup_arch(arch, dtype="float32", overrides=None, clients=G):
    """The reduced config (with ``overrides``) in both packages at
    ``dtype``, the port's seeded f32 params in both, and one global batch
    of ``clients`` x N_MICRO x PER_MICRO sequences."""
    kw = dict(param_dtype=dtype, ssm_chunk=SEQ, **(overrides or {}))
    r_cfg = r_get_config(arch).reduced().replace(**kw)
    t_cfg = t_get_config(arch).reduced().replace(**kw)
    t_params = t_get_family(t_cfg.family).init_params(
        t_cfg.replace(param_dtype="float32"), seed=0, device="cpu")
    r_params = jax.tree_util.tree_map(
        jnp.asarray, convert.params_to_numpy(t_params))
    rng = np.random.default_rng(1)
    b = clients * N_MICRO * PER_MICRO
    toks = rng.integers(0, r_cfg.vocab, size=(b, SEQ + 1)).astype(np.int32)
    arrays = {"tokens": toks[:, :SEQ], "labels": toks[:, 1:]}
    if r_cfg.family == "audio":
        arrays["frames"] = rng.standard_normal(
            (b, r_cfg.enc_frames, r_cfg.d_model)).astype(np.float32)
    if r_cfg.family == "vlm":
        arrays["patches"] = rng.standard_normal(
            (b, r_cfg.n_patches, r_cfg.d_model)).astype(np.float32)
    # the stub inputs in the compute dtype, as the launcher feeds them
    stub = [k for k in arrays if k in ("frames", "patches")]
    return (r_cfg, t_cfg, r_params, t_params,
            {k: jnp.asarray(v, dtype if k in stub else None)
             for k, v in arrays.items()},
            {k: torch.from_numpy(v).to(getattr(torch, dtype)) if k in stub
             else torch.from_numpy(v) for k, v in arrays.items()})


def reference_noise(key, n_clients, n_local, params):
    """The JAX round's draws as the port's noise source: client c's step
    s, leaf j is ``normal(split(split(keys[c], n_local)[s], L)[j])`` and
    the client-level noise (client G) ``normal(split(keys[G], L)[j])``,
    with ``keys = split(key, G + 1)`` (``repro/core/fl_step.py``)."""
    n_leaves = len(jax.tree_util.tree_leaves(params))
    keys = jax.random.split(key, n_clients + 1)

    def source(client, step, leaf, shape):
        if client == n_clients:
            k = jax.random.split(keys[client], n_leaves)[leaf]
        else:
            k = jax.random.split(
                jax.random.split(keys[client], n_local)[step], n_leaves)[leaf]
        return np.array(jax.random.normal(k, shape, jnp.float32))

    return source


def run_both(arch, granularity, server_opt, server_lr, dtype="float32",
             overrides=None, clients=G):
    """One round of each package from the same f32 master, batch and
    noise, its ``clients`` clients in ``dtype`` (the reduced config with
    ``overrides``): ``(reference master, port master, reference metrics,
    port metrics, initial params)``."""
    G = clients
    r_cfg, t_cfg, r_params, t_params, r_batch, t_batch = setup_arch(
        arch, dtype, overrides, clients)
    kw = dict(num_clients=G, n_local=1, n_micro=N_MICRO, local_lr=0.05,
              server_lr=server_lr, server_opt=server_opt,
              compute_dtype=dtype)
    r_flc = r_fl.FLStepConfig(dp=RDPConfig(1.0, 0.5, granularity), **kw)
    t_flc = t_fl.FLStepConfig(dp=TDPConfig(1.0, 0.5, granularity), **kw)
    r_fam, t_fam = r_get_family(r_cfg.family), t_get_family(t_cfg.family)
    key = jax.random.PRNGKey(1)
    r_step = jax.jit(r_fl.make_fl_train_step(
        lambda p, b: r_fam.loss(p, b, r_cfg), r_flc))
    r_out = r_step(r_params, r_fl.make_server_optimizer(r_flc).init(r_params),
                   r_batch, jnp.ones((G,)) / G, key)
    t_step = t_fl.make_fl_train_step(
        lambda p, b: t_fam.loss(p, b, t_cfg), t_flc)
    t_out = t_step(t_params, t_fl.make_server_optimizer(t_flc).init(t_params),
                   t_batch, torch.ones(G) / G,
                   reference_noise(key, G, 1, r_params))
    return r_out[0], t_out[0], r_out[2], t_out[2], t_params


def assert_tree_close(r_tree, t_tree, tol):
    r_leaves = jax.tree_util.tree_leaves(r_tree)
    t_leaves = tree_leaves(t_tree)
    assert len(r_leaves) == len(t_leaves)
    for a, b in zip(r_leaves, t_leaves):
        np.testing.assert_allclose(b.detach().numpy(), np.asarray(a),
                                   rtol=tol, atol=tol)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_per_microbatch_round_matches_reference(arch):
    """Master + Delta (SGD at lr 1) within 1e-5 of the JAX round's, the
    round moved the params, and the metrics agree."""
    r_master, t_master, r_met, t_met, p0 = run_both(
        arch, "per_microbatch", "sgd", 1.0)
    assert_tree_close(r_master, t_master, TOL)
    moved = max(float((a - b).abs().max())
                for a, b in zip(tree_leaves(t_master), tree_leaves(p0)))
    assert moved > 1e-3, f"{arch}: the round did not move the params"
    np.testing.assert_allclose(float(t_met["delta_norm"]),
                               float(r_met["delta_norm"]), rtol=TOL)
    assert float(t_met["weight_sum"]) == pytest.approx(1.0)
