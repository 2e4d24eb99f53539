"""Padded uneven heads (``attn_shard="heads_padded"``) without ranks: the
padded blocks, their shapes against the JAX package's specs, the
placement pattern the reduced tests keep, and the dry run on the CPU.

* ``shardings.block`` gives GSPMD's padded block: smollm-360m's 15 query
  heads on a model axis of 2 are 8 + 8 slots, the last one zero, and no
  head is dropped (it once cut 7 + 7 and dropped head 14); an uneven cut
  that is not the leaf rule's padded head count still raises.
* For every config, role (master, client, serve) and both production
  meshes, each rank's block shapes (and so its param bytes) are the
  JAX package's ``leaf_spec`` with GSPMD's padding, ``ceil(n / M)``
  slots on the model dim (``repro.launch.shardings`` on an abstract
  mesh).
* Reduced smollm-360m with the full width's 15/5 heads keeps the full
  width's pattern: it pads on model axes of 2 and 4, its GQA groups
  straddle ranks on both, and on 4 one rank holds no real kv head.
* ``dryrun.run_one(..., attn_shard="heads_padded")`` is ``ok`` for a
  train, a prefill and decode combinations (rank 15 of the 56-head and
  of the 20-head configs among them: Whisper's rank 15 holds padding
  only), and sets the option for its combination only.
"""
import jax
import numpy as np
import pytest
import torch

import repro.launch.shardings as r_sh
from repro.configs import ARCH_IDS
from repro.configs import get_config as r_get_config
from repro.models.base import get_family as r_get_family

from repro_torch.configs import get_config as t_get_config
from repro_torch.launch import dryrun, serve
from repro_torch.launch import shardings as t_sh
from repro_torch.launch.mesh import HostMesh, make_production_mesh
from repro_torch.models.base import get_family as t_get_family
from repro_torch.models.layers import straddles
from repro_torch.pytree import tree_leaves, tree_map

MESHES = {"16x16": (None, 16, 16), "2x16x16": (2, 16, 16)}


@pytest.fixture
def heads_padded():
    r_sh.set_sharding_options(attn_shard="heads_padded")
    t_sh.set_sharding_options(attn_shard="heads_padded")
    yield
    r_sh.set_sharding_options(attn_shard="even")
    t_sh.set_sharding_options(attn_shard="even")


def _amesh(pod, data, model):
    sizes = (data, model) if pod is None else (pod, data, model)
    names = ("data", "model") if pod is None else ("pod", "data", "model")
    try:
        return jax.sharding.AbstractMesh(sizes, names)
    except TypeError:
        return jax.sharding.AbstractMesh(tuple(zip(names, sizes)))


def test_fifteen_heads_on_two_ranks_pad_and_drop_none(heads_padded):
    """smollm-360m's wq (960, 15, 64) on a model axis of 2: rank 0 holds
    heads 0-7, rank 1 heads 8-14 and one zero slot; ``serve.place_params``
    gives rank 0 the padded shape too."""
    cfg = t_get_config("smollm-360m")
    mesh = HostMesh.abstract(1, 2)
    wq = torch.arange(960 * 15 * 64, dtype=torch.float32).reshape(960, 15, 64)
    sh = t_sh.tree_shardings({"wq": wq}, cfg, mesh, role="serve")["wq"]
    assert sh.spec == (None, "model", None) and sh.shape == (960, 15, 64)
    b0, b1 = (t_sh.block(wq, sh, 0, r) for r in (0, 1))
    assert b0.shape == b1.shape == (960, 8, 64)
    assert torch.equal(b0, wq[:, :8]) and torch.equal(b1[:, :7], wq[:, 8:])
    assert torch.count_nonzero(b1[:, 7]) == 0
    assert torch.equal(torch.cat([b0, b1], 1)[:, :15], wq)
    assert t_sh.real_range(15, 2, 1) == (8, 15)
    assert t_sh.real_range(5, 4, 3) == (5, 5)        # padding only
    params = t_get_family(cfg.family).init_params(cfg, 0, device="meta")
    placed = serve.place_params(params, cfg, mesh)
    assert tuple(placed["blocks"]["attn"]["wq"].shape) == (32, 960, 8, 64)
    assert tuple(placed["blocks"]["attn"]["wk"].shape) == (32, 960, 3, 64)
    assert tuple(placed["blocks"]["attn"]["wo"].shape) == (32, 8, 64, 960)


def test_uneven_cuts_that_are_no_padded_head_count_raise(heads_padded):
    """Only the model dim pads, and only under ``heads_padded``: an uneven
    data dim raises, and so does an uneven model dim under ``even``."""
    t = torch.zeros(6, 15)
    with pytest.raises(ValueError, match="does not split evenly over 4"):
        t_sh.block(t, t_sh.NamedSharding(HostMesh.abstract(4, 1),
                                         ("data", None)), 1, 0)
    t_sh.set_sharding_options(attn_shard="even")
    with pytest.raises(ValueError, match="does not split evenly over 2"):
        t_sh.block(t, t_sh.NamedSharding(HostMesh.abstract(1, 2),
                                         (None, "model")), 0, 1)


def _expected(shape, spec, mesh_shape):
    out = list(shape)
    for i, entry in enumerate(spec):
        names = entry if isinstance(entry, tuple) else (entry,)
        for name in names:
            if name is None:
                continue
            n = mesh_shape[name]
            if name == "model":
                out[i] = -(-out[i] // n)
            else:
                assert out[i] % n == 0
                out[i] //= n
    return tuple(out)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_blocks_are_the_reference_specs_padded(arch, mesh, heads_padded):
    """Every leaf, roles master, client (G-stacked) and serve: the
    port's spec equals the JAX package's, and the blocks of the first and
    the last rank of the model axis have the spec's padded shape."""
    pod, data, model = MESHES[mesh]
    amesh, tmesh = _amesh(pod, data, model), HostMesh.abstract(
        data, model, pod=pod)
    r_cfg, t_cfg = r_get_config(arch), t_get_config(arch)
    tree = t_get_family(t_cfg.family).init_params(t_cfg, 0, device="meta")
    mesh_shape = dict(tmesh.shape)
    groups = tmesh.size // model
    padded = 0
    for role in ("master", "client", "serve"):
        tr = tree if role != "client" else tree_map(
            lambda l: torch.empty((groups,) + tuple(l.shape), device="meta"),
            tree)
        for leaf, sh in zip(tree_leaves(tr), tree_leaves(
                t_sh.tree_shardings(tr, t_cfg, tmesh, role))):
            want = tuple(r_sh.leaf_spec(leaf.shape, r_cfg, amesh, role))
            assert sh.spec == want
            shape = _expected(tuple(leaf.shape), want, mesh_shape)
            for mr in (0, model - 1):
                assert tuple(t_sh.block(leaf, sh, 0, mr).shape) == shape
            d = t_sh.model_dim(sh)
            padded += d is not None and leaf.shape[d] % model != 0
    uneven = {t_cfg.n_heads % model, t_cfg.n_kv_heads % model} != {0}
    assert (padded > 0) == uneven


def test_reduced_smollm_keeps_the_full_width_pattern():
    """15/5 heads on model axes of 2 and 4, reduced and full: padded,
    straddling, and on 4 ranks the last holds no real kv head; of the
    production configs on 16 ranks, those whose query heads per rank do
    not cover whole GQA groups straddle."""
    full = t_get_config("smollm-360m")
    red = full.reduced().replace(n_heads=15, n_kv_heads=5)
    for cfg in (full, red):
        for m in (2, 4):
            assert cfg.n_heads % m and cfg.n_kv_heads % m
            assert straddles(cfg.n_heads, cfg.n_kv_heads, m)
        assert [t_sh.real_range(5, 4, r) for r in range(4)] == [
            (0, 2), (2, 4), (4, 5), (5, 5)]
    assert t_sh.real_range(15, 2, 1) == (8, 15)
    want = {"smollm-360m", "gemma2-2b", "llama3.2-3b", "deepseek-coder-33b"}
    got = {a for a in ARCH_IDS
           if straddles(t_get_config(a).n_heads, t_get_config(a).n_kv_heads,
                        16)}
    assert got == want
    assert not straddles(32, 32, 2) and not straddles(24, 8, 2)


@pytest.mark.parametrize("arch,shape,rank", [
    ("smollm-360m", "train_4k", 0),
    ("deepseek-coder-33b", "decode_32k", 15),
    ("whisper-large-v3", "decode_32k", 15),
    ("llama3.2-3b", "prefill_32k", 1),
], ids=str)
def test_run_one_heads_padded_is_ok(arch, shape, rank):
    """The combination runs under the option and the option is restored
    after it."""
    res = dryrun.run_one(arch, shape, "single", attn_shard="heads_padded",
                         rank=rank)
    assert res["status"] == "ok", res.get("error")
    assert res["attn_shard"] == "heads_padded" and res["rank"] == rank
    assert res["cost"]["flops"] > 0
    assert res["collectives"]["counts"]
    assert t_sh._OPTS["attn_shard"] == "even"
    assert make_production_mesh().shape == {"data": 16, "model": 16}
