"""How far bf16 rounding alone moves a model's gradient, in the JAX package
and in the port, from the same params and batch on the CPU.

    JAX_PLATFORMS=cpu PYTHONPATH=src python tests/_torch_bf16_sensitivity.py \
        --arch zamba2-1.2b --layers 38 --d-model 256 --seq 128

The architecture's ``reduced()`` config with ``--layers`` and ``--d-model``
put back (the other widths stay reduced; ``attn_every`` is the full
config's once the depth allows it) is initialised once, by the port's
seeded init in f32, and one batch of ``--batch`` token sequences is drawn
from a seed.  Each package then takes the gradient of the family's loss
with the params in f32 and in bf16 (``jax.grad`` jitted; the port's
``torch.autograd.grad``).  For every leaf the script prints the relative L2
distances

* ``jax16-jax32``: the JAX package's bf16 gradient from its f32 one;
* ``port16-port32``: the same in the port;
* ``port32-jax32``: the two packages in f32;
* ``port16-jax16``: the two packages in bf16;

and their smallest and largest values over the leaves.  If the JAX package's own bf16
gradient lies as far from its f32 gradient as the port's does, the
distance is the model's sensitivity to rounding, not a fault of the port.
"""
import argparse
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

from repro.configs import get_config as r_get_config  # noqa: E402
from repro.models.base import get_family as r_get_family  # noqa: E402

from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models.base import get_family as t_get_family  # noqa: E402
from repro_torch.pytree import tree_leaves, tree_map, tree_paths  # noqa: E402

COLUMNS = ("jax16-jax32", "port16-port32", "port32-jax32", "port16-jax16")


def configs(arch, layers, d_model, seq):
    full = r_get_config(arch)
    kw = dict(n_layers=layers, d_model=d_model, param_dtype="float32",
              ssm_chunk=min(seq, 32))
    if full.attn_every:
        kw["attn_every"] = full.attn_every if layers > full.attn_every else 2
    return (r_get_config(arch).reduced().replace(**kw),
            t_get_config(arch).reduced().replace(**kw))


def jax_grad(cfg, np_params, arrays, dtype):
    cfg = cfg.replace(param_dtype=dtype)
    fam = r_get_family(cfg.family)
    params = jax.tree_util.tree_map(lambda a: jnp.asarray(a).astype(dtype),
                                    np_params)
    grad = jax.jit(jax.grad(lambda p, b: fam.loss(p, b, cfg)))(
        params, {k: jnp.asarray(v) for k, v in arrays.items()})
    return [np.asarray(g, np.float32) for g in jax.tree_util.tree_leaves(grad)]


def port_grad(cfg, t_params, arrays, dtype):
    cfg = cfg.replace(param_dtype=dtype)
    fam = t_get_family(cfg.family)
    params = tree_map(lambda a: a.to(getattr(torch, dtype)).requires_grad_(),
                      t_params)
    loss = fam.loss(params, {k: torch.from_numpy(v)
                             for k, v in arrays.items()}, cfg)
    leaves = tree_leaves(params)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return [np.zeros(p.shape, np.float32) if g is None
            else g.float().numpy() for p, g in zip(leaves, grads)]


def rel_l2(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="zamba2-1.2b")
    ap.add_argument("--layers", type=int, default=38)
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    torch.set_num_threads(2)

    r_cfg, t_cfg = configs(args.arch, args.layers, args.d_model, args.seq)
    t_params = t_get_family(t_cfg.family).init_params(t_cfg, seed=0,
                                                      device="cpu")
    np_params = convert.params_to_numpy(t_params)
    rng = np.random.default_rng(args.seed)
    toks = rng.integers(0, r_cfg.vocab, size=(args.batch, args.seq + 1))
    arrays = {"tokens": toks[:, :-1].astype(np.int32),
              "labels": toks[:, 1:].astype(np.int32)}
    g = {"jax32": jax_grad(r_cfg, np_params, arrays, "float32"),
         "jax16": jax_grad(r_cfg, np_params, arrays, "bfloat16"),
         "port32": port_grad(t_cfg, t_params, arrays, "float32"),
         "port16": port_grad(t_cfg, t_params, arrays, "bfloat16")}
    print(f"{args.arch}: {r_cfg.n_layers} layers, d_model {r_cfg.d_model}, "
          f"attn_every {r_cfg.attn_every}, B={args.batch} x {args.seq} "
          f"tokens; per-leaf relative L2 of the gradients")
    print(f"{'leaf':36s}" + "".join(f"{c:>15s}" for c in COLUMNS))
    worst, least = np.zeros(len(COLUMNS)), np.full(len(COLUMNS), np.inf)
    for i, path in enumerate(tree_paths(t_params)):
        row = [rel_l2(g[c.split("-")[0]][i], g[c.split("-")[1]][i])
               for c in COLUMNS]
        worst, least = np.maximum(worst, row), np.minimum(least, row)
        print(f"{'/'.join(map(str, path)):36s}"
              + "".join(f"{x:15.3e}" for x in row))
    print(f"{'min over leaves':36s}" + "".join(f"{x:15.3e}" for x in least))
    print(f"{'max over leaves':36s}" + "".join(f"{x:15.3e}" for x in worst))


if __name__ == "__main__":
    main()
