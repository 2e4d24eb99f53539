"""Training launcher (port of ``repro/launch/train.py``): the two faces of
the framework behind one CLI, on the card unless ``--device cpu``.

Simulation mode (the paper's experiment):
    PYTHONPATH=src python -m repro_torch.launch.train sim \\
        --strategy fedasync --alpha 0.4 --sigma 1.0 --rounds 40 \\
        --ckpt-dir results/ckpt_sim

SPMD mode: the production round (``core/fl_step.py``) on one device,
``--data-axis`` clients run one after another on the card:
    PYTHONPATH=src python -m repro_torch.launch.train spmd \\
        --arch smollm-360m --data-axis 4 --steps 100 \\
        --reduce d_model=256,n_layers=4,vocab=2048

The flags and output lines are the JAX launcher's.  ``--devices`` (the
JAX package's host-device mesh) defaults to 1 here and anything else
raises: the multi-device round is ROADMAP.md queue 1 item 14.  The master
params are kept in f32 (``make_fl_train_step``'s master) and the clients
compute in the config's param dtype; the JAX launcher passes its init
params, in the param dtype, as the master.  ``--device`` is the port's
own flag.
"""
from __future__ import annotations

import argparse
import json
import sys


def run_sim(args):
    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.core.testbed import TestbedConfig, run_experiment
    from repro_torch.data.synthetic_ser import SERDataConfig

    cfg = TestbedConfig(
        use_dp=args.sigma > 0, sigma=args.sigma, batch_size=args.batch,
        data=SERDataConfig(n_total=args.n_total), seed=args.seed,
    )
    kw = {}
    if args.strategy != "fedavg":
        kw.update(alpha=args.alpha, max_updates=args.max_updates)
    params, log = run_experiment(
        args.strategy, cfg, rounds=args.rounds, eval_every=args.eval_every,
        target_acc=args.target_acc, device=args.device, **kw)
    print(f"[train:sim] {args.strategy}: acc={log.global_acc[-1]:.3f} "
          f"virtual_time={log.times[-1]:.0f}s "
          f"updates={log.update_counts}")
    fr = log.fairness()
    eps = {k: round(v[-1], 2) for k, v in log.eps_trajectory.items() if v}
    print(f"[train:sim] eps={eps} disparity={fr['privacy_disparity']:.1f}x "
          f"jain={fr['jain_participation']:.2f}")
    if args.ckpt_dir:
        ckpt.save(args.ckpt_dir, len(log.times), params,
                  meta={"strategy": args.strategy, "sigma": args.sigma,
                        "acc": log.global_acc[-1]})
        print(f"[train:sim] checkpoint -> {args.ckpt_dir}")
    if args.log_json:
        with open(args.log_json, "w") as f:
            json.dump({"acc": log.global_acc, "times": log.times,
                       "eps": {k: v for k, v in log.eps_trajectory.items()},
                       "updates": log.update_counts}, f, default=float)
    return 0


def parse_reduce(spec: str) -> dict:
    """``--reduce`` ("d_model=256,n_layers=4") -> config overrides, digits
    as ints, anything else as the string given."""
    overrides = {}
    for kv in spec.split(","):
        k, v = kv.split("=")
        overrides[k] = int(v) if v.isdigit() else v
    return overrides


def spmd_config(args):
    """The architecture config of ``--arch``, with ``--reduce``'s
    overrides in f32 (the JAX launcher's rule)."""
    from repro_torch.configs import get_config
    cfg = get_config(args.arch)
    if args.reduce:
        cfg = cfg.replace(param_dtype="float32", **parse_reduce(args.reduce))
    return cfg


def run_spmd(args, on_round=None):
    """``args.steps`` rounds of the production round over the synthetic
    token pipeline.  ``on_round(i, master, metrics)``, if given, is
    called after each round.  Returns the final master params."""
    import torch

    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.core.dp import DPConfig
    from repro_torch.core.fl_step import (
        FLStepConfig, make_fl_train_step, make_server_optimizer)
    from repro_torch.data.tokens import TokenDataConfig, make_batches
    from repro_torch.device import resolve_device
    from repro_torch.engine.engine import not_ported
    from repro_torch.models.base import get_family
    from repro_torch.pytree import tree_map

    if args.devices != 1:
        raise not_ported(f"spmd over --devices {args.devices}", 14)
    dev = resolve_device(args.device)
    cfg = spmd_config(args)
    fam = get_family(cfg.family)

    G = args.data_axis
    fl = FLStepConfig(
        num_clients=G, n_local=args.n_local, n_micro=args.n_micro,
        local_lr=args.local_lr, server_lr=args.server_lr,
        dp=DPConfig(clip_norm=args.clip, noise_multiplier=args.sigma,
                    granularity="per_microbatch"),
        compute_dtype=cfg.param_dtype,
    )
    master = tree_map(lambda l: l.float(),
                      fam.init_params(cfg, seed=args.seed, device=dev))

    def loss_fn(p, b):
        return fam.loss(p, b, cfg)

    step = make_fl_train_step(loss_fn, fl)
    opt_state = make_server_optimizer(fl).init(master)
    B = G * args.n_local * args.n_micro * args.per_micro
    data = make_batches(
        TokenDataConfig(vocab=cfg.vocab, seq_len=args.seq, seed=args.seed),
        num_batches=args.steps, batch_size=B)
    weights = torch.ones((G,), device=dev) / G

    @torch.no_grad()
    def eval_loss(p, b):
        return float(loss_fn(tree_map(lambda l: l.to(cfg.pdtype), p), b))

    for i, batch in enumerate(data):
        tb = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        if i % args.log_every == 0:
            print(f"[train:spmd] round {i:5d} "
                  f"loss {eval_loss(master, tb):.4f}", flush=True)
        master, opt_state, metrics = step(master, opt_state, tb, weights, i)
        if on_round is not None:
            on_round(i, master, metrics)
    final = eval_loss(master, tb)
    print(f"[train:spmd] final loss {final:.4f}")
    if args.ckpt_dir:
        ckpt.save(args.ckpt_dir, args.steps, master,
                  meta={"arch": args.arch, "loss": final})
        print(f"[train:spmd] checkpoint -> {args.ckpt_dir}")
    return master


def build_parser():
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="mode", required=True)

    sim = sub.add_parser("sim", help="paper testbed simulation")
    sim.add_argument("--strategy", default="fedasync",
                     choices=("fedavg", "fedasync", "fedasync_nostale",
                              "fedbuff", "adaptive_async"))
    sim.add_argument("--alpha", type=float, default=0.4)
    sim.add_argument("--sigma", type=float, default=1.0)
    sim.add_argument("--rounds", type=int, default=40)
    sim.add_argument("--max-updates", type=int, default=300)
    sim.add_argument("--batch", type=int, default=64)
    sim.add_argument("--n-total", type=int, default=2940)
    sim.add_argument("--eval-every", type=int, default=5)
    sim.add_argument("--target-acc", type=float, default=None)
    sim.add_argument("--seed", type=int, default=0)
    sim.add_argument("--ckpt-dir", default="")
    sim.add_argument("--log-json", default="")
    sim.add_argument("--device", default=None,
                     help="torch device (default: the card)")

    spmd = sub.add_parser("spmd", help="the production round, one device")
    spmd.add_argument("--arch", default="smollm-360m")
    spmd.add_argument("--devices", type=int, default=1)
    spmd.add_argument("--data-axis", type=int, default=4)
    spmd.add_argument("--steps", type=int, default=100)
    spmd.add_argument("--seq", type=int, default=128)
    spmd.add_argument("--n-local", type=int, default=1)
    spmd.add_argument("--n-micro", type=int, default=4)
    spmd.add_argument("--per-micro", type=int, default=2)
    spmd.add_argument("--local-lr", type=float, default=0.5)
    spmd.add_argument("--server-lr", type=float, default=5e-3)
    spmd.add_argument("--clip", type=float, default=10.0)
    spmd.add_argument("--sigma", type=float, default=0.02)
    spmd.add_argument("--seed", type=int, default=0)
    spmd.add_argument("--log-every", type=int, default=25)
    spmd.add_argument("--ckpt-dir", default="")
    spmd.add_argument("--reduce", default="",
                      help="comma list of cfg overrides, e.g. d_model=256")
    spmd.add_argument("--device", default=None,
                      help="torch device (default: the card)")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.mode == "sim":
        return run_sim(args)
    run_spmd(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
