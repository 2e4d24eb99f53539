"""Training launcher (port of ``repro/launch/train.py``): the two faces of
the framework behind one CLI, on the card unless ``--device cpu``.

Simulation mode (the paper's experiment):
    PYTHONPATH=src python -m repro_torch.launch.train sim \\
        --strategy fedasync --alpha 0.4 --sigma 1.0 --rounds 40 \\
        --ckpt-dir results/ckpt_sim

SPMD mode: the production round (``core/fl_step.py``).  With
``--devices 1`` (the default) the ``--data-axis`` clients run one after
another on one device:
    PYTHONPATH=src python -m repro_torch.launch.train spmd \\
        --arch smollm-360m --data-axis 4 --steps 100 \\
        --reduce d_model=256,n_layers=4,vocab=2048

With ``--devices N --data-axis G`` the round runs on a ("data", "model")
mesh of N ranks, G x N/G (``launch/mesh.py``): one client group per data
coordinate, the f32 master and FedAdam's state ZeRO-sharded over the
data axis (``launch/shardings.py``'s ``role="master"`` rule) and, where
N/G is above 1, each client's model tensor-parallel over the N/G ranks
of its model group (every family; the leaves the rule names ``"model"``
cut in blocks, ``models/layers.py``):
    PYTHONPATH=src python -m repro_torch.launch.train spmd \\
        --arch smollm-360m --devices 2 --data-axis 2 --steps 100
    PYTHONPATH=src python -m repro_torch.launch.train spmd \\
        --arch olmoe-1b-7b --devices 4 --data-axis 2 --steps 100

The launcher starts the N ranks itself (``torch.multiprocessing`` with
the ``spawn`` start method, a rendezvous on a free localhost port), or,
run under ``torchrun --nproc-per-node N`` on one host, joins the group
``torchrun`` describes (``RANK``, ``WORLD_SIZE``, ``MASTER_PORT``).  The
backend follows ``collectives.choose_backend``, printed by rank 0: NCCL
with one card per rank, gloo on the CPU and for several ranks sharing a
card (``spmd_rank(backend=...)`` names one outright).

The flags and output lines are the JAX launcher's, printed by rank 0
(plus one line naming the mesh and the backend); on a model axis every
rank evaluates the logged losses with its model group (the loss is
tensor-parallel too).  Rank 0 writes the checkpoint, the master gathered
whole over both axes, in the reference's flat-npz format.  The master
params are kept in f32 (``make_fl_train_step``'s master) and the clients compute in
the config's param dtype; the JAX launcher passes its init params, in
the param dtype, as the master.  ``--device`` is the port's own flag.
"""
from __future__ import annotations

import argparse
import json
import os
import sys


def run_sim(args):
    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.core.testbed import TestbedConfig, run_experiment
    from repro_torch.data.synthetic_ser import SERDataConfig
    from repro_torch.launch.mesh import is_writer

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
    if args.ckpt_dir and is_writer():
        ckpt.save(args.ckpt_dir, len(log.times), params,
                  meta={"strategy": args.strategy, "sigma": args.sigma,
                        "acc": log.global_acc[-1]})
        print(f"[train:sim] checkpoint -> {args.ckpt_dir}")
    if args.log_json and is_writer():
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


def stub_inputs(cfg, batch_size: int, seed) -> dict:
    """One batch's stubbed modality inputs (``models.base.input_specs``):
    the audio family's encoder frames, the VLM family's patch
    embeddings; standard normal f32 from numpy seeded by ``seed``, the
    same on every rank; nothing for the other families.  The JAX
    launcher feeds tokens and labels only, which those two families'
    losses cannot take."""
    import numpy as np
    rng = np.random.default_rng(seed)
    out = {}
    if cfg.family == "audio":
        out["frames"] = rng.standard_normal(
            (batch_size, cfg.enc_frames, cfg.d_model), dtype=np.float32)
    if cfg.family == "vlm":
        out["patches"] = rng.standard_normal(
            (batch_size, cfg.n_patches, cfg.d_model), dtype=np.float32)
    return out


def run_spmd(args, on_round=None, cfg=None, client_placement="tp"):
    """``args.steps`` rounds of the production round over the synthetic
    token pipeline.  ``on_round(i, master, metrics)``, if given, is
    called after each round (``master``: this rank's shards on a mesh).
    ``cfg`` is the architecture config to train in place of
    ``spmd_config(args)`` (a caller's cut of it).
    ``client_placement="dp"`` is the reference dry run's one-client-per-
    chip placement: on a mesh of N ranks, G = N clients, each client's
    model whole on its rank (``core/fl_step.py``,
    ``role="client_all_axes"``); the master stays cut in blocks over both
    axes.  The JAX launcher has no such flag, so neither has this one.

    ``--devices 1`` runs in this process and returns the final master
    params.  ``--devices N`` joins the process group when run under
    ``torchrun`` (returning this rank's whole final master), and
    otherwise spawns the N ranks and returns None once they have ended
    (``on_round`` is then not passed to them)."""
    if args.devices > 1 and args.devices % args.data_axis:
        raise ValueError(
            f"spmd --devices {args.devices} is not a multiple of "
            f"--data-axis {args.data_axis}: the mesh is data x model")
    if args.devices == 1:
        return _run_spmd(args, None, args.device, on_round, cfg,
                         client_placement)
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        if int(os.environ["WORLD_SIZE"]) != args.devices:
            raise ValueError(
                f"torchrun started {os.environ['WORLD_SIZE']} ranks for "
                f"--devices {args.devices}")
        return spmd_rank(args, int(os.environ["RANK"]),
                         int(os.environ["MASTER_PORT"]), on_round=on_round,
                         cfg=cfg, client_placement=client_placement)
    import torch.multiprocessing as mp
    from repro_torch.launch.collectives import free_port
    mp.start_processes(_spawned_rank,
                       args=(args, free_port(), cfg, client_placement),
                       nprocs=args.devices, start_method="spawn")
    return None


def _spawned_rank(rank, args, port, cfg, client_placement):
    spmd_rank(args, rank, port, cfg=cfg, client_placement=client_placement)


def spmd_rank(args, rank: int, port: int, backend=None, on_round=None,
              cfg=None, client_placement="tp"):
    """Rank ``rank`` of ``args.devices``: join the group at
    ``tcp://localhost:<port>`` (the backend by ``choose_backend`` unless
    given), run the round on the mesh, leave the group.  Returns the
    whole final master."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch import collectives as coll
    from repro_torch.launch.mesh import make_host_mesh
    world = args.devices
    dev_type = torch.device(args.device or "cuda").type
    cards = torch.cuda.device_count() if dev_type == "cuda" else 0
    backend = backend or coll.choose_backend(dev_type, world, cards)
    device = coll.rank_device(dev_type, rank, cards)
    coll.init_group(backend, rank, world, port, device)
    try:
        mesh = make_host_mesh(data=args.data_axis,
                              model=world // args.data_axis)
        if rank == 0:
            print(f"[train:spmd] mesh {mesh.shape} over {world} ranks: "
                  f"{coll.describe(None, device)}", flush=True)
        return _run_spmd(args, mesh, device, on_round, cfg,
                         client_placement)
    finally:
        dist.destroy_process_group()


def _run_spmd(args, mesh, device, on_round, cfg=None,
              client_placement="tp"):
    from repro_torch.models import layers

    cfg = cfg or spmd_config(args)
    if mesh is None:
        return _spmd_rounds(args, None, device, on_round, cfg, "tp")
    # the layers read the model axis from the mesh context, as in the
    # JAX launcher (no batch constraints inside a client); with one
    # client per rank the round sets it aside for the local phase
    layers.set_mesh_context(mesh, cfg=cfg)
    try:
        return _spmd_rounds(args, mesh, device, on_round, cfg,
                            client_placement)
    finally:
        layers.clear_mesh_context()


def _spmd_rounds(args, mesh, device, on_round, cfg, client_placement):
    import contextlib

    import torch

    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.core.dp import DPConfig
    from repro_torch.core.fl_step import (
        FLStepConfig, gather_master, make_fl_train_step,
        make_server_optimizer, master_dims, shard_master)
    from repro_torch.data.tokens import TokenDataConfig, make_batches
    from repro_torch.device import resolve_device
    from repro_torch.launch import collectives as coll
    from repro_torch.launch.shardings import tree_shardings
    from repro_torch.models import layers
    from repro_torch.models.base import get_family
    from repro_torch.pytree import tree_map

    dev = resolve_device(device)
    fam = get_family(cfg.family)
    lead = mesh is None or (mesh.rank == 0 and mesh.model_rank == 0)
    dp = mesh is not None and client_placement == "dp"
    # on a model axis the loss is tensor-parallel: every rank evaluates
    # (with one client per rank the lead evaluates the whole master)
    tp = mesh is not None and mesh.shape["model"] > 1 and not dp
    evaluates = lead or tp

    G = mesh.size if dp else args.data_axis
    fl = FLStepConfig(
        num_clients=G, n_local=args.n_local, n_micro=args.n_micro,
        local_lr=args.local_lr, server_lr=args.server_lr,
        dp=DPConfig(clip_norm=args.clip, noise_multiplier=args.sigma,
                    granularity="per_microbatch"),
        compute_dtype=cfg.param_dtype,
    )
    master = tree_map(lambda l: l.float(),
                      fam.init_params(cfg, seed=args.seed, device=dev))
    client_sh = master_sh = None
    if mesh is not None:
        stacked = tree_map(lambda l: torch.empty(
            (G,) + tuple(l.shape), dtype=l.dtype, device="meta"), master)
        client_sh = tree_shardings(
            stacked, cfg, mesh, role="client_all_axes" if dp else "client")
        master_sh = tree_shardings(master, cfg, mesh, role="master")
        master = shard_master(master, master_sh)

    def loss_fn(p, b):
        return fam.loss(p, b, cfg)

    step = make_fl_train_step(loss_fn, fl, client_shardings=client_sh,
                              master_shardings=master_sh)
    opt_state = make_server_optimizer(fl).init(master)
    B = G * args.n_local * args.n_micro * args.per_micro
    data = make_batches(
        TokenDataConfig(vocab=cfg.vocab, seq_len=args.seq, seed=args.seed),
        num_batches=args.steps, batch_size=B)
    weights = torch.ones((G,), device=dev) / G

    @torch.no_grad()
    def eval_loss(params, b):
        with layers.no_mesh_context() if dp else contextlib.nullcontext():
            return float(loss_fn(tree_map(lambda l: l.to(cfg.pdtype),
                                          params), b))

    def eval_params(dtype=None):
        """What the loss is evaluated on: the whole master (every rank
        gathers), or on a model axis this rank's model blocks of it."""
        cast = master if dtype is None else tree_map(
            lambda l: l.to(dtype), master)
        if tp:
            return coll.all_gather_tree(cast, master_dims(master_sh),
                                        mesh.group)
        return gather_master(cast, master_sh)

    for i, batch in enumerate(data):
        tb = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        tb.update({k: torch.from_numpy(v).to(dev, cfg.pdtype) for k, v in
                   stub_inputs(cfg, B, [args.seed, i]).items()})
        if i % args.log_every == 0:
            params = eval_params(cfg.pdtype)
            if evaluates:
                loss = eval_loss(params, tb)
                if lead:
                    print(f"[train:spmd] round {i:5d} loss {loss:.4f}",
                          flush=True)
            del params
        master, opt_state, metrics = step(master, opt_state, tb, weights, i)
        if on_round is not None:
            on_round(i, master, metrics)
    del opt_state
    final = eval_loss(eval_params(), tb) if tp else None
    final_master = gather_master(master, master_sh)
    if lead and not tp:
        final = eval_loss(final_master, tb)
    if lead:
        print(f"[train:spmd] final loss {final:.4f}")
        if args.ckpt_dir:
            ckpt.save(args.ckpt_dir, args.steps, final_master,
                      meta={"arch": args.arch, "loss": final})
            print(f"[train:spmd] checkpoint -> {args.ckpt_dir}")
    return final_master


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

    spmd = sub.add_parser("spmd", help="the production round")
    spmd.add_argument("--arch", default="smollm-360m")
    spmd.add_argument("--devices", type=int, default=1,
                      help="ranks of the mesh (1: this process)")
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
                      help="torch device type (default: the card)")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.mode == "sim":
        return run_sim(args)
    run_spmd(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
