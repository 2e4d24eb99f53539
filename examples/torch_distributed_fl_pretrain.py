"""Distributed FL pretraining of a small language model with DP on the
PyTorch port: the production round (``core/fl_step.py``) over the data
axis of a process group's ranks.

    PYTHONPATH=src python examples/torch_distributed_fl_pretrain.py \\
        --steps 200 --devices 2 --data-axis 2
    PYTHONPATH=src python examples/torch_distributed_fl_pretrain.py \\
        --steps 50 --devices 4 --data-axis 4 --device cpu
    # a model axis: 2 clients, each model tensor-parallel over 2 ranks
    PYTHONPATH=src python examples/torch_distributed_fl_pretrain.py \\
        --steps 50 --devices 4 --data-axis 2 --device cpu
    # the JAX example's own mesh: 4 clients x a model axis of 2
    PYTHONPATH=src python examples/torch_distributed_fl_pretrain.py \\
        --steps 50 --devices 8 --data-axis 4 --device cpu

Starts N ranks (``torch.multiprocessing`` with ``spawn``; gloo on the
CPU and for several ranks sharing one card, NCCL with a card per rank),
builds a ("data", "model") mesh of ``--data-axis`` x ``--devices /
--data-axis`` ranks, and runs ``fl_train_step`` (per-client DP-SGD +
weighted aggregation, one client group per data coordinate, the f32
master and FedAdam's state ZeRO-sharded over the data axis, each
client's model tensor-parallel over its model group) on a reduced
smollm-family LM over the synthetic token pipeline.  Loss decreasing over
a few hundred federated rounds shows the stack (model zoo, sharding
rules, tensor parallelism, DP clipping, server Adam, checkpointing)
working end to end.
"""
import argparse
import sys


def rank_main(rank, args, port):
    import torch
    import torch.distributed as dist

    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.configs import get_config
    from repro_torch.core.dp import DPConfig
    from repro_torch.core.fl_step import (
        FLStepConfig, gather_master, make_fl_train_step,
        make_server_optimizer, master_dims, shard_master)
    from repro_torch.data.tokens import TokenDataConfig, make_batches
    from repro_torch.launch import collectives as coll
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.shardings import tree_shardings
    from repro_torch.models import layers
    from repro_torch.models.base import get_family
    from repro_torch.pytree import tree_map

    G = args.data_axis
    dev_type = torch.device(args.device or "cuda").type
    cards = torch.cuda.device_count() if dev_type == "cuda" else 0
    device = coll.rank_device(dev_type, rank, cards)
    coll.init_group(coll.choose_backend(dev_type, args.devices, cards), rank,
                    args.devices, port, device)
    try:
        mesh = make_host_mesh(data=G, model=args.devices // G)
        lead = rank == 0
        if lead:
            print(f"[fl-pretrain] mesh {mesh.shape}: "
                  f"{coll.describe(None, device)}", flush=True)
        cfg = get_config("smollm-360m").replace(
            n_layers=args.layers, d_model=args.d_model, n_heads=4,
            n_kv_heads=2, d_head=args.d_model // 4, d_ff=2 * args.d_model,
            vocab=2048, param_dtype="float32")
        fam = get_family(cfg.family)
        tp = mesh.shape["model"] > 1
        layers.set_mesh_context(mesh, cfg=cfg)

        # DP granularity note (the reference example's): per-microbatch
        # clipping clips a whole-model mean gradient, so the clip is looser
        # than the paper's per-example C = 1, and sigma is small for a
        # 200-round demo
        fl = FLStepConfig(
            num_clients=G, n_local=1, n_micro=4, local_lr=0.5,
            server_lr=5e-3,
            dp=DPConfig(clip_norm=args.clip, noise_multiplier=args.sigma,
                        granularity="per_microbatch"),
            compute_dtype="float32")
        params = fam.init_params(cfg, seed=0, device=device)
        stacked = tree_map(lambda l: torch.empty(
            (G,) + tuple(l.shape), device="meta"), params)
        client_sh = tree_shardings(stacked, cfg, mesh, role="client")
        master_sh = tree_shardings(params, cfg, mesh, role="master")
        params = shard_master(params, master_sh)
        step = make_fl_train_step(lambda p, b: fam.loss(p, b, cfg), fl,
                                  client_shardings=client_sh,
                                  master_shardings=master_sh)
        opt_state = make_server_optimizer(fl).init(params)
        B = G * 8  # 8 sequences per client round (4 microbatches of 2)
        data = make_batches(
            TokenDataConfig(vocab=cfg.vocab, seq_len=args.seq, seed=0),
            num_batches=args.steps, batch_size=B)
        weights = torch.ones((G,), device=device) / G

        @torch.no_grad()
        def eval_loss(b):
            if tp:
                # tensor-parallel: every rank evaluates its model blocks
                mine = coll.all_gather_tree(params, master_dims(master_sh),
                                            mesh.group)
                return float(fam.loss(mine, b, cfg))
            whole = gather_master(params, master_sh)   # every rank gathers
            return float(fam.loss(whole, b, cfg)) if lead else None

        first_loss = None
        for i, batch in enumerate(data):
            tb = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
            if i % 25 == 0 or i == args.steps - 1:
                loss = eval_loss(tb)
                if lead:
                    first_loss = first_loss if first_loss is not None else loss
                    print(f"[fl-pretrain] round {i:4d} loss {loss:.4f}",
                          flush=True)
            params, opt_state, _ = step(params, opt_state, tb, weights, i)
        final_loss = eval_loss(tb)
        whole = gather_master(params, master_sh)
        if lead:
            ckpt.save(args.ckpt_dir, args.steps, whole,
                      meta={"sigma": args.sigma, "final_loss": final_loss})
            print(f"[fl-pretrain] loss {first_loss:.4f} -> {final_loss:.4f} "
                  f"({args.steps} federated rounds, G={G} clients on "
                  f"{args.devices} ranks, DP sigma={args.sigma}); "
                  f"checkpoint in {args.ckpt_dir}")
            assert final_loss < first_loss, "training did not reduce loss"
    finally:
        layers.clear_mesh_context()
        dist.destroy_process_group()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--devices", type=int, default=2)
    ap.add_argument("--data-axis", type=int, default=2)
    ap.add_argument("--sigma", type=float, default=0.02)
    ap.add_argument("--clip", type=float, default=10.0)
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default="results/fl_pretrain_ckpt_torch")
    ap.add_argument("--device", default=None,
                    help="torch device type (default: the card)")
    args = ap.parse_args()
    if args.devices % args.data_axis:
        raise ValueError(f"--devices {args.devices} is not a multiple of "
                         f"--data-axis {args.data_axis}")
    import torch.multiprocessing as mp

    from repro_torch.launch.collectives import free_port
    mp.start_processes(rank_main, args=(args, free_port()),
                       nprocs=args.devices, start_method="spawn")
    return 0


if __name__ == "__main__":
    sys.exit(main())
