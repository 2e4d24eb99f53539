"""Sharded cohort execution demo on the PyTorch port: the async engine's
cohort axis partitioned over the ranks of a process group.

    PYTHONPATH=src python examples/torch_mesh_cohort_demo.py --devices 2
    PYTHONPATH=src python examples/torch_mesh_cohort_demo.py --devices 4 \\
        --device cpu --executor fl_step

Starts N ranks (``torch.multiprocessing`` with ``spawn``; gloo on the
CPU and for several ranks sharing one card, NCCL with a card per rank),
builds a ("data", "model") mesh with every rank on the data axis, and
drives one federated SER workload through the cohort engine with
``client_axis="vmap"`` (or ``"fl_step"`` for the production
per-microbatch-DP round): a full-population cohort is split over the
ranks, each rank trains its members, and the ranks all-gather them in
member order.  Rank 0 prints the per-leaf shard occupancy
(``assert_cohort_partitioned``: the proof the axis is partitioned, not
replicated) and the accuracy/participation summary.
"""
import argparse
import sys


def rank_main(rank, args, port):
    import torch
    import torch.distributed as dist

    from repro_torch.core.testbed import (
        TestbedConfig, build_testbed, run_experiment)
    from repro_torch.data.synthetic_ser import SERDataConfig
    from repro_torch.engine import (
        CohortRunner, EngineConfig, assert_cohort_partitioned, cohort_mesh)
    from repro_torch.launch import collectives as coll

    n = args.devices
    dev_type = torch.device(args.device or "cuda").type
    cards = torch.cuda.device_count() if dev_type == "cuda" else 0
    device = coll.rank_device(dev_type, rank, cards)
    coll.init_group(coll.choose_backend(dev_type, n, cards), rank, n, port,
                    device)
    try:
        mesh = cohort_mesh()
        lead = rank == 0
        if lead:
            print(f"[mesh-cohorts] {n} ranks, mesh {mesh.shape}: "
                  f"{coll.describe(mesh.group, device)}", flush=True)
        cfg = TestbedConfig(num_clients=n, batch_size=32, sigma=args.sigma,
                            data=SERDataConfig(n_total=150 * n), seed=0)
        ec = EngineConfig(client_axis=args.executor, mesh=mesh, max_cohort=n,
                          staleness_window=1e9)
        if args.executor == "fl_step":
            from repro_torch.core.dp import DPConfig
            from repro_torch.core.fl_step import FLStepConfig
            ec = EngineConfig(client_axis="fl_step", mesh=mesh, max_cohort=n,
                              staleness_window=1e9,
                              fl_cfg=FLStepConfig(
                                  num_clients=n, n_micro=2, local_lr=0.02,
                                  dp=DPConfig(clip_norm=1.0,
                                              noise_multiplier=args.sigma,
                                              granularity="per_microbatch")))

        # 1) shard-shape proof: one full-population cohort through the runner
        clients, params, _, _ = build_testbed(cfg, device=device)
        runner = CohortRunner(clients, ec, device)
        plans = [runner.dispatch(c, params, 1000 + c.cid, 0) for c in clients]
        runner.run_cohort(plans)
        report = assert_cohort_partitioned(runner.last_partition, mesh)
        if lead:
            print(f"[mesh-cohorts] cohort of {n} partitioned: "
                  f"{len(report)} leaves x {set(report.values())} "
                  f"member(s)/rank", flush=True)

        # 2) the same config end to end through the run_experiment frontend
        _, log = run_experiment("fedasync", cfg, max_updates=args.updates,
                                alpha=0.4, eval_every=args.updates,
                                engine="cohort", engine_cfg=ec, device=device)
        if lead:
            eps = {t: round(v[-1], 2) for t, v in log.eps_trajectory.items()
                   if v}
            print(f"[mesh-cohorts] {sum(log.update_counts.values())} "
                  f"updates in cohorts of {sorted(set(log.cohort_sizes))}, "
                  f"final acc {log.global_acc[-1]:.3f}, eps per tier {eps}")
            st = log.engine_stats
            print(f"[mesh-cohorts] data path: {st['data_path']} — "
                  f"{st['h2d_bytes_per_cohort']:.0f} B/cohort over H2D "
                  f"({st['cohorts']} cohorts; index plans only on the "
                  f"arena path)")
            print(f"[mesh-cohorts] rank 0 collectives: {coll.stats()}")
    finally:
        dist.destroy_process_group()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, default=2,
                    help="ranks of the mesh")
    ap.add_argument("--executor", default="vmap",
                    choices=("vmap", "fl_step"))
    ap.add_argument("--updates", type=int, default=16)
    ap.add_argument("--sigma", type=float, default=1.0)
    ap.add_argument("--device", default=None,
                    help="torch device type (default: the card)")
    args = ap.parse_args()
    import torch.multiprocessing as mp

    from repro_torch.launch.collectives import free_port
    mp.start_processes(rank_main, args=(args, free_port()),
                       nprocs=args.devices, start_method="spawn")
    return 0


if __name__ == "__main__":
    sys.exit(main())
