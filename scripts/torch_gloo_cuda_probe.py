"""Which collectives a gloo group runs on CUDA tensors, and DTensor over
such a group: two ranks on cuda:0 (one card), one pair of processes per
case, so a case that kills its ranks leaves the others to run.

    python3 scripts/torch_gloo_cuda_probe.py

Prints one line per case (``ok`` with the result, ``raised`` with the
error, or ``died`` with the exit signal), then the card's name and power
limit.  Needs a CUDA card; the port's model axis stages every CUDA
collective through host memory (``launch/collectives.py``) because of
what this shows.
"""
import socket
import subprocess
import sys

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _case(name, dev):
    x = torch.full((4,), float(dist.get_rank() + 1), device=dev)
    if name == "all_gather_into_tensor":
        out = torch.empty(8, device=dev)
        dist.all_gather_into_tensor(out, x)
        return out.tolist()
    if name == "reduce_scatter_tensor":
        out = torch.empty(2, device=dev)
        dist.reduce_scatter_tensor(out, x)
        return out.tolist()
    if name in ("all_reduce", "all_reduce_max"):
        op = dist.ReduceOp.MAX if name == "all_reduce_max" else \
            dist.ReduceOp.SUM
        y = x.clone()
        dist.all_reduce(y, op=op)
        return y.tolist()
    if name == "broadcast":
        y = x.clone()
        dist.broadcast(y, 0)
        return y.tolist()
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    mesh = init_device_mesh("cuda", (2,), mesh_dim_names=("model",))
    gen = torch.Generator(dev).manual_seed(0)
    a = torch.randn(8, 6, device=dev, generator=gen)
    w = torch.randn(6, 4, device=dev, generator=gen)
    if name == "dtensor_column_parallel_backward":
        dw = distribute_tensor(w, mesh, [Shard(1)]).requires_grad_()
        y = distribute_tensor(a, mesh, [Replicate()]) @ dw
        (y.redistribute(mesh, [Replicate()]) ** 2).sum().backward()
        ref = w.clone().requires_grad_()
        ((a @ ref) ** 2).sum().backward()
        return float((dw.grad.full_tensor() - ref.grad).abs().max())
    if name == "dtensor_row_parallel_partial":
        y = (distribute_tensor(a, mesh, [Shard(1)])
             @ distribute_tensor(w, mesh, [Shard(0)]))
        whole = y.redistribute(mesh, [Replicate()]).to_local()
        return float((whole - a @ w).abs().max())
    raise ValueError(name)


CASES = ("all_reduce", "all_reduce_max", "broadcast",
         "all_gather_into_tensor", "reduce_scatter_tensor",
         "dtensor_column_parallel_backward", "dtensor_row_parallel_partial")


def _rank(rank, port, name):
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=2)
    try:
        got = _case(name, torch.device("cuda", 0))
        if rank == 0:
            print(f"[gloo-cuda] {name}: ok {got}", flush=True)
    except Exception as e:                   # noqa: BLE001 (reported)
        if rank == 0:
            print(f"[gloo-cuda] {name}: raised {type(e).__name__}: "
                  f"{str(e)[:200]}", flush=True)
    finally:
        dist.destroy_process_group()


def main():
    if not torch.cuda.is_available():
        sys.exit("no CUDA card")
    print(f"[gloo-cuda] torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)
    for name in CASES:
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        try:
            mp.start_processes(_rank, args=(port, name), nprocs=2,
                               start_method="spawn")
        except mp.ProcessExitedException as e:
            print(f"[gloo-cuda] {name}: died ({e})", flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0])


if __name__ == "__main__":
    main()
