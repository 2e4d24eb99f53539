"""The production meshes' dry run (port of ``repro/launch/dryrun.py``):
trace one rank's program of every (architecture x input shape x
production mesh) combination on ``meta`` tensors, and read its memory,
FLOPs and collectives.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma2-2b \\
        --shape train_4k --mesh single            # one combination
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all  # the matrix

Results land in ``results/dryrun_torch/<arch>__<shape>__<mesh>.json``.

The JAX package lowers and compiles each program with XLA for 256 or 512
forced host devices and reads the compiled artifact.  PyTorch has no
such artifact, so the port runs the program itself, on one rank:
:func:`run_one` starts a fake process group of the mesh's size
(``torch.testing._internal.distributed.fake_pg``, backend ``"fake"``) at
one rank (``--rank``, default 0), builds that rank's params, optimizer
state, caches and batch on ``meta`` (their blocks under
``launch/shardings.py``'s rules and ``launch/serve.py``'s placement) and
runs the step.  Nothing is computed on meta: every op makes only its
output's shape, the kernels take their plain versions
(``kernels/common.py``) and every collective its output shape
(``launch/collectives.py``).  What the JSON holds, beside the
reference's:

* ``memory.argument_size_bytes``: the rank's input blocks, exact;
  ``output_size_bytes``: its outputs (a decode step's cache, updated in
  place, counts as an output, as XLA's donated cache does);
  ``temp_size_bytes``: the peak of live storage made during the step
  (``torch.distributed._tools.mem_tracker.MemTracker``), the eager peak
  with no buffer reuse, where XLA's is the compiled program's;
* ``cost.flops``: ``torch.utils.flop_counter.FlopCounterMode``'s count
  of the rank's matrix products (the plain kernels' products counted as
  the kernels' own contractions), the backward's recompute of every
  rematerialized unit included, as XLA's count includes it; XLA's also
  counts elementwise work;
* ``collectives``: ``{"bytes", "counts"}`` per kind, from
  ``collectives.stats()``: every call the rank makes, each one's input
  bytes (XLA's parse sums each op's output bytes, once per static op);
* ``walk``: :func:`repro_torch.analysis.hlo.analyze` of the same run,
  the reference's keys: ``dot_flops`` (``cost.flops``),
  ``collective_counts`` (``collectives.counts``), per-kind
  ``collective_traffic_bytes`` (each call's input bytes times the ring
  multiplier of its group's size) and ``total_collective_bytes``;
  ``hbm_bytes`` is None (``not_ported``);
* ``hlo_ops``: None; the port emits no HLO (``not_ported``).

The reference's training knobs: ``--remat-policy dots``
(``models.transformer.set_remat_policy``: the dense and VLM layers save
their 2-D matrix products; every family rematerializes its training
forward whatever the policy) and ``--client-placement dp`` (one client
per rank, G = all the mesh's ranks, each client's model whole on its
rank: ``role="client_all_axes"`` client shardings in
``core/fl_step.py``).  On ``train_4k``'s 256 rows that is one row per
client on the single pod, so the placement caps ``--n-micro`` at the
rows a client has (the reference's own ``split_batch`` refuses 1 row in
4 microbatches); the JSON records the ``n_micro`` run, the policy and
the placement.  ``--attn-shard heads_padded`` (GSPMD's padded uneven
heads: the leaf rule cuts the head counts first, 56 query heads over 16
ranks as 16 blocks of 4 slots) runs the attention of every family on
each rank's real query heads (``models/layers.py``) and ``flash_decode``
on the GQA groups they read; the option is set for the combination and
restored after it.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

RESULTS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "..", "..", "..", "results", "dryrun_torch")

# collectives.stats() names -> the reference's collective kinds
KINDS = {"all_gather": "all-gather", "all_reduce": "all-reduce",
         "reduce_scatter": "reduce-scatter"}
NOTES = {
    "memory": "argument: this rank's input blocks; output: its outputs; "
              "temp: peak live storage made during the eager step (no "
              "buffer reuse; the plain kernels' temporaries count, which "
              "the CUDA kernels do not make), not XLA's compiled temp",
    "flops": "FlopCounterMode: matrix products only (plain kernels' "
             "products counted as the kernels' contractions), the "
             "backward's recompute included",
    "collectives": "every call this rank makes, bytes of its input "
                   "buffers per call",
}

def _not_ported() -> dict:
    from repro_torch.analysis.hlo import NOT_PORTED
    return {"walk.hbm_bytes": NOT_PORTED["hbm_bytes"],
            "hlo_ops": NOT_PORTED["hlo_ops"]}


def applicable(arch_id: str, shape_name: str) -> bool:
    from repro_torch.configs import LONG_CONTEXT_ARCHS
    if shape_name == "long_500k":
        return arch_id in LONG_CONTEXT_ARCHS
    return True


@contextlib.contextmanager
def fake_group(world: int, rank: int = 0):
    """A fake process group of ``world`` ranks, this process at ``rank``
    (collectives move nothing); destroyed on exit."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise ValueError("the dry run starts its own fake process group, "
                         "and one is already initialized")
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _nbytes(tree) -> int:
    import torch
    from repro_torch.pytree import tree_leaves
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def _meta_noise(client, step, leaf, shape):
    import torch
    return torch.empty(tuple(shape), device="meta")


def client_groups(mesh, client_placement: str = "tp") -> int:
    """G of the round: the data-axis product, or with ``"dp"`` all the
    mesh's ranks (the reference's ``build_train``)."""
    from repro_torch.launch.mesh import num_client_groups
    return mesh.size if client_placement == "dp" else num_client_groups(mesh)


def train_micro(shape, G: int, n_micro: int, client_placement: str) -> int:
    """The microbatches per local step: ``n_micro``, capped under the
    ``"dp"`` placement at the rows a client has."""
    if client_placement == "dp":
        return max(1, min(n_micro, shape.global_batch // G))
    return n_micro


def build_train(arch_id, cfg, shape, mesh, n_micro: int = 4,
                client_placement: str = "tp"):
    """The production round (``core/fl_step.py``) on ``mesh``: -> (step,
    its arguments, the bytes of this rank's input blocks).  With
    ``client_placement="dp"`` the clients span every axis (G = all the
    mesh's ranks, ``role="client_all_axes"``, the batch's rows split over
    every rank) and ``n_micro`` is capped by :func:`train_micro`."""
    import torch
    from repro_torch.core.dp import DPConfig
    from repro_torch.core.fl_step import (
        FLStepConfig, make_fl_train_step, make_server_optimizer,
        shard_master)
    from repro_torch.launch.shardings import tree_shardings
    from repro_torch.models.base import get_family, input_specs
    from repro_torch.pytree import tree_map
    fam = get_family(cfg.family)
    G = client_groups(mesh, client_placement)
    n_micro = train_micro(shape, G, n_micro, client_placement)
    fl = FLStepConfig(num_clients=G, n_local=1, n_micro=n_micro,
                      dp=DPConfig(clip_norm=1.0, noise_multiplier=1.0,
                                  granularity="per_microbatch"),
                      compute_dtype=cfg.param_dtype)
    # master params are f32
    master = tree_map(lambda l: torch.empty(
        tuple(l.shape), dtype=torch.float32, device="meta"),
        fam.init_params(cfg, 0, device="meta"))
    stacked = tree_map(lambda l: torch.empty(
        (G,) + tuple(l.shape), dtype=l.dtype, device="meta"), master)
    client_sh = tree_shardings(
        stacked, cfg, mesh,
        role="client_all_axes" if client_placement == "dp" else "client")
    master_sh = tree_shardings(master, cfg, mesh, role="master")
    local = shard_master(master, master_sh)
    step = make_fl_train_step(lambda p, b: fam.loss(p, b, cfg), fl,
                              client_shardings=client_sh,
                              master_shardings=master_sh)
    opt = make_server_optimizer(fl).init(local)
    batch = input_specs(cfg, shape)        # the global batch
    weights = torch.empty((G,), device="meta")
    arg_bytes = (_nbytes(local) + _nbytes(opt) + _nbytes(weights)
                 + _nbytes(batch) // G)    # this rank's rows of the batch
    return step, (local, opt, batch, weights, _meta_noise), arg_bytes


def _serve_inputs(cfg, shape, mesh):
    from repro_torch.launch import serve
    from repro_torch.models.base import get_family, input_specs
    params = serve.place_params(
        get_family(cfg.family).init_params(cfg, 0, device="meta"), cfg,
        mesh)
    return params, serve.rows(input_specs(cfg, shape), mesh,
                              shape.global_batch)


def build_prefill(arch_id, cfg, shape, mesh):
    """A prefill of the shape's batch into a fresh cache, as served on
    ``mesh`` (``launch/serve.py``)."""
    from repro_torch.launch import serve
    from repro_torch.models.base import get_family
    fam = get_family(cfg.family)
    B, S = shape.global_batch, shape.seq_len
    params, batch = _serve_inputs(cfg, shape, mesh)

    def step(params, batch):
        cache = serve.init_cache(cfg, B, S, mesh, device="meta")
        return fam.prefill(params, batch, cfg, cache)

    return step, (params, batch), _nbytes(params) + _nbytes(batch)


def build_decode(arch_id, cfg, shape, mesh):
    """One decode step over a cache of the shape's length, as served on
    ``mesh``."""
    from repro_torch.launch import serve
    from repro_torch.models.base import get_family
    fam = get_family(cfg.family)
    B, S = shape.global_batch, shape.seq_len
    params, specs = _serve_inputs(cfg, shape, mesh)
    cache = serve.init_cache(cfg, B, S, mesh, device="meta")

    def step(params, cache, token, pos):
        return fam.decode_step(params, cache, token, pos, cfg)

    args = (params, cache, specs["token"], specs["pos"])
    return step, args, sum(_nbytes(a) for a in args)


def measure(step, args, train: bool):
    """Run ``step(*args)`` once (under autograd when ``train``, else under
    ``no_grad``) -> (its output, the peak of live storage it made, its
    matrix-product FLOPs, the trace's seconds); ``collectives.stats()``
    then holds its collectives."""
    import torch
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.launch import collectives as coll
    coll.reset_stats()
    tracker = MemTracker()
    t1 = time.time()
    with FlopCounterMode(display=False) as flops, tracker, \
            contextlib.nullcontext() if train else torch.no_grad():
        out = step(*args)
    peak = sum(d.get("Total", 0) for d in
               tracker.get_tracker_snapshot("peak").values())
    return out, int(peak), int(flops.get_total_flops()), time.time() - t1


def _collectives(st) -> dict:
    return {"bytes": {KINDS.get(k, k): v["bytes"] for k, v in st.items()},
            "counts": {KINDS.get(k, k): v["calls"] for k, v in st.items()}}


def run_one(arch_id: str, shape_name: str, mesh_kind: str,
            n_micro: int = 4, tag: str = "", attn_shard: str = "even",
            expert_pad: int = 0, remat_policy: str = "",
            train_batch_constraints: bool = True,
            client_placement: str = "tp", rank: int = 0) -> dict:
    """One combination on rank ``rank`` of a fake group of the mesh's
    size.  ``train_batch_constraints`` changes nothing: the port never
    splits a client's microbatch over the data axes.  ``remat_policy``
    and ``client_placement`` are the reference's training knobs (module
    docstring).  A failure of the step is recorded (``"status":
    "error"``), as the reference records its lowering's."""
    from repro_torch.analysis.hlo import analyze
    from repro_torch.configs import get_config
    from repro_torch.launch import collectives as coll
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.shardings import _OPTS, set_sharding_options
    from repro_torch.models import layers as L
    from repro_torch.models.base import INPUT_SHAPES
    from repro_torch.models.transformer import set_remat_policy

    shape = INPUT_SHAPES[shape_name]
    cfg = get_config(arch_id, long_variant=(shape_name == "long_500k"))
    if expert_pad and cfg.n_experts:
        cfg = cfg.replace(expert_pad=expert_pad)
    multi = mesh_kind == "multipod"
    train = shape.kind == "train"
    head = {"arch": arch_id, "shape": shape_name, "mesh": mesh_kind,
            "tag": tag, "rank": rank, "remat_policy": remat_policy or None,
            "client_placement": client_placement, "attn_shard": attn_shard}
    t0 = time.time()
    set_remat_policy(remat_policy or None)
    saved = _OPTS["attn_shard"]
    set_sharding_options(attn_shard=attn_shard)
    with fake_group(512 if multi else 256, rank):
        mesh = make_production_mesh(multi_pod=multi)
        try:
            if train:
                if client_placement != "dp":
                    # the reference's attn_axis="none" under "dp": each
                    # client's model runs whole, with no mesh context
                    L.set_mesh_context(mesh, cfg=cfg)
                ctx = contextlib.nullcontext()
                build = build_train
                G = client_groups(mesh, client_placement)
                kw = {"n_micro": n_micro,
                      "client_placement": client_placement}
                head["n_micro"] = train_micro(shape, G, n_micro,
                                              client_placement)
            else:
                ctx = serve.context(mesh, cfg, shape.global_batch)
                build = (build_prefill if shape.kind == "prefill"
                         else build_decode)
                kw = {}
            with ctx:
                step, args, arg_bytes = build(arch_id, cfg, shape, mesh,
                                              **kw)
                out, peak, flops, t_run = measure(step, args, train)
                result = dict(head, **{
                    "status": "ok", "mesh_shape": mesh.shape,
                    "trace_s": round(t_run, 1),
                    "memory": {"argument_size_bytes": int(arg_bytes),
                               "output_size_bytes": _nbytes(out),
                               "temp_size_bytes": peak,
                               "generated_code_size_bytes": None},
                    "cost": {"flops": flops},
                    "collectives": _collectives(coll.stats()),
                    "walk": analyze(coll.stats(), flops), "hlo_ops": None,
                    "not_ported": _not_ported(), "notes": NOTES})
        except Exception as e:  # noqa: BLE001 — recorded, as the reference
            result = dict(head, **{
                "status": "error",
                "error": f"{type(e).__name__}: {str(e)[:2000]}",
                "elapsed_s": round(time.time() - t0, 1)})
        finally:
            L.clear_mesh_context()
            set_remat_policy(None)
            set_sharding_options(attn_shard=saved)
    return result


def build_parser():
    from repro_torch.configs import ARCH_IDS
    from repro_torch.models.base import INPUT_SHAPES
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=tuple(INPUT_SHAPES))
    ap.add_argument("--mesh", choices=("single", "multipod"),
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--resume", action="store_true",
                    help="skip combos with an existing ok result")
    ap.add_argument("--n-micro", type=int, default=4)
    ap.add_argument("--tag", default="")
    ap.add_argument("--attn-shard", choices=("even", "heads_padded"),
                    default="even",
                    help="heads_padded: head counts cut first, padded "
                         "where the model axis does not divide them")
    ap.add_argument("--expert-pad", type=int, default=0)
    ap.add_argument("--remat-policy", choices=("", "dots"), default="",
                    help="dots: the dense and VLM layers save their 2-D "
                         "matrix products (default: full remat)")
    ap.add_argument("--no-batch-constraints", action="store_true",
                    help="accepted; changes nothing (the port never splits "
                         "a client's microbatch over the data axes)")
    ap.add_argument("--client-placement", choices=("tp", "dp"),
                    default="tp",
                    help="dp: one client per rank, each client's model "
                         "whole on its rank")
    ap.add_argument("--rank", type=int, default=0,
                    help="the rank of the fake group whose program is traced")
    return ap


def main(argv=None):
    from repro_torch.configs import ARCH_IDS
    from repro_torch.models.base import INPUT_SHAPES
    args = build_parser().parse_args(argv)
    if args.all:
        combos = [(arch, shp, mk) for arch in ARCH_IDS for shp in INPUT_SHAPES
                  if applicable(arch, shp) for mk in ("single", "multipod")]
    elif args.arch and args.shape:
        combos = [(args.arch, args.shape, args.mesh)]
    else:
        raise SystemExit("give --arch and --shape, or --all")
    os.makedirs(RESULTS_DIR, exist_ok=True)
    for arch, shp, mk in combos:
        suffix = f"__{args.tag}" if args.tag else ""
        fn = os.path.join(RESULTS_DIR, f"{arch}__{shp}__{mk}{suffix}.json")
        if args.resume and os.path.exists(fn):
            with open(fn) as f:
                if json.load(f).get("status") == "ok":
                    print(f"[dryrun] {arch} x {shp} x {mk}: skip (done)",
                          flush=True)
                    continue
        res = run_one(arch, shp, mk, n_micro=args.n_micro, tag=args.tag,
                      attn_shard=args.attn_shard,
                      expert_pad=args.expert_pad,
                      remat_policy=args.remat_policy,
                      train_batch_constraints=not args.no_batch_constraints,
                      client_placement=args.client_placement,
                      rank=args.rank)
        with open(fn, "w") as f:
            json.dump(res, f, indent=1)
        extra = (f"trace={res['trace_s']}s flops={res['cost']['flops']:.3e}"
                 if res["status"] == "ok" else res["error"][:120])
        print(f"[dryrun] {arch} x {shp} x {mk}: {res['status']} {extra}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
