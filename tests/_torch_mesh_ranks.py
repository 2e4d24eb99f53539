"""Gloo ranks for the port's mesh tests (``tests/test_torch_mesh.py``,
``tests/test_torch_spmd.py``, ``tests/test_torch_model_axis.py``).

:func:`spawn` starts W ranks on the CPU (``torch.multiprocessing`` with
``spawn``, a gloo group over a free localhost port); each rank runs one
function of this module over every case of its test file and saves what
it got to ``<out>/rank<r>.pt``; the parent loads the W results.  A case
that raises is saved as the exception's text, so a failure shows in the
test that reads it.  Nothing here imports ``jax``: what a rank needs of
the reference (its initial params, its noise) comes in as numpy.
"""
import pathlib
import sys
import traceback

import numpy as np
import torch

HERE = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
import _torch_ref_runs as R  # noqa: E402

WORLD = 2


def spawn(fn_name: str, out, world: int = WORLD, **kw) -> list:
    """Run ``fn_name(rank, out, **kw)`` on ``world`` gloo ranks; returns
    each rank's result."""
    import torch.multiprocessing as mp
    from repro_torch.launch.collectives import free_port
    out = pathlib.Path(out)
    mp.start_processes(_rank_main, args=(world, free_port(), fn_name,
                                         str(out), kw),
                       nprocs=world, start_method="spawn")
    return [torch.load(out / f"rank{r}.pt", weights_only=False)
            for r in range(world)]


def _rank_main(rank, world, port, fn_name, out, kw):
    import torch.distributed as dist
    from repro_torch.launch.collectives import init_group
    torch.set_num_threads(1)
    init_group("gloo", rank, world, port)
    try:
        res = globals()[fn_name](rank, pathlib.Path(out), **kw)
        torch.save(res, pathlib.Path(out) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def _guard(fn):
    try:
        return fn()
    except Exception:                       # noqa: BLE001 (reported)
        return {"error": traceback.format_exc()}


def leaves_np(tree):
    from repro_torch.pytree import tree_leaves
    return [l.detach().cpu().numpy().copy() for l in tree_leaves(tree)]


# ---------------------------------------------------------------------------
# the cohort engine on a mesh (tests/test_torch_mesh.py)
# ---------------------------------------------------------------------------

# case -> (RUNS entry, dp_path, engine overrides, starts from the
# reference's initial params)
ENGINE_CASES = {
    "fedavg": ("fedavg", "jnp", {}, True),
    "async_window": ("async_window", "jnp", {}, True),
    "async_map": ("async_window", "jnp", {"client_axis": "map"}, True),
    "fl_step": ("fl_step_clip", "jnp", {}, True),
    "async_pallas": ("async_window", "pallas", {}, True),
    "noisy_vmap": ("async_noisy", "jnp", {"client_axis": "vmap"}, False),
    "noisy_pallas": ("async_noisy", "pallas", {}, False),
    "fedavg_noisy_vmap": ("fedavg_noisy", "jnp", {"client_axis": "vmap"},
                          False),
    "hostfed": ("hostfed_async", "jnp", {}, False),
    "pipelined": ("async_window", "jnp", {"pipeline_depth": 2}, True),
    "tiered": ("tiered_async", "jnp", {}, False),
}


def run_case(case, init, mesh=None, **run_kw):
    """One engine case through the reference harness's frontends, on
    ``mesh`` (None: one process)."""
    entry, dp_path, engine, from_ref = ENGINE_CASES[case]
    engine = dict(engine)
    if mesh is not None:
        engine["mesh"] = mesh
    return R.execute("repro_torch", entry, init.get(case) if from_ref
                     else None, dp_path=dp_path, device="cpu",
                     engine=engine, **run_kw)


def summary(params, log, calls):
    out = R.log_dict(log, calls)
    out["engine_stats"] = {k: v for k, v in log.engine_stats.items()
                           if k != "pallas_interpret"}
    return {"params": leaves_np(params), "log": out}


def _partition_proof(mesh):
    """A full cohort of 4 (partitioned, 2 per rank), a cohort of 3 padded
    to 4, and a host-fed cohort of 3 (replicated: the proof must fail)."""
    from repro_torch.core.testbed import build_testbed
    from repro_torch.engine import (
        CohortRunner, EngineConfig, assert_cohort_partitioned)
    cfg = tiny_cfg()
    out = {}
    for tag, k, arena in (("full", 4, True), ("padded", 3, True),
                          ("host", 3, False)):
        clients, params, _, _ = build_testbed(cfg, device="cpu")
        runner = CohortRunner(clients, EngineConfig(
            mesh=mesh, max_cohort=4, device_arena=arena), "cpu")
        plans = [runner.dispatch(c, params, 100 + c.cid, 0)
                 for c in clients[:k]]
        stacked = runner.run_cohort(plans)
        try:
            report = assert_cohort_partitioned(runner.last_partition, mesh)
        except AssertionError as e:
            report = {"error": str(e)}
        up = leaves_np(stacked)
        out[tag] = {"report": report, "rows": int(up[0].shape[0]),
                    "upload": up}
    return out


def tiny_cfg(sigma=0.0):
    from repro_torch.core.testbed import TestbedConfig
    from repro_torch.data.synthetic_ser import SERDataConfig
    from repro_torch.models.ser_cnn import SERConfig
    kw = R.testbed_kwargs(sigma)
    return TestbedConfig(
        data=SERDataConfig(n_total=72 * kw["num_clients"], **R.DIMS),
        model=SERConfig(channels1=8, channels2=16, fc_dim=32, **R.DIMS),
        **kw)


def session_spec_dict(shape=(WORLD, 1)):
    """A spec whose engine carries a ``shape`` (data, model) mesh (None: no
    mesh), as JSON data: it decodes to that mesh on the ranks it spans
    and to (1, 1) in one process."""
    from repro_torch.api import ExperimentSpec, RunBudget
    from repro_torch.engine import EngineConfig
    d = ExperimentSpec(
        testbed=tiny_cfg(1.0), run=RunBudget(max_updates=8, eval_every=4),
        engine=EngineConfig(staleness_window=1e9, max_cohort=4)).to_dict()
    if shape is not None:
        d["engine"]["mesh"] = {"__mesh__": dict(zip(("data", "model"),
                                                    shape))}
    return d


def collective_cases(mesh):
    """The collectives module's tree and tensor operations on known
    values: each rank's inputs are a function of its rank."""
    from repro_torch.launch import collectives as coll
    from repro_torch.launch.shardings import NamedSharding, block
    g, r = mesh.group, mesh.rank
    whole = {"a": torch.arange(24.0).reshape(2, 4, 3),
             "b": torch.arange(5.0)}
    dims = [1, None]                   # "a" split on dim 1, "b" replicated
    specs = {"a": (None, "data", None), "b": (None,)}
    mine = {k: block(v, NamedSharding(mesh, specs[k]), r).contiguous()
            for k, v in whole.items()}
    mine_int = torch.full((2, 3), r, dtype=torch.int32)
    return {
        "shard": leaves_np(mine),
        "gathered": leaves_np(coll.all_gather_tree(mine, dims, g)),
        "summed": leaves_np(coll.reduce_scatter_tree(
            {"a": whole["a"] * (r + 1), "b": whole["b"] * (r + 1)}, dims, g)),
        "members": leaves_np(coll.gather_members(
            {"x": mine_int, "y": torch.ones(2) * r}, g)),
        "broadcast": coll.broadcast(torch.tensor([10.0 + r]), 1, g).tolist(),
        "all_reduce": coll.all_reduce_sum(torch.tensor([1.0 + r]), g).tolist(),
        "mesh_equal": _mesh_again(mesh),
    }


def _mesh_again(mesh):
    """A second ``make_host_mesh`` over the same group equals the first and
    keys the same step-cache entry."""
    from repro_torch.engine.mesh_backend import CohortSharding
    from repro_torch.launch.mesh import make_host_mesh
    again = make_host_mesh(data=WORLD)
    return (again == mesh and hash(again) == hash(mesh)
            and CohortSharding(again) == CohortSharding(mesh))


def _model_axis_mesh(init):
    """A (1, WORLD) mesh on the ranks: runnable (the production round of
    any family, tests/test_torch_model_axis*.py) and for the cohort engine, which
    runs the ``async_window`` case on it (its members replicated over the
    model axis); one tensor-parallel sum and gather over its model
    group."""
    import torch.distributed as dist
    from repro_torch.launch import collectives as coll
    from repro_torch.launch.mesh import make_host_mesh, require_runnable
    m = make_host_mesh(data=1, model=WORLD)
    engine = summary(*run_case("async_window", init, m)[1:])
    g, r = m.model_group, m.model_rank
    return {"runnable": require_runnable(m) is m,
            "coords": (m.rank, r),
            "sizes": (dist.get_world_size(m.group), dist.get_world_size(g)),
            "reduced": coll.tp_reduce(torch.tensor([1.0 + r]), g).tolist(),
            "gathered": coll.tp_gather(torch.tensor([[float(r)]]), 1,
                                       g).tolist(),
            "engine": engine}


def engine_ranks(rank, out, init):
    """Every engine case of tests/test_torch_mesh.py on this rank."""
    from repro_torch.api import ExperimentSpec, Session
    from repro_torch.engine.resilience import (
        CheckpointPolicy, SimulatedCrash)
    from repro_torch.launch import collectives as coll
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh(data=WORLD)
    coll.reset_stats()
    res = {"mesh": mesh.shape, "rank": mesh.rank,
           "collective_cases": _guard(lambda: collective_cases(mesh))}
    for case in ENGINE_CASES:
        res[case] = _guard(lambda c=case: summary(
            *run_case(c, init, mesh)[1:]))
    res["collectives"] = coll.stats()

    def crash_resume():
        ck = out / "ckpt"
        try:
            run_case("async_window", init, mesh, checkpoint=CheckpointPolicy(
                directory=str(ck), every=4, crash_after_saves=1))
        except SimulatedCrash:
            pass
        else:
            raise AssertionError("no SimulatedCrash")
        return summary(*run_case("async_window", init, mesh,
                                 resume_from=str(ck))[1:])

    res["resume"] = _guard(crash_resume)
    res["model_axis"] = _guard(lambda: _model_axis_mesh(init))
    res["partition"] = _guard(lambda: _partition_proof(mesh))

    def session():
        spec = ExperimentSpec.from_dict(session_spec_dict())
        params, log = Session("cpu").run(spec)
        return dict(summary(params, log, []), mesh=spec.engine.mesh.shape)

    res["session"] = _guard(session)
    return res


# ---------------------------------------------------------------------------
# the production round on a mesh (tests/test_torch_spmd.py)
# ---------------------------------------------------------------------------

SEQ, G, N_MICRO, PER_MICRO = 16, 2, 2, 1


def setup_arch(arch, overrides=None, clients=G):
    """``tests/test_torch_train_zoo.py``'s port half of ``setup_arch``
    (f32): the reduced config (with ``overrides``), the seeded params and
    the batch of ``clients`` clients (with the audio frames or the VLM
    patches)."""
    from repro_torch.configs import get_config
    from repro_torch.models.base import get_family
    cfg = get_config(arch).reduced().replace(param_dtype="float32",
                                             ssm_chunk=SEQ,
                                             **(overrides or {}))
    params = get_family(cfg.family).init_params(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(1)
    b = clients * N_MICRO * PER_MICRO
    toks = rng.integers(0, cfg.vocab, size=(b, SEQ + 1)).astype(np.int32)
    batch = {"tokens": torch.from_numpy(toks[:, :SEQ]),
             "labels": torch.from_numpy(toks[:, 1:])}
    if cfg.family == "audio":
        batch["frames"] = torch.from_numpy(rng.standard_normal(
            (b, cfg.enc_frames, cfg.d_model)).astype(np.float32))
    if cfg.family == "vlm":
        batch["patches"] = torch.from_numpy(rng.standard_normal(
            (b, cfg.n_patches, cfg.d_model)).astype(np.float32))
    return cfg, params, batch


def fl_config(granularity, server_opt, server_lr, sigma=0.5, clients=G):
    from repro_torch.core.dp import DPConfig
    from repro_torch.core.fl_step import FLStepConfig
    return FLStepConfig(
        num_clients=clients, n_local=1, n_micro=N_MICRO, local_lr=0.05,
        server_lr=server_lr, server_opt=server_opt, compute_dtype="float32",
        dp=DPConfig(1.0, sigma, granularity))


def noise_source(noise):
    """``noise[f"{client}_{leaf}"]`` (step 0) as the round's source."""
    def source(client, step, leaf, shape):
        z = noise[f"{client}_{leaf}"]
        assert step == 0 and tuple(z.shape) == tuple(shape)
        return z
    return source


def round_on(mesh, arch, granularity, server_opt, server_lr, noise):
    """One round of the reduced ``arch`` on ``mesh`` (None: one process,
    no shardings): the whole new master, the metrics, and which master
    leaves the mesh split."""
    from repro_torch.core.fl_step import (
        gather_master, make_fl_train_step, make_server_optimizer,
        master_dims, shard_master)
    from repro_torch.launch.shardings import tree_shardings
    from repro_torch.models.base import get_family
    from repro_torch.pytree import tree_map
    cfg, params, batch = setup_arch(arch)
    fam = get_family(cfg.family)
    fl = fl_config(granularity, server_opt, server_lr)
    client_sh = master_sh = None
    if mesh is not None:
        stacked = tree_map(lambda l: torch.empty(
            (G,) + tuple(l.shape), device="meta"), params)
        client_sh = tree_shardings(stacked, cfg, mesh, role="client")
        master_sh = tree_shardings(params, cfg, mesh, role="master")
    local = shard_master(params, master_sh)
    step = make_fl_train_step(lambda p, b: fam.loss(p, b, cfg), fl,
                              client_shardings=client_sh,
                              master_shardings=master_sh)
    new, _, met = step(local, make_server_optimizer(fl).init(local), batch,
                       torch.ones(G) / G, noise_source(noise))
    whole = gather_master(new, master_sh)
    dims = master_dims(master_sh) if master_sh is not None else []
    return {"master": leaves_np(whole),
            "local_shapes": [tuple(l.shape) for l in leaves_np(new)],
            "split": sum(d is not None for d in dims),
            "delta_norm": float(met["delta_norm"]),
            "weight_sum": float(met["weight_sum"])}


def spmd_ranks(rank, out, rounds, noise):
    """Every round case of tests/test_torch_spmd.py on this rank:
    ``rounds`` is ``{name: (arch, granularity, server_opt, server_lr)}``,
    ``noise[name]`` its injected draws."""
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh(data=WORLD)
    return {name: _guard(lambda n=name, a=args: round_on(mesh, *a, noise[n]))
            for name, args in rounds.items()}


# ---------------------------------------------------------------------------
# one client per rank (tests/test_torch_client_placement.py)
# ---------------------------------------------------------------------------

def placement_round(mesh, arch, granularity, server_opt, server_lr, clients,
                    noise):
    """One round of the reduced ``arch`` with ``clients`` clients on
    ``mesh`` with ``role="client_all_axes"`` client shardings, the layers'
    mesh context installed as the launcher installs it (None: one
    process, no shardings): the whole new master, the metrics, this
    rank's clients' count and its master blocks' shapes."""
    from repro_torch.core.fl_step import (
        gather_master, make_fl_train_step, make_server_optimizer,
        shard_master)
    from repro_torch.launch.shardings import tree_shardings
    from repro_torch.models import layers as L
    from repro_torch.models.base import get_family
    from repro_torch.pytree import tree_map
    cfg, params, batch = setup_arch(arch, clients=clients)
    fam = get_family(cfg.family)
    fl = fl_config(granularity, server_opt, server_lr, clients=clients)
    client_sh = master_sh = None
    if mesh is not None:
        stacked = tree_map(lambda l: torch.empty(
            (clients,) + tuple(l.shape), device="meta"), params)
        client_sh = tree_shardings(stacked, cfg, mesh,
                                   role="client_all_axes")
        master_sh = tree_shardings(params, cfg, mesh, role="master")
        L.set_mesh_context(mesh, cfg=cfg)
    seen = []

    def loss_fn(p, b):
        seen.append(L.model_group() is None)
        return fam.loss(p, b, cfg)

    try:
        local = shard_master(params, master_sh)
        step = make_fl_train_step(loss_fn, fl, client_shardings=client_sh,
                                  master_shardings=master_sh)
        new, _, met = step(local, make_server_optimizer(fl).init(local),
                           batch, torch.ones(clients) / clients,
                           noise_source(noise))
        whole = gather_master(new, master_sh)
    finally:
        L.clear_mesh_context()
    return {"master": leaves_np(whole),
            "local_shapes": [tuple(l.shape) for l in leaves_np(new)],
            "whole_shapes": [tuple(l.shape) for l in leaves_np(params)],
            "losses": len(seen), "no_context": all(seen),
            "delta_norm": float(met["delta_norm"]),
            "weight_sum": float(met["weight_sum"])}


def placement_ranks(rank, out, data, rounds, noise):
    """Every round of tests/test_torch_client_placement.py on a ``data`` x
    ``W / data`` mesh: ``rounds`` is ``{name: (arch, granularity,
    server_opt, server_lr)}``, G = W clients."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    world = dist.get_world_size()
    mesh = make_host_mesh(data=data, model=world // data)
    res = {"coords": (mesh.rank, mesh.model_rank)}
    for name, args in rounds.items():
        res[name] = _guard(lambda a=args, n=name: placement_round(
            mesh, *a, world, noise[n]))
    res["refusal"] = _refusal(mesh, world + 1)
    return res


def _refusal(mesh, clients):
    """The error text of a one-client-per-rank round of ``clients``
    clients on ``mesh`` (None if it builds)."""
    from repro_torch.core.fl_step import make_fl_train_step
    from repro_torch.launch.shardings import NamedSharding
    sh = [NamedSharding(mesh, (("data", "model"), None))]
    try:
        make_fl_train_step(lambda p, b: 0.0,
                           fl_config("per_microbatch", "sgd", 1.0,
                                     clients=clients), client_shardings=sh)
    except ValueError as e:
        return str(e)
    return None


# ---------------------------------------------------------------------------
# the model axis (tests/test_torch_model_axis.py)
# ---------------------------------------------------------------------------

def rounds_on(mesh, arch, granularity, server_opt, server_lr, noise,
              n_rounds=2, sigma=0.5, start=None, overrides=None):
    """``n_rounds`` rounds of the reduced ``arch`` on ``mesh`` (None: one
    process), each with the injected ``noise``, from the seeded params or
    the whole leaves ``start`` (numpy); on a model axis the layers' mesh
    context is installed, as the launcher installs it.
    Returns each round's whole master and metrics, this rank's final
    blocks, the head counts the plain ``ssd_intra_chunk`` received and
    the unclipped norm of client 0's first microbatch gradient."""
    from repro_torch.core.fl_step import (
        gather_master, loss_grad, make_fl_train_step, make_server_optimizer,
        master_model_dims, shard_master)
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.launch.shardings import tree_shardings
    from repro_torch.models import layers as L
    from repro_torch.models.base import get_family
    from repro_torch.pytree import tree_global_norm, tree_map
    from repro_torch.pytree import tree_unflatten_like
    cfg, params, batch = setup_arch(arch, overrides)
    if start is not None:
        params = tree_unflatten_like(params,
                                     [torch.from_numpy(a) for a in start])
    fam = get_family(cfg.family)
    fl = fl_config(granularity, server_opt, server_lr, sigma)
    client_sh = master_sh = None
    if mesh is not None:
        stacked = tree_map(lambda l: torch.empty(
            (G,) + tuple(l.shape), device="meta"), params)
        client_sh = tree_shardings(stacked, cfg, mesh, role="client")
        master_sh = tree_shardings(params, cfg, mesh, role="master")
        L.set_mesh_context(mesh, cfg=cfg)
    heads = []
    plain = ssd_ops.ssd_intra_chunk_ref

    def counted(xr, *rest):
        heads.append(int(xr.shape[3]))
        return plain(xr, *rest)

    ssd_ops.ssd_intra_chunk_ref = counted
    try:
        local = shard_master(params, master_sh)
        step = make_fl_train_step(lambda p, b: fam.loss(p, b, cfg), fl,
                                  client_shardings=client_sh,
                                  master_shardings=master_sh)
        opt = make_server_optimizer(fl).init(local)
        rounds = []
        for _ in range(n_rounds):
            local, opt, met = step(local, opt, batch, torch.ones(G) / G,
                                   noise_source(noise))
            rounds.append({"master": leaves_np(gather_master(local,
                                                             master_sh)),
                           "delta_norm": float(met["delta_norm"]),
                           "weight_sum": float(met["weight_sum"])})
    finally:
        ssd_ops.ssd_intra_chunk_ref = plain
        L.clear_mesh_context()
    micro = {k: v[:PER_MICRO] for k, v in batch.items()}
    g0 = loss_grad(lambda p, b: fam.loss(p, b, cfg), params, micro)
    return {"rounds": rounds, "blocks": leaves_np(local),
            "model_dims": master_model_dims(master_sh),
            "coords": None if mesh is None else (mesh.rank, mesh.model_rank),
            "heads": sorted(set(heads)), "n_ssd_heads": cfg.ssm_expand
            * cfg.d_model // cfg.ssm_head_dim if cfg.family == "hybrid"
            else 0, "grad0_norm": float(tree_global_norm(g0))}


def layer_cases(mesh):
    """The gated RMSNorm, the vocab-cut embedding and the vocab-parallel
    loss on this rank's blocks against the whole functions: the largest
    differences of the values and of the gradients (whole ones compared
    on this rank's block)."""
    from repro_torch.launch.shardings import NamedSharding, block
    from repro_torch.models import layers as L
    from repro_torch.models import mamba2 as M2
    cfg, _, _ = setup_arch("smollm-360m")
    g, r = mesh.model_group, mesh.model_rank
    m = mesh.shape["model"]
    gen = torch.Generator().manual_seed(3)

    def rand(*shape):
        return torch.randn(shape, generator=gen)

    def cut(t, dim):
        spec = [None] * t.dim()
        spec[dim] = "model"
        return block(t, NamedSharding(mesh, tuple(spec)), 0, r)

    out = {}
    di = 2 * cfg.d_model
    y, z, scale, w = rand(2, 5, di), rand(2, 5, di), rand(di), rand(2, 5, di)
    whole_in = [t.clone().requires_grad_() for t in (y, z, scale)]
    ref = M2.gated_rms_norm(*whole_in, 1e-6)
    ref_g = torch.autograd.grad((ref * w).sum(), whole_in)
    part_in = [cut(t, t.dim() - 1).clone().requires_grad_()
               for t in (y, z, scale)]
    got = M2.gated_rms_norm(*part_in, 1e-6, group=g)
    # the gradients of the whole loss: the ranks' terms added
    got_g = torch.autograd.grad(L.coll.tp_reduce(
        (got * cut(w, 2)).sum(), g), part_in)
    out["gated_norm"] = (
        float((got - cut(ref, 2)).abs().max()),
        max(float((a - cut(b, b.dim() - 1)).abs().max())
            for a, b in zip(got_g, ref_g)))

    V, D = cfg.vocab, cfg.d_model
    table, h = rand(V, D), rand(2, 8, D)
    tokens = torch.randint(0, V, (2, 8), generator=gen)
    for name, fn in (
            ("embed", lambda t, x: (L.embed(tokens, t) * h).sum()),
            ("loss", lambda t, x: L.chunked_lm_loss(x, tokens, t,
                                                    loss_chunk=4))):
        wt, wx = table.clone().requires_grad_(), h.clone().requires_grad_()
        ref = fn(wt, wx)
        ref_g = torch.autograd.grad(ref, (wt, wx), allow_unused=True)
        L.set_mesh_context(mesh, cfg=cfg)
        try:
            pt, px = cut(table, 0).clone().requires_grad_(), \
                h.clone().requires_grad_()
            got = fn(pt, px)
            got_g = torch.autograd.grad(got, (pt, px), allow_unused=True)
        finally:
            L.clear_mesh_context()
        gx = got_g[1]
        errs = [float((got_g[0] - cut(ref_g[0], 0)).abs().max())]
        if ref_g[1] is not None:
            errs.append(float((gx - ref_g[1]).abs().max()))
        out[name] = (float((got - ref).abs()), max(errs))
    for name, with_state in (("mamba2", False), ("mamba2_state", True)):
        out[name] = mamba2_case(mesh, with_state, rand)
    out["model"] = m
    return out


def mamba2_case(mesh, with_state, rand):
    """One Mamba2 mixer of the reduced zamba2 on this rank's blocks (cut
    by the leaf rule, under the mesh context) against the whole mixer
    with no context, from no state or from a state (the conv state whole,
    the ssm state this rank's heads): the largest differences of the
    output and final ssm state, and of the gradients of the params, the
    input and the state (each relative to its largest entry)."""
    from repro_torch.launch.shardings import NamedSharding, block, leaf_spec
    from repro_torch.models import layers as L
    from repro_torch.models import mamba2 as M2
    from repro_torch.pytree import tree_map
    cfg, params, _ = setup_arch("zamba2-1.2b")
    g, r = mesh.model_group, mesh.model_rank
    p = tree_map(lambda v: v[0, 0].clone(), params["mamba_seg"]["mix"])
    names = sorted(p)

    def cut_leaf(t):
        # the spec of the leaf in a client's (1, ...) stack, client dim off
        spec = leaf_spec((1,) + tuple(t.shape), cfg, mesh, "client")[1:]
        return block(t, NamedSharding(mesh, spec), 0, r)

    def head_block(t):
        return block(t, NamedSharding(mesh, (None, "model", None, None)),
                     0, r)

    Bsz, S = 2, SEQ
    H, P, N = M2.n_heads_ssm(cfg), cfg.ssm_head_dim, cfg.ssm_state
    x, w = rand(Bsz, S, cfg.d_model), rand(Bsz, S, cfg.d_model)
    conv0 = rand(Bsz, cfg.ssm_conv - 1, M2.conv_channels(cfg))
    ssm0, w_fin = rand(Bsz, H, P, N), rand(Bsz, H, P, N)

    def run(leaves, x_in, states, fin_w, reduce):
        state = tuple(states) if with_state else None
        out, (_, fin) = M2.mamba2_forward(x_in, dict(zip(names, leaves)),
                                          cfg, state)
        loss = (out * w).sum() + reduce((fin * fin_w).sum())
        grads = torch.autograd.grad(loss, list(leaves) + [x_in] + (
            list(states) if with_state else []))
        return out, fin, grads

    def leaf_inputs(ts):
        return [t.clone().requires_grad_() for t in ts]

    ref_out, ref_fin, ref_g = run(
        leaf_inputs([p[k] for k in names]), x.clone().requires_grad_(),
        leaf_inputs([conv0, ssm0]), w_fin, lambda t: t)
    L.set_mesh_context(mesh, cfg=cfg)
    try:
        got_out, got_fin, got_g = run(
            leaf_inputs([cut_leaf(p[k]) for k in names]),
            x.clone().requires_grad_(),
            leaf_inputs([conv0, head_block(ssm0)]), head_block(w_fin),
            lambda t: L.coll.tp_reduce(t, g))
    finally:
        L.clear_mesh_context()
    n = len(names)
    want = [cut_leaf(t) for t in ref_g[:n]] + [ref_g[n]]
    if with_state:
        want += [ref_g[n + 1], head_block(ref_g[n + 2])]
    value = max(float((got_out - ref_out).abs().max()),
                float((got_fin - head_block(ref_fin)).abs().max()))
    # the gradients reach a few hundred: each one's difference relative
    # to its largest entry
    return value, max(float((a - b).abs().max() / b.abs().max())
                      for a, b in zip(got_g, want))


def model_axis_ranks(rank, out, data, rounds, noise, dots=()):
    """Every case of tests/test_torch_model_axis.py on this rank, on a
    ``data`` x ``WORLD / data`` mesh: ``rounds`` is ``{name: (arch,
    granularity, server_opt, server_lr, sigma)}``; each name in ``dots``
    runs again under ``set_remat_policy("dots")``, as ``<name>_dots``
    (after the collectives are counted)."""
    import torch.distributed as dist
    from repro_torch.launch import collectives as coll
    from repro_torch.launch.mesh import make_host_mesh, require_runnable
    mesh = make_host_mesh(data=data, model=dist.get_world_size() // data)
    res = {"mesh": mesh.shape, "coords": (mesh.rank, mesh.model_rank),
           "runnable": _guard(lambda: require_runnable(mesh) is mesh)}
    res["layers"] = _guard(lambda: layer_cases(mesh))
    coll.reset_stats()
    for name, (arch, gran, opt, lr, sigma) in rounds.items():
        res[name] = _guard(lambda a=arch, gr=gran, o=opt, l=lr, sg=sigma,
                           n=name: rounds_on(mesh, a, gr, o, l, noise[n],
                                             sigma=sg))
    res["collectives"] = coll.stats()
    for name in dots:
        arch, gran, opt, lr, sigma = rounds[name]
        res[f"{name}_dots"] = _guard(lambda a=arch, gr=gran, o=opt, l=lr,
                                     sg=sigma, n=name: dots_rounds_on(
                                         mesh, a, gr, o, l, noise[n], sg))
    return res


def dots_rounds_on(mesh, arch, granularity, server_opt, server_lr, noise,
                   sigma):
    """``rounds_on`` under ``set_remat_policy("dots")`` (restored after),
    with the count of the dense layers' units that ran selectively
    checkpointed under autograd."""
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    units = []
    real = L.remat

    def counted(fn, *args, policy=None):
        units.append(policy)
        return real(fn, *args, policy=policy)

    T.set_remat_policy("dots")
    L.remat = counted
    try:
        res = rounds_on(mesh, arch, granularity, server_opt, server_lr,
                        noise, sigma=sigma)
    finally:
        L.remat = real
        T.set_remat_policy(None)
    res["dots_units"] = units.count("dots")
    return res


# ---------------------------------------------------------------------------
# the rest of the model axis (tests/test_torch_model_axis_zoo.py)
# ---------------------------------------------------------------------------


def session_spec_on(shape):
    """``session_spec_dict(shape)`` decoded on this rank."""
    from repro_torch.api import ExperimentSpec
    return ExperimentSpec.from_dict(session_spec_dict(shape))


def engine_on_meshes(out, shapes, resume_shape=None):
    """``Session.run`` of the spec on each mesh shape of ``shapes`` (None:
    no mesh): the final params and RunLog, the decoded mesh, this rank's
    coordinates and its ``dp_clip`` launches; with ``resume_shape``, the
    same run on that mesh crashed after its first snapshot (every 4
    updates) and resumed, counting the snapshot files each rank wrote."""
    from repro_torch.api import Session
    from repro_torch.engine import resilience
    from repro_torch.engine.resilience import SimulatedCrash
    from repro_torch.kernels.dp_clip import dp_clip
    sess = Session("cpu")
    res = {}
    for shape in shapes:
        spec = session_spec_on(shape)
        dp_clip.reset_launches()
        params, log = sess.run(spec)
        mesh = spec.engine.mesh
        res[shape] = dict(
            summary(params, log, []),
            mesh=None if mesh is None else mesh.shape,
            coords=None if mesh is None else (mesh.rank, mesh.model_rank),
            launches=(dp_clip.sqnorm_launches, dp_clip.scale_mean_launches))
    if resume_shape is not None:
        writes = []
        save = resilience._ckpt.save

        def counted(*a, **k):
            writes.append(a[1])
            return save(*a, **k)

        resilience._ckpt.save = counted
        ck = str(out / "ckpt")
        try:
            try:
                sess.run(session_spec_on(resume_shape), checkpoint_every=4,
                         checkpoint_dir=ck, crash_after_saves=1)
            except SimulatedCrash:
                pass
            else:
                raise AssertionError("no SimulatedCrash")
            params, log = sess.run(session_spec_on(resume_shape),
                                   resume_from=ck)
        finally:
            resilience._ckpt.save = save
        res["resume"] = dict(summary(params, log, []), writes=writes)
    return res


def _stacked_cut(mesh, cfg, stacked, lead):
    """A function cutting one layer of a stacked leaf (``lead`` stacking
    dims; 0: an unstacked leaf) as the leaf rule cuts the stacked leaf in
    a client's (1, ...) stack."""
    from repro_torch.launch.shardings import NamedSharding, block, leaf_spec
    spec = leaf_spec((1,) + tuple(stacked.shape), cfg, mesh,
                     "client")[1 + lead:]
    return lambda t: block(t, NamedSharding(mesh, spec), 0, mesh.model_rank)


def _named(tree):
    """The leaves of ``tree`` named by their flat index (sorted names keep
    the flat order)."""
    from repro_torch.pytree import tree_leaves
    return {f"{j:03d}": l for j, l in enumerate(tree_leaves(tree))}


def _tree(template, named):
    from repro_torch.pytree import tree_unflatten_like
    return tree_unflatten_like(template, [named[k] for k in sorted(named)])


def _layer_cuts(mesh, cfg, stack, lead):
    """Layer 0 of a stacked tree, named, and each leaf's cut."""
    from repro_torch.pytree import tree_map
    idx = (0,) * lead
    layer = tree_map(lambda v: v[idx].clone(), stack)
    cuts = {k: _stacked_cut(mesh, cfg, v, lead)
            for k, v in _named(stack).items()}
    return layer, _named(layer), cuts


def blocks_vs_whole(mesh, cfg, fn, params, cuts, inputs, seed=7):
    """``fn(params, *inputs)`` (a replicated tensor, or a tuple whose
    first entry is one) on this rank's blocks of ``params`` (``cuts``:
    per leaf name, a function cutting the whole leaf) under the mesh
    context, against ``fn`` on the whole params with none: the largest
    difference of the outputs, and of the gradients of
    ``sum(out * w)`` (w random) with respect to the params (whole ones
    on this rank's block) and the float inputs, each relative to its
    largest entry.  Returns ``(value, grad, whole outputs, block
    outputs)``."""
    from repro_torch.models import layers as L
    names = sorted(params)

    def first(o):
        return o[0] if isinstance(o, tuple) else o

    def run(leaves, ctx):
        ins = [t.clone().requires_grad_() if t.is_floating_point() else t
               for t in inputs]
        ps = [t.clone().requires_grad_() for t in leaves]
        live = ps + [t for t in ins if t.requires_grad]
        if ctx:
            L.set_mesh_context(mesh, cfg=cfg)
        try:
            outs = fn(dict(zip(names, ps)), *ins)
            w = torch.randn(first(outs).shape,
                            generator=torch.Generator().manual_seed(seed))
            grads = torch.autograd.grad((first(outs).float() * w).sum(),
                                        live, allow_unused=True)
        finally:
            L.clear_mesh_context()
        return outs, [torch.zeros_like(p) if g is None else g
                      for p, g in zip(live, grads)]

    whole_out, whole_g = run([params[k] for k in names], False)
    got_out, got_g = run([cuts[k](params[k]) for k in names], True)
    n = len(names)
    want = [cuts[k](g) for k, g in zip(names, whole_g[:n])] + whole_g[n:]
    a, b = first(got_out).detach().float(), first(whole_out).detach().float()
    value = float((a - b).abs().max() / b.abs().max())
    grad = max(float((x - y).abs().max() / max(float(y.abs().max()), 1e-30))
               for x, y in zip(got_g, want))
    return value, grad, whole_out, got_out


def zoo_layer_cases(mesh):
    """The new block functions on this rank's blocks against the whole
    ones (:func:`blocks_vs_whole`): MoE routing (and its decisions
    equal), ``moe_mlp`` with w_down cut on d_model (olmoe) and on
    d_expert rows with a cut shared expert (qwen2-moe's full-width
    placement, d_expert 128), the d_model-column-cut embedding and loss,
    the mLSTM block, the sLSTM scan with its R* cut, and the VLM loss
    over text positions with the norms cut on the layer dim."""
    from repro_torch.models import layers as L
    from repro_torch.models import moe, vlm, xlstm
    out = {}
    gen = torch.Generator().manual_seed(11)

    def rand(*shape):
        return torch.randn(shape, generator=gen)

    def shapes(named, cuts):
        return {k: tuple(cuts[k](v).shape) for k, v in named.items()}

    cfg, params, _ = setup_arch("olmoe-1b-7b")
    router = params["blocks"]["moe"]["router"]
    cut = {"r": _stacked_cut(mesh, cfg, router, 1)}
    value, grad, whole_o, got_o = blocks_vs_whole(
        mesh, cfg, lambda p, x: (lambda r: (r[0] + r[5], r))(
            moe.route(x, p["r"], cfg)),
        {"r": router[0].clone()}, cut, [rand(2, 12, cfg.d_model)])
    out["route"] = (value, grad)
    out["route_decisions"] = all(torch.equal(whole_o[1][i], got_o[1][i])
                                 for i in (1, 2, 3))
    out["route_cut"] = tuple(cut["r"](router[0]).shape)

    for name, arch, ov in (("moe_mlp", "olmoe-1b-7b", None),
                           ("moe_mlp_rows", "qwen2-moe-a2.7b",
                            {"d_expert": 128})):
        cfg, params, _ = setup_arch(arch, ov)
        layer, named, cuts = _layer_cuts(mesh, cfg, params["blocks"]["moe"],
                                         1)
        out[name] = blocks_vs_whole(
            mesh, cfg, lambda p, x, c=cfg, t=layer: moe.moe_mlp(
                x, _tree(t, p), c), named, cuts,
            [rand(2, 8, cfg.d_model)])[:2]
        out[name + "_shapes"] = shapes(named, cuts)

    cfg, params, _ = setup_arch("olmoe-1b-7b")
    tokens = torch.randint(0, cfg.vocab, (2, 8), generator=gen)
    cut = {"t": _stacked_cut(mesh, cfg, params["embedding"], 0)}
    h = rand(2, 8, cfg.d_model)
    out["embed_cols"] = blocks_vs_whole(
        mesh, cfg, lambda p, x: L.embed(tokens, p["t"]) * x,
        {"t": params["embedding"]}, cut, [h])[:2]
    out["loss_cols"] = blocks_vs_whole(
        mesh, cfg, lambda p, x: L.chunked_lm_loss(x, tokens, p["t"],
                                                  loss_chunk=4)[None],
        {"t": params["lm_head"]}, cut, [h])[:2]
    out["table_cut"] = tuple(cut["t"](params["embedding"]).shape)

    cfg, params, _ = setup_arch("xlstm-350m")
    for name, key, lead, fn in (
            ("mlstm", "mlstm_seg", 2,
             lambda p, x, c, t: xlstm.mlstm_block(x, _tree(t, p), c)[0]),
            ("slstm", "slstm", 1,
             lambda p, x, c, t: xlstm.slstm_scan(x, _tree(t, p), c)[0])):
        stack = {k: v for k, v in params[key].items() if k != "ffn"}
        layer, named, cuts = _layer_cuts(mesh, cfg, stack, lead)
        out[name] = blocks_vs_whole(
            mesh, cfg, lambda p, x, f=fn, c=cfg, t=layer: f(p, x, c, t),
            named, cuts, [rand(2, SEQ, cfg.d_model)])[:2]
        out[name + "_shapes"] = shapes(named, cuts)

    cfg, params, batch = setup_arch("phi-3-vision-4.2b", PHI3_QUIRK)
    named = _named(params)
    cuts = {k: _stacked_cut(mesh, cfg, v, 0) for k, v in named.items()}
    one = {k: v[:1] for k, v in batch.items()}
    out["vlm_loss"] = blocks_vs_whole(
        mesh, cfg, lambda p: vlm.loss(_tree(params, p), one, cfg,
                                      loss_chunk=8)[None],
        named, cuts, [])[:2]
    out["vlm_shapes"] = shapes(named, cuts)
    return out


def _strided_sum(mesh):
    """The model group's sum of a strided tensor (a column slice, as the
    gradient of a chunk's view arrives in ``tp_copy``'s backward): its
    values, and whether the result is contiguous."""
    from repro_torch.launch import collectives as coll
    x = torch.arange(12.0).reshape(3, 4)[:, 1:3] * (mesh.model_rank + 1)
    got = coll.all_reduce_sum(x, mesh.model_group)
    return {"sum": got.tolist(), "contiguous": got.is_contiguous()}


# phi-3-vision's full-width quirk at a reduced size: n_layers == n_heads,
# so the leaf rule cuts the stacked norms on the layer dim
PHI3_QUIRK = {"n_heads": 2, "n_kv_heads": 2, "d_head": 128}


# ``launch/train.py spmd`` for every zoo config at a small size
LAUNCH_REDUCE = ("d_model=64,n_layers=2,vocab=256,n_heads=4,n_kv_heads=4,"
                 "d_ff=128,n_experts=4,top_k=2,d_expert=64,enc_frames=16,"
                 "n_patches=8,ssm_chunk=16")


def launch_args(arch, devices=1):
    from repro_torch.launch import train
    return train.build_parser().parse_args([
        "spmd", "--device", "cpu", "--arch", arch, "--steps", "2",
        "--log-every", "2", "--seq", "16", "--data-axis", "2",
        "--n-micro", "2", "--per-micro", "1", "--devices", str(devices),
        "--reduce", LAUNCH_REDUCE])


def launcher_runs(mesh):
    """The launcher's rounds (``train._run_spmd``, what ``spmd --devices N
    --data-axis 2`` runs on each rank) of every zoo config on ``mesh``:
    the whole final master of each."""
    from repro_torch.configs import ARCH_IDS
    from repro_torch.launch import train
    return {arch: leaves_np(train._run_spmd(
        launch_args(arch, mesh.size), mesh, "cpu", None))
            for arch in ARCH_IDS}


def model_axis_zoo_ranks(rank, out, data, rounds, noise, engine_shapes,
                         resume_shape=None, launcher=False):
    """Every case of tests/test_torch_model_axis_zoo.py on this rank, on a
    ``data`` x ``WORLD / data`` mesh: ``rounds`` is ``{name: (arch,
    overrides)}``, each two per-microbatch SGD rounds at ``server_lr=1``
    with ``noise[name]`` injected; then the cohort engine's
    ``Session.run`` on ``engine_shapes`` (:func:`engine_on_meshes`)."""
    import torch.distributed as dist
    from repro_torch.launch import collectives as coll
    from repro_torch.launch.mesh import make_host_mesh, require_runnable
    mesh = make_host_mesh(data=data, model=dist.get_world_size() // data)
    res = {"mesh": mesh.shape, "coords": (mesh.rank, mesh.model_rank),
           "runnable": _guard(lambda: require_runnable(mesh) is mesh)}
    res["layers"] = _guard(lambda: zoo_layer_cases(mesh))
    for name, (arch, ov) in rounds.items():
        coll.reset_stats()
        res[name] = _guard(lambda a=arch, o=ov, n=name: rounds_on(
            mesh, a, "per_microbatch", "sgd", 1.0, noise[n], overrides=o))
        res[name + ":collectives"] = coll.stats()
    res["engine"] = _guard(lambda: engine_on_meshes(out, engine_shapes,
                                                    resume_shape))
    res["strided"] = _guard(lambda: _strided_sum(mesh))
    if launcher:
        res["launcher"] = _guard(lambda: launcher_runs(mesh))
    return res


# ---------------------------------------------------------------------------
# serving on a mesh (tests/test_torch_serve_mesh.py)
# ---------------------------------------------------------------------------

SERVE_B, SERVE_S, SERVE_STEPS = 4, 16, 4


def serve_config(arch, overrides=None):
    from repro_torch.configs import get_config
    return get_config(arch).reduced().replace(param_dtype="float32",
                                              **(overrides or {}))


def serve_inputs(cfg, seed=0):
    """The prompt batch (with the stub frames or patches) and the decode
    steps' tokens, as numpy."""
    rng = np.random.default_rng(seed)
    B, S = SERVE_B, SERVE_S
    toks = rng.integers(0, cfg.vocab, size=(B, S + SERVE_STEPS)).astype(
        np.int32)
    batch = {"tokens": toks[:, :S]}
    if cfg.family == "audio":
        batch["frames"] = rng.standard_normal(
            (B, cfg.enc_frames, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        batch["patches"] = rng.standard_normal(
            (B, cfg.n_patches, cfg.d_model)).astype(np.float32)
    return batch, toks[:, S:]


def serve_on(mesh, cfg, params_np, batch_np, steps_np):
    """A prefill of ``batch_np`` and a decode step per column of
    ``steps_np`` (teacher-forced) of the reduced ``cfg`` on ``mesh``
    (None: one process, whole params and cache): each step's logits (this
    rank's rows), the cache leaves (this rank's blocks) after the prefill
    and after the last step, and the (query heads, kv heads, head_dim)
    of every plain ``flash_decode`` call."""
    import contextlib
    from repro_torch.kernels.flash_attn import ops as flash_ops
    from repro_torch.launch import serve
    from repro_torch.models import convert
    from repro_torch.models.base import get_family
    fam = get_family(cfg.family)
    params = convert.params_from_numpy(params_np)
    B, S = SERVE_B, SERVE_S
    max_len = S + steps_np.shape[1]
    off = cfg.n_patches if cfg.family == "vlm" else 0
    if mesh is None:
        cache = fam.init_cache(cfg, B, max_len, device="cpu")
        ctx, rows = contextlib.nullcontext(), (lambda t: t)
    else:
        params = serve.place_params(params, cfg, mesh)
        cache = serve.init_cache(cfg, B, max_len, mesh, "cpu")
        ctx = serve.context(mesh, cfg, B)
        rows = (lambda t: serve.rows(t, mesh, B))
    calls, plain = [], flash_ops.flash_decode_ref

    def counted(q, k, v, pos, **kw):
        calls.append((int(q.shape[1]), int(k.shape[2]), int(k.shape[3])))
        return plain(q, k, v, pos, **kw)

    flash_ops.flash_decode_ref = counted
    try:
        with ctx, torch.no_grad():
            batch = rows({k: torch.from_numpy(v) for k, v in
                          batch_np.items()})
            lg, cache = fam.prefill(params, batch, cfg, cache)
            out = {"prefill": lg.numpy().copy(),
                   "cache_prefill": leaves_np(cache)}
            for t in range(steps_np.shape[1]):
                tok = rows(torch.from_numpy(steps_np[:, t:t + 1].copy()))
                pos = torch.full((tok.shape[0],), off + S + t,
                                 dtype=torch.int32)
                lg, cache = fam.decode_step(params, cache, tok, pos, cfg)
                out[f"decode{t}"] = lg.numpy().copy()
            out["cache"] = leaves_np(cache)
    finally:
        flash_ops.flash_decode_ref = plain
    out["flash_calls"] = sorted(set(calls))
    out["n_flash"] = len(calls)
    return out


def serve_mesh_ranks(rank, out, data, cases, params, inputs):
    """Every case of tests/test_torch_serve_mesh.py on this rank, on a
    ``data`` x ``WORLD / data`` mesh: ``cases`` is ``{name: (arch,
    overrides)}``, ``params[name]`` its whole params and ``inputs[name]``
    its (batch, decode tokens), as numpy."""
    import torch.distributed as dist
    from repro_torch.launch import collectives as coll
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh(data=data, model=dist.get_world_size() // data)
    res = {"mesh": mesh.shape, "coords": (mesh.rank, mesh.model_rank)}
    for name, (arch, ov) in cases.items():
        coll.reset_stats()
        res[name] = _guard(lambda a=arch, o=ov, n=name: serve_on(
            mesh, serve_config(a, o), params[n], *inputs[n]))
        res[name + ":collectives"] = coll.stats()
    return res


def serve_step(mesh, cfg, device, max_len=24):
    """One decode step of ``cfg`` served on ``mesh`` from a zero cache of
    ``max_len`` positions, on ``device`` (``"meta"`` on a fake group):
    its collectives ``{name: (calls, bytes)}`` and its FLOPs."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.launch import collectives as coll
    from repro_torch.launch import serve
    from repro_torch.models.base import get_family
    fam = get_family(cfg.family)
    B = SERVE_B
    params = serve.place_params(fam.init_params(cfg, 0, device=device), cfg,
                                mesh)
    cache = serve.init_cache(cfg, B, max_len, mesh, device)
    token = serve.rows(torch.zeros((B, 1), dtype=torch.int32, device=device),
                       mesh, B)
    pos = torch.full((token.shape[0],), max_len - 1, dtype=torch.int32,
                     device=device)
    coll.reset_stats()
    with serve.context(mesh, cfg, B), torch.no_grad(), \
            FlopCounterMode(display=False) as flops:
        fam.decode_step(params, cache, token, pos, cfg)
    return {"collectives": {k: (v["calls"], v["bytes"])
                            for k, v in coll.stats().items()},
            "flops": int(flops.get_total_flops())}


def serve_step_ranks(rank, out, data, cases):
    """:func:`serve_step` of each of ``cases`` (``{name: (arch,
    overrides)}``) on this rank of a ``data`` x ``WORLD / data`` mesh."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh(data=data, model=dist.get_world_size() // data)
    return {name: _guard(lambda a=arch, o=ov: serve_step(
        mesh, serve_config(a, o), "cpu")) for name, (arch, ov) in
        cases.items()}


# ---------------------------------------------------------------------------
# padded uneven heads (tests/test_torch_heads_padded_mesh.py)
# ---------------------------------------------------------------------------

def _padded_slots(tree, shardings):
    """The largest |value| on this rank's padded slots of every leaf of a
    (master-shaped) tree of blocks (0.0 where the rank has none)."""
    from repro_torch.launch.shardings import model_dim, real_range
    from repro_torch.pytree import tree_leaves
    worst = 0.0
    for l, s in zip(tree_leaves(tree), tree_leaves(shardings)):
        d = model_dim(s)
        if d is None:
            continue
        lo, hi = real_range(s.shape[d], s.mesh.shape["model"],
                            s.mesh.model_rank)
        pad = l.narrow(d, hi - lo, l.shape[d] - (hi - lo))
        if pad.numel():
            worst = max(worst, float(pad.abs().max()))
    return worst


def padded_rounds_on(mesh, arch, granularity, server_opt, server_lr, noise,
                     overrides=None, n_rounds=2, sigma=0.5):
    """``n_rounds`` rounds of the reduced ``arch`` (with ``overrides``) on
    ``mesh`` under ``attn_shard="heads_padded"``, the layers' mesh context
    installed: each round's whole master and metrics, the largest |value|
    on this rank's padded slots of its master, update and optimizer state
    after each round, and the functions that made each ``tp_gather`` of
    the rounds (the attention's own gathers are ``_head_projs``')."""
    import inspect
    from repro_torch.core.fl_step import (
        gather_master, make_fl_train_step, make_server_optimizer,
        master_model_dims, shard_master)
    from repro_torch.launch import collectives as coll
    from repro_torch.launch.shardings import tree_shardings
    from repro_torch.models import layers as L
    from repro_torch.models.base import get_family
    from repro_torch.pytree import tree_map
    cfg, params, batch = setup_arch(arch, overrides)
    fam = get_family(cfg.family)
    fl = fl_config(granularity, server_opt, server_lr, sigma)
    stacked = tree_map(lambda l: torch.empty((G,) + tuple(l.shape),
                                             device="meta"), params)
    client_sh = tree_shardings(stacked, cfg, mesh, role="client")
    master_sh = tree_shardings(params, cfg, mesh, role="master")
    callers, real = set(), coll.tp_gather

    def traced(*a, **kw):
        callers.add(inspect.stack()[1].function)
        return real(*a, **kw)

    L.set_mesh_context(mesh, cfg=cfg)
    coll.tp_gather = traced
    try:
        local = shard_master(params, master_sh)
        step = make_fl_train_step(lambda p, b: fam.loss(p, b, cfg), fl,
                                  client_shardings=client_sh,
                                  master_shardings=master_sh)
        opt = make_server_optimizer(fl).init(local)
        rounds = []
        for _ in range(n_rounds):
            new, opt, met = step(local, opt, batch, torch.ones(G) / G,
                                 noise_source(noise))
            rounds.append({
                "master": leaves_np(gather_master(new, master_sh)),
                "delta_norm": float(met["delta_norm"]),
                "weight_sum": float(met["weight_sum"]),
                "pad_master": _padded_slots(new, master_sh),
                "pad_update": _padded_slots(
                    tree_map(torch.sub, new, local), master_sh),
                "pad_opt": max(_padded_slots(t, master_sh) for t in opt
                               if isinstance(t, dict))})
            local = new
    finally:
        coll.tp_gather = real
        L.clear_mesh_context()
    return {"rounds": rounds, "callers": sorted(callers),
            "model_dims": master_model_dims(master_sh),
            "local_shapes": [tuple(l.shape) for l in leaves_np(local)]}


def heads_padded_ranks(rank, out, data, rounds, noise, serve_cases, params,
                       inputs):
    """Every case of tests/test_torch_heads_padded_mesh.py on this rank of
    a ``data`` x ``WORLD / data`` mesh, under ``heads_padded``: ``rounds``
    is ``{name: (arch, granularity, server_opt, server_lr, overrides)}``
    (``noise[name]`` its injected draws), ``serve_cases`` ``{name: (arch,
    overrides)}`` (``params[name]``, ``inputs[name]`` as numpy)."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.shardings import set_sharding_options
    set_sharding_options(attn_shard="heads_padded")
    mesh = make_host_mesh(data=data, model=dist.get_world_size() // data)
    res = {"mesh": mesh.shape, "coords": (mesh.rank, mesh.model_rank)}
    for name, (arch, gran, opt, lr, ov) in rounds.items():
        res[name] = _guard(lambda a=arch, gr=gran, o=opt, l=lr, v=ov,
                           n=name: padded_rounds_on(mesh, a, gr, o, l,
                                                    noise[n], v))
    for name, (arch, ov) in serve_cases.items():
        res[name] = _guard(lambda a=arch, o=ov, n=name: serve_on(
            mesh, serve_config(a, o), params[n], *inputs[n]))
    return res


# ---------------------------------------------------------------------------
# the program audits on the real cohort step (tests/test_torch_analysis_audits.py)
# ---------------------------------------------------------------------------

def _audit_cohort(mesh, k, arena):
    """One cohort of ``k`` members of the tiny testbed at sigma 1 on
    ``mesh``: the step's partition record (this rank's rows) and the
    collectives of the step alone."""
    from repro_torch.core.testbed import build_testbed
    from repro_torch.engine import CohortRunner, EngineConfig
    from repro_torch.launch import collectives as coll
    clients, params, _, _ = build_testbed(tiny_cfg(1.0), device="cpu")
    runner = CohortRunner(clients, EngineConfig(
        mesh=mesh, max_cohort=4, device_arena=arena), "cpu")
    plans = [runner.dispatch(c, params, 100 + c.cid, 0)
             for c in clients[:k]]
    staged = runner.stage_cohort(plans)
    coll.reset_stats()
    runner.submit_cohort(staged)
    return {"partition": runner.last_partition, "collectives": coll.stats(),
            "k_pad": int(len(staged.n_steps))}


def audit_ranks(rank, out):
    """A partitioned arena cohort of 4 (2 members per rank) and a host-fed
    cohort of 3 (whole on every rank) on a W = 2 data axis."""
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh(data=WORLD)
    return {"mesh": mesh.shape, "rank": mesh.rank,
            "full": _guard(lambda: _audit_cohort(mesh, 4, True)),
            "whole": _guard(lambda: _audit_cohort(mesh, 3, False))}
