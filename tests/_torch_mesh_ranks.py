"""Gloo ranks for the port's mesh tests (``tests/test_torch_mesh.py``,
``tests/test_torch_spmd.py``).

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


def session_spec_dict():
    """A spec whose engine carries a (WORLD, 1) mesh, as JSON data: it
    decodes to that mesh on WORLD ranks and to (1, 1) in one process."""
    from repro_torch.api import ExperimentSpec, RunBudget
    from repro_torch.engine import EngineConfig
    d = ExperimentSpec(
        testbed=tiny_cfg(1.0), run=RunBudget(max_updates=8, eval_every=4),
        engine=EngineConfig(staleness_window=1e9, max_cohort=4)).to_dict()
    d["engine"]["mesh"] = {"__mesh__": {"data": WORLD, "model": 1}}
    return d


def collective_cases(mesh):
    """The collectives module's tree and tensor operations on known
    values: each rank's inputs are a function of its rank."""
    from repro_torch.launch import collectives as coll
    g, r = mesh.group, mesh.rank
    whole = {"a": torch.arange(24.0).reshape(2, 4, 3),
             "b": torch.arange(5.0)}
    dims = [1, None]                   # "a" split on dim 1, "b" replicated
    mine = coll.shard_tree(whole, dims, r, WORLD)
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


def setup_arch(arch):
    """``tests/test_torch_train_zoo.py``'s port half of ``setup_arch``
    (f32): the reduced config, the seeded params and the batch."""
    from repro_torch.configs import get_config
    from repro_torch.models.base import get_family
    cfg = get_config(arch).reduced().replace(param_dtype="float32",
                                             ssm_chunk=SEQ)
    params = get_family(cfg.family).init_params(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(1)
    b = G * N_MICRO * PER_MICRO
    toks = rng.integers(0, cfg.vocab, size=(b, SEQ + 1)).astype(np.int32)
    batch = {"tokens": torch.from_numpy(toks[:, :SEQ]),
             "labels": torch.from_numpy(toks[:, 1:])}
    return cfg, params, batch


def fl_config(granularity, server_opt, server_lr):
    from repro_torch.core.dp import DPConfig
    from repro_torch.core.fl_step import FLStepConfig
    return FLStepConfig(
        num_clients=G, n_local=1, n_micro=N_MICRO, local_lr=0.05,
        server_lr=server_lr, server_opt=server_opt, compute_dtype="float32",
        dp=DPConfig(1.0, 0.5, granularity))


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
