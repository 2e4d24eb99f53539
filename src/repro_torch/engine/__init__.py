"""Cohort-batched asynchronous FL execution engine (port of
``repro.engine``): virtual-clock event heap -> ``cohort.pop_cohort``
(staleness window) -> one cohort step per cohort
(``cohort_step.make_cohort_step``, cached by training config) -> the
fused weights-vector merge or ``aggregation.apply_update`` member by
member -> a ``RunLog`` with the legacy loop's schema.  Around it: the
host-fed and arena data paths, the pipelined scheduler
(``EngineConfig.pipeline_depth``), the tiered client-state store
(``statestore``) and checkpoint/resume (``resilience``).

Frontends: ``repro_torch.core.server.run_fedavg`` / ``run_async`` take
``engine="cohort"`` (this package) or ``engine="legacy"`` (the per-client
loop).  ``EngineConfig(mesh=...)`` splits each cohort's members over the
data axis of a process group's ranks (``mesh_backend``).
"""
from repro_torch.engine.cohort import (
    LocalRoundPlan,
    fedavg_weights,
    fold_cohort_weights,
    padded_cohort_size,
    plan_batches,
    pop_cohort,
)
from repro_torch.engine.cohort_step import (
    CLIENT_AXES,
    cached_cohort_step,
    invalidate_step_cache,
    make_cohort_step,
    stack_trees,
    step_builds,
    unstack_tree,
)
from repro_torch.engine.engine import (
    CohortRunner,
    EngineConfig,
    StagedCohort,
    run_async_engine,
    run_fedavg_engine,
)
from repro_torch.engine.mesh_backend import (
    CohortSharding,
    assert_cohort_partitioned,
    cohort_mesh,
    cohort_spec,
)
from repro_torch.engine.resilience import CheckpointPolicy, SimulatedCrash
from repro_torch.engine.statestore import (
    DataArena,
    StoreConfig,
    TieredStateStore,
)

__all__ = [
    "CLIENT_AXES",
    "CheckpointPolicy",
    "CohortRunner",
    "CohortSharding",
    "DataArena",
    "EngineConfig",
    "LocalRoundPlan",
    "SimulatedCrash",
    "StagedCohort",
    "StoreConfig",
    "TieredStateStore",
    "assert_cohort_partitioned",
    "cached_cohort_step",
    "cohort_mesh",
    "cohort_spec",
    "fedavg_weights",
    "fold_cohort_weights",
    "invalidate_step_cache",
    "make_cohort_step",
    "padded_cohort_size",
    "plan_batches",
    "pop_cohort",
    "run_async_engine",
    "run_fedavg_engine",
    "stack_trees",
    "step_builds",
    "unstack_tree",
]
