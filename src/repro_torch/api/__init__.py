"""Declarative experiment API (port of ``repro.api``): ``ExperimentSpec``
+ ``Session``.

    from repro_torch.api import ExperimentSpec, RunBudget, Session, \\
        StrategySpec
    from repro_torch.core.testbed import TestbedConfig

    spec = ExperimentSpec(
        testbed=TestbedConfig(sigma=1.0, dp_path="pallas"),
        strategy=StrategySpec("fedasync", alpha=0.4),
        run=RunBudget(max_updates=300, eval_every=5),
    )
    session = Session()                      # the card; Session("cpu")
    params, log = session.run(spec)
    result = session.sweep(spec, axes={"testbed.sigma": [0.5, 1, 1.5, 2]})
    for row in result.table():
        print(row)

``spec.to_dict()`` / ``ExperimentSpec.from_dict`` round-trip the whole
configuration through JSON, and read the reference's JSON unchanged.
"""
from repro_torch.api.session import Session, SweepResult
from repro_torch.api.spec import (
    ExperimentSpec,
    RunBudget,
    StrategySpec,
    decode,
    encode,
    replace_path,
)
from repro_torch.api.workloads import (
    Workload,
    get_workload,
    register_workload,
    workload_names,
)

__all__ = [
    "ExperimentSpec",
    "RunBudget",
    "Session",
    "StrategySpec",
    "SweepResult",
    "Workload",
    "decode",
    "encode",
    "get_workload",
    "register_workload",
    "replace_path",
    "workload_names",
]
