"""Typed, frozen, serializable experiment specifications (port of
``repro/api/spec.py``).

An :class:`ExperimentSpec` is the complete description of one FL run:

    spec = ExperimentSpec(
        testbed=TestbedConfig(sigma=1.0, batch_size=64),
        strategy=StrategySpec("fedasync", alpha=0.4),
        run=RunBudget(max_updates=300, eval_every=5, target_acc=0.75),
        engine=EngineConfig(staleness_window=45.0),
    )

Specs are frozen value objects that round-trip through plain JSON-able
dicts (``spec.to_dict()`` / ``ExperimentSpec.from_dict(d)``), over the
same closed set of tagged types as the reference, so the reference's
``ExperimentSpec.to_dict()`` JSON decodes here unchanged and one spec
runs on both packages.  A mesh is recorded as its axis sizes
(``{"__mesh__": {"data": 2, "model": 1}}``) and decodes to
:func:`repro_torch.launch.mesh.make_host_mesh` of that shape over the
CURRENT process group's ranks, as the reference rebuilds it over the
current process's devices.

Validation happens at construction: :class:`StrategySpec` checks its name
and params against the registry in :mod:`repro_torch.core.aggregation`,
and :class:`RunBudget` normalizes the eval cadence once.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

from repro_torch.core.aggregation import (
    make_strategy, validate_strategy_params)
from repro_torch.core.dp import DPConfig
from repro_torch.core.faults import FaultModel
from repro_torch.core.fl_step import FLStepConfig
from repro_torch.core.screening import ScreeningConfig
from repro_torch.core.testbed import TestbedConfig
from repro_torch.data.synthetic_ser import SERDataConfig
from repro_torch.engine.engine import EngineConfig
from repro_torch.engine.statestore import StoreConfig
from repro_torch.launch.mesh import HostMesh, make_host_mesh
from repro_torch.models.ser_cnn import SERConfig


@dataclass(frozen=True, init=False)
class StrategySpec:
    """Registry-validated aggregation strategy: ``name`` plus keyword
    params, canonicalized to a sorted tuple so specs hash/compare by
    value.  Replaces the old ``strategy_name``/``alpha``/
    ``staleness_aware``/``**strategy_kw`` keyword pile — a typo'd or
    misplaced param now fails HERE with the valid options listed, not
    deep inside ``make_strategy`` mid-run."""

    name: str
    params: tuple                   # sorted ((key, value), ...)

    def __init__(self, name: str, /, **params):
        name = validate_strategy_params(name, params)
        object.__setattr__(self, "name", name)
        object.__setattr__(self, "params", tuple(sorted(params.items())))

    @property
    def kwargs(self) -> dict:
        return dict(self.params)

    def make(self):
        """Instantiate the aggregation strategy (fresh per run — FedBuff
        carries cross-update buffer state)."""
        return make_strategy(self.name, **self.kwargs)

    def replace(self, **params) -> "StrategySpec":
        """A copy with the given params overriding the current ones."""
        merged = {**self.kwargs, **params}
        return StrategySpec(self.name, **merged)


@dataclass(frozen=True)
class RunBudget:
    """How long a run goes and how often it evaluates.  FedAvg consumes
    ``rounds``; the async strategies consume ``max_updates``/``max_time``
    — carrying both keeps one spec valid across a strategy sweep."""

    rounds: int = 60               # fedavg barrier rounds
    max_updates: int = 300         # async: total merged updates
    max_time: Optional[float] = None   # async: virtual-seconds cap
    eval_every: int = 1            # rounds (fedavg) / updates (async)
    target_acc: Optional[float] = None  # early-stop accuracy

    def __post_init__(self):
        if self.rounds < 0 or self.max_updates < 0:
            raise ValueError(
                f"rounds/max_updates must be >= 0: "
                f"{self.rounds}/{self.max_updates}")
        # THE eval-cadence validation point: every frontend routes its
        # eval_every through here, so a 0 can no longer reach the fedavg
        # loop raw and die on `rnd % 0` (it used to — only the async
        # path clamped)
        object.__setattr__(self, "eval_every", max(1, int(self.eval_every)))


@dataclass(frozen=True)
class ExperimentSpec:
    """One fully-specified experiment.  ``backend`` selects the execution
    path ("cohort" — the batched engine, default — or "legacy", the
    per-client reference loop); everything else is typed sub-config."""

    testbed: TestbedConfig = TestbedConfig()
    strategy: StrategySpec = StrategySpec("fedasync", alpha=0.4)
    run: RunBudget = RunBudget()
    engine: EngineConfig = EngineConfig()
    backend: str = "cohort"

    def __post_init__(self):
        if self.backend not in ("cohort", "legacy"):
            raise ValueError(
                f"backend must be 'cohort' or 'legacy': {self.backend!r}")
        for fld, typ in (("testbed", TestbedConfig),
                         ("strategy", StrategySpec),
                         ("run", RunBudget),
                         ("engine", EngineConfig)):
            if not isinstance(getattr(self, fld), typ):
                raise TypeError(
                    f"ExperimentSpec.{fld} must be a {typ.__name__}: "
                    f"{getattr(self, fld)!r}")

    # -- legacy-frontend bridge -------------------------------------------
    @classmethod
    def from_legacy(cls, strategy_name: str, cfg: TestbedConfig = None,
                    rounds: int = 60, max_updates: int = 300,
                    alpha: float = 0.4, staleness_aware: bool = True,
                    target_acc: Optional[float] = None, eval_every: int = 1,
                    engine: str = "cohort", engine_cfg: EngineConfig = None,
                    mesh=None, **strategy_kw) -> "ExperimentSpec":
        """Build a spec from ``run_experiment``'s historical signature
        (the shim calls this, so old call sites keep working verbatim)."""
        name = str(strategy_name).lower()
        if name == "fedavg":
            kw = dict(strategy_kw)
        else:
            kw = dict(alpha=alpha)
            if name == "fedasync":
                kw["staleness_aware"] = staleness_aware
            kw.update(strategy_kw)
            if name == "fedasync_nostale":
                # historical tolerance: the old frontend silently dropped
                # this (the variant pins it False)
                kw.pop("staleness_aware", None)
        ecfg = engine_cfg or EngineConfig()
        if mesh is not None and ecfg.mesh is None:
            ecfg = dataclasses.replace(ecfg, mesh=mesh)
        return cls(
            testbed=cfg if cfg is not None else TestbedConfig(),
            strategy=StrategySpec(name, **kw),
            run=RunBudget(rounds=rounds, max_updates=max_updates,
                          eval_every=eval_every, target_acc=target_acc),
            engine=ecfg,
            backend=engine,
        )

    # -- serialization -----------------------------------------------------
    def to_dict(self) -> dict:
        """Plain JSON-able dict (nested configs become tagged dicts)."""
        return encode(self)

    @classmethod
    def from_dict(cls, d: dict) -> "ExperimentSpec":
        spec = decode(d)
        if not isinstance(spec, cls):
            raise ValueError(f"not an ExperimentSpec dict: {d!r}")
        return spec


def replace_path(spec: ExperimentSpec, path: str, value) -> ExperimentSpec:
    """Functional update through a dotted field path — the sweep-axis
    primitive: ``replace_path(spec, "testbed.sigma", 2.0)`` or a whole
    sub-config at once (``replace_path(spec, "strategy", StrategySpec(
    "fedbuff", alpha=0.4))``)."""
    head, _, rest = path.partition(".")
    if not hasattr(spec, head):
        raise ValueError(
            f"{type(spec).__name__} has no field {head!r} (path {path!r})")
    if not rest:
        return dataclasses.replace(spec, **{head: value})
    return dataclasses.replace(
        spec, **{head: replace_path(getattr(spec, head), rest, value)})


# ---------------------------------------------------------------------------
# dict codec: tagged encoding for the closed set of spec-carrying types
# ---------------------------------------------------------------------------

_SPEC_TYPES = {cls.__name__: cls for cls in (
    ExperimentSpec, StrategySpec, RunBudget, TestbedConfig, SERDataConfig,
    SERConfig, EngineConfig, StoreConfig, DPConfig, FLStepConfig, FaultModel,
    ScreeningConfig)}


def encode(obj):
    """Recursively encode a spec object to JSON-able data: dataclasses of
    the closed spec-type set become ``{"__type__": name, ...}`` dicts; a
    mesh is recorded as its axis sizes (``{"__mesh__": {"data": 8,
    "model": 1}}``)."""
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    if isinstance(obj, StrategySpec):
        return {"__type__": "StrategySpec", "name": obj.name,
                "params": {k: encode(v) for k, v in obj.params}}
    if dataclasses.is_dataclass(obj) and type(obj).__name__ in _SPEC_TYPES:
        out = {"__type__": type(obj).__name__}
        for f in dataclasses.fields(obj):
            out[f.name] = encode(getattr(obj, f.name))
        return out
    if isinstance(obj, HostMesh):
        return {"__mesh__": {str(a): int(s) for a, s in obj.shape.items()}}
    if isinstance(obj, (tuple, list)):
        return [encode(v) for v in obj]
    if hasattr(obj, "item") and getattr(obj, "shape", None) == ():
        return obj.item()          # numpy/torch scalar
    raise ValueError(
        f"cannot encode {type(obj).__name__!r} into a spec dict: {obj!r}")


def decode(d):
    """Inverse of :func:`encode`; also reads the reference's encoding
    (including its ``use_kernel`` -> ``dp_path`` migration).  A mesh
    decodes to a host mesh over the current process group (every rank of
    a group must decode it: building one is a collective call)."""
    if isinstance(d, list):
        return [decode(v) for v in d]
    if not isinstance(d, dict):
        return d
    if "__mesh__" in d:
        axes = d["__mesh__"]
        extra = set(axes) - {"data", "model"}
        if extra:
            raise ValueError(
                f"cannot rebuild a mesh with axes {sorted(extra)} — only "
                "host meshes over (data, model) round-trip")
        return make_host_mesh(data=int(axes.get("data", 1)),
                              model=int(axes.get("model", 1)))
    tag = d.get("__type__")
    if tag is None:
        return {k: decode(v) for k, v in d.items()}
    if tag == "StrategySpec":
        return StrategySpec(d["name"], **{k: decode(v)
                                          for k, v in d["params"].items()})
    cls = _SPEC_TYPES.get(tag)
    if cls is None:
        raise ValueError(f"unknown spec type tag {tag!r}")
    if tag == "TestbedConfig" and "use_kernel" in d and "dp_path" not in d:
        # pre-dp_path specs carried a `use_kernel` bool; map it onto the
        # selector so archived JSON keeps meaning what it meant
        d = dict(d)
        d["dp_path"] = "pallas" if d.pop("use_kernel") else "jnp"
    kw = {}
    for f in dataclasses.fields(cls):
        if f.name in d:
            v = decode(d[f.name])
            # JSON turns tuples into lists; restore for tuple-typed fields
            if isinstance(v, list) and isinstance(
                    getattr(cls, f.name, None), tuple):
                v = tuple(v)
            kw[f.name] = v
    return cls(**kw)
