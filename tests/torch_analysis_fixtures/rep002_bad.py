"""Seeded REP002 violation: ``InnerConfig`` is nested in the registered
``OuterSpec`` but missing from ``_SPEC_TYPES``."""
from dataclasses import dataclass, field


@dataclass(frozen=True)
class InnerConfig:
    clip_norm: float = 1.0


@dataclass(frozen=True)
class OuterSpec:
    inner: InnerConfig = field(default_factory=InnerConfig)
    rounds: int = 2


_SPEC_TYPES = {cls.__name__: cls for cls in (OuterSpec,)}
