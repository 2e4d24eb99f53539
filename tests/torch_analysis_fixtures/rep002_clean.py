"""Clean twin of rep002_bad: the nested config is registered too."""
from dataclasses import dataclass, field


@dataclass(frozen=True)
class InnerConfig:
    clip_norm: float = 1.0


@dataclass(frozen=True)
class OuterSpec:
    inner: InnerConfig = field(default_factory=InnerConfig)
    rounds: int = 2


_SPEC_TYPES = {cls.__name__: cls for cls in (OuterSpec, InnerConfig)}
