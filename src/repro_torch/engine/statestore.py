"""The tiered client-state store's config (port of
``repro/engine/statestore.py``, config only; STORE.md).

:class:`StoreConfig` is here so that reference specs carrying it decode
(``repro_torch.api.spec``).  ``hot_slots=None``, the default, is the
all-resident arena the port runs; a bounded hot set is not ported yet,
and ``EngineConfig`` raises on one, naming ROADMAP.md queue 1 item 11.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class StoreConfig:
    """``hot_slots`` bounds the device arena to that many client rows
    (``None``: all resident); ``lookahead`` is how many upcoming
    completions the prefetcher stages."""

    hot_slots: Optional[int] = None
    lookahead: int = 8

    def __post_init__(self):
        if self.hot_slots is not None and (
                self.hot_slots != int(self.hot_slots) or self.hot_slots < 1):
            raise ValueError(
                f"StoreConfig.hot_slots must be None (all-resident) or an "
                f"integer >= 1: {self.hot_slots!r}")
        if self.lookahead != int(self.lookahead) or self.lookahead < 0:
            raise ValueError(
                f"StoreConfig.lookahead must be an integer >= 0: "
                f"{self.lookahead!r}")
