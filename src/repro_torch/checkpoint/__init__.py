"""Durable flat-npz checkpoint store (port of ``repro/checkpoint``; see
checkpoint.py for the atomic publish / retention / key-escaping
contract)."""
from repro_torch.checkpoint.checkpoint import (  # noqa: F401
    latest_step, load_flat, restore, save)

__all__ = ["save", "restore", "load_flat", "latest_step"]
