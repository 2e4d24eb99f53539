"""Param conversion between the reference's numpy form and the port.

Both packages keep the same JAX shapes at their public surface (conv
``w`` (K, Cin, Cout), dense ``w`` (din, dout)), so conversion is a
device copy of every leaf — no transposes.  The parity tests start both
packages from the reference's initial params through
:func:`params_from_numpy` (``jax.random`` streams cannot be replayed by
``torch.Generator``).
"""
from __future__ import annotations

import numpy as np
import torch


def params_from_numpy(tree, device="cpu"):
    """Nested dict of array-likes (e.g. the reference params after
    ``np.asarray``) -> nested dict of f32 tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    return torch.as_tensor(np.array(tree, dtype=np.float32), device=device)


def params_to_numpy(params):
    """Nested dict of tensors -> nested dict of numpy f32 arrays."""
    if isinstance(params, dict):
        return {k: params_to_numpy(v) for k, v in params.items()}
    return params.detach().to("cpu", torch.float32).numpy()
