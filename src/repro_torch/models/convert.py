"""Param conversion between the reference's numpy form and the port.

Both packages keep the same JAX shapes at their public surface (conv
``w`` (K, Cin, Cout), dense ``w`` (din, dout), stacked layer leaves
(n_seg, seg_len, ...)), so conversion is a device copy of every leaf —
no transposes.  The parity tests start both packages from the
reference's params through :func:`params_from_numpy` (``jax.random``
streams cannot be replayed by ``torch.Generator``).
"""
from __future__ import annotations

import numpy as np
import torch


def _leaf_to_tensor(leaf, device):
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":
        # numpy has no bf16 of its own: go through f32, which is exact
        return torch.as_tensor(arr.astype(np.float32),
                               device=device).to(torch.bfloat16)
    if arr.dtype == np.float64:
        # JAX's canonical float (x64 off) is float32
        arr = arr.astype(np.float32)
    return torch.as_tensor(np.array(arr), device=device)


def params_from_numpy(tree, device="cpu"):
    """Nested dict of array-likes (e.g. the reference params after
    ``np.asarray``) -> nested dict of tensors on ``device``, each leaf in
    its own dtype (bf16 stays bf16); ``None`` leaves stay ``None``."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if tree is None:
        return None
    return _leaf_to_tensor(tree, device)


def params_to_numpy(params):
    """Nested dict of tensors -> nested dict of numpy f32 arrays
    (``None`` leaves stay ``None``)."""
    if isinstance(params, dict):
        return {k: params_to_numpy(v) for k, v in params.items()}
    if params is None:
        return None
    return params.detach().to("cpu", torch.float32).numpy()
