"""PyTorch/CUDA port of the asynchronous-FL reproduction (``repro``).

The JAX package ``repro`` is the reference; this package mirrors its
module layout file for file and never imports it (nor ``jax``).  Entry
points run on ``cuda`` unless the caller passes ``device="cpu"``
(:func:`repro_torch.device.resolve_device`); per-example DP clipping runs
as hand-written Triton kernels on the card
(:mod:`repro_torch.kernels.dp_clip`).
"""
