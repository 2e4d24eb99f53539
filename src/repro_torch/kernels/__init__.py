"""Hand-written GPU kernels of the port, each beside its plain PyTorch
version: ``dp_clip`` in Triton; ``ssd_scan`` and ``flash_attn`` in CUDA
C++ (``csrc/``, built by :mod:`.build`).  :mod:`.common` holds the
dispatch rule."""
