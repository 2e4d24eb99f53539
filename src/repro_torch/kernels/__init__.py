"""Hand-written GPU kernels of the port (Triton), each beside its plain
PyTorch version; :mod:`repro_torch.kernels.common` holds the dispatch
rule."""
