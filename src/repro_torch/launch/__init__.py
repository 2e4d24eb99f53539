"""Launchers (port of ``repro/launch``): ``python -m
repro_torch.launch.train sim|spmd``."""
