"""Mamba2 SSD intra-chunk block: the CUDA C++ kernel's launcher
(:mod:`.ssd_scan`, source ``kernels/csrc/ssd_intra.cu``), its plain
version (:mod:`.ref`) and the dispatching wrapper (:mod:`.ops`)."""
