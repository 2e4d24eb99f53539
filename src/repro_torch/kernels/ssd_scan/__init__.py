"""Mamba2 SSD intra-chunk block: the CUDA C++ kernels' launcher
(:mod:`.ssd_scan`; sources ``kernels/csrc/ssd_intra_tc.cu`` for bf16 and
``kernels/csrc/ssd_intra.cu`` for f32), their plain version (:mod:`.ref`)
and the dispatching wrapper (:mod:`.ops`)."""
