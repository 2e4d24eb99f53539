"""Fused per-example clip + mean (+ Gaussian noise): Triton kernels
(:mod:`.dp_clip`), their plain version (:mod:`.ref`) and the dispatching
wrapper (:mod:`.ops`)."""
