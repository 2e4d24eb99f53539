"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
the 700 W power limit): the denominators of every roofline and mfu share
in this benchmark."""

BF16_FLOPS = 989e12      # tensor cores, bf16 / fp16
F32_FLOPS = 67e12        # float32 outside the tensor cores (TF32 off)
HBM_BYTES_PER_S = 3.35e12


def bound_s(nbytes: float, flops: float, peak: float = F32_FLOPS) -> float:
    """The least time the card could take: the larger of bytes over the
    memory rate and operations over the peak rate of their type."""
    return max(nbytes / HBM_BYTES_PER_S, flops / peak)
