"""Bytes and operations of the two ``dp_clip`` kernels (float32), as
``chip_smoke.py`` [times] counts them: each input byte read once, each
output byte written once.

    norms pass        (R, D) rows -> (R,) squared norms
    clipped mean      (K*B, D) rows, (K*B,) scales [, (K, D) noise + one
                      stddev] -> (K, D) means
"""
from portbench.roofline.peaks import F32_FLOPS, bound_s


def sqnorm(r: int, d: int):
    """-> (bytes, flops) of the norms pass over (r, d) rows."""
    return r * d * 4 + r * 4, 2 * r * d


def scale_mean(k: int, b: int, d: int, noise: bool):
    """-> (bytes, flops) of the clipped mean of a K-member cohort."""
    nbytes = k * b * d * 4 + k * b * 4 + k * d * 4
    flops = 2 * k * b * d
    if noise:
        nbytes += k * d * 4 + 4
        flops += 2 * k * d
    return nbytes, flops


def step_bound_s(k: int, b: int, d: int, noise: bool = True) -> float:
    """Least time of one local step's two launches over a K-member
    cohort: the norms pass over K*B rows and the clipped mean."""
    return (bound_s(*sqnorm(k * b, d), F32_FLOPS)
            + bound_s(*scale_mean(k, b, d, noise), F32_FLOPS))
