"""Whole-step share of the chip's peak: per member local step the least
time the card could take (the larger of the CNN's forward and backward
operations over the f32 peak, TF32 being off, and the per-example
gradient matrix's bytes, written once and read once, over the memory
rate), summed over the window's member steps, over the window."""
from portbench.roofline import ser_cnn
from portbench.roofline.peaks import F32_FLOPS, bound_s

LAYER = "whole step"
UNIT = "%"
MOVES = "member_steps_per_s"
SOURCE = "host_clock"


def read(run):
    c = run.counters
    steps = sum(c.get("point_steps", [])[:run.units])
    if not steps:
        return None
    per = bound_s(*ser_cnn.member_step(vars(c["model"]), c["batch_size"]),
                  F32_FLOPS)
    return 100.0 * per * steps / run.window_s
