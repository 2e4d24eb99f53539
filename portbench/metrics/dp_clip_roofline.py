"""Share of their roofline that the ``dp_clip`` kernels reach: the least
time of every launch of the window (norms pass over K*B rows and clipped
mean with noise, K the padded cohort size, one pair per local step of a
cohort) over the kernels' profiled device time."""
from portbench.roofline import dp_clip, ser_cnn

LAYER = "kernels (kernels/dp_clip)"
UNIT = "%"
MOVES = "member_steps_per_s"
SOURCE = "device_trace"
NAMES = ("_sqnorm_kernel", "_sqnorm_finish_kernel", "_scale_mean_kernel")


def padded(k: int) -> int:
    return 1 << max(0, k - 1).bit_length()


def read(run):
    c = run.counters
    sizes = sum(c.get("point_cohorts", [])[:run.units], [])
    if not sizes:
        return None
    t = run.tracer.kernel_seconds(lambda n: any(s in n for s in NAMES))
    if t <= 0:
        return None
    d = ser_cnn.param_count(vars(c["model"]))
    bound = sum(c["local_steps"] * dp_clip.step_bound_s(
        padded(k), c["batch_size"], d) for k in sizes)
    return 100.0 * bound / t
