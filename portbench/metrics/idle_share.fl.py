"""Share of the traced window in which no device activity ran (1 - the
union of device intervals over the window)."""
LAYER = "device"
UNIT = "%"
MOVES = "member_steps_per_s"
SOURCE = "device_trace"


def read(run):
    if not run.tracer.kernels:
        return None
    return 100.0 * (1.0 - run.tracer.busy_s() / run.window_s)
