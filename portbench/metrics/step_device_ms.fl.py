"""Device busy milliseconds (union of device intervals) per member local
step over the traced window."""
LAYER = "fused cohort step (engine/cohort_step.py, core/dp.py)"
UNIT = "ms"
MOVES = "member_steps_per_s"
SOURCE = "device_trace"


def read(run):
    steps = sum(run.counters.get("point_steps", [])[:run.units])
    if not steps or not run.tracer.kernels:
        return None
    return run.tracer.busy_s() * 1e3 / steps
