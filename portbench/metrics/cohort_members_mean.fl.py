"""Mean members per cohort over the window's cohorts (RunLog.cohort_sizes
of every point): how much work one fused cohort step carries."""
LAYER = "engine (engine/engine.py, engine/cohort.py)"
UNIT = "members"
MOVES = "member_steps_per_s"
SOURCE = "program_counter"


def read(run):
    sizes = sum(run.counters.get("point_cohorts", [])[:run.units], [])
    return sum(sizes) / len(sizes) if sizes else None
