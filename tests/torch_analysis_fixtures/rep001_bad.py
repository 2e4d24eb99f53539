"""Seeded REP001 violation: the step cache's key tuple leaves out
``dp_path``, so two testbeds differing only in DP implementation share
one built step."""
_STEP_CACHE = {}


def cached_cohort_step(loss_fn, dp_cfg, opt, dp_path="jnp", arena=True):
    key = (loss_fn, dp_cfg, opt, arena)
    if key not in _STEP_CACHE:
        _STEP_CACHE[key] = (loss_fn, dp_cfg, opt, dp_path, arena)
    return _STEP_CACHE[key]
