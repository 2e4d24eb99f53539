"""Clean twin of rep001_bad: every parameter reaches the key, one of
them through a local (``cfg = replace(dp_cfg, ...)``)."""
from dataclasses import replace

_STEP_CACHE = {}


def cached_cohort_step(loss_fn, dp_cfg, opt, dp_path="jnp", arena=True):
    cfg = replace(dp_cfg, noise_multiplier=0.0)
    key = (loss_fn, cfg, opt, dp_path, arena)
    if key not in _STEP_CACHE:
        _STEP_CACHE[key] = (loss_fn, cfg, opt, dp_path, arena)
    return _STEP_CACHE.get(key)
