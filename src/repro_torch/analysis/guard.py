"""Step-build budget: "one built cohort step per sigma sweep" as a checked
rule (port of ``repro/analysis/guard.py``).

The noise scale is a runtime argument of the cohort step, so a sigma
sweep reuses one cached step (:func:`repro_torch.engine.cohort_step.
cached_cohort_step`).  :func:`compile_guard` checks that at the execution
site: ``Session.sweep`` runs its grid inside a guard whose budget comes
from the grid itself (:func:`sweep_max_builds`), so a step rebuilt per
point — a config field leaking into the cache key, sigma read statically
again — fails the sweep there.  The port builds no compiled program; the
name is the reference's, and the budget counts
:func:`~repro_torch.engine.cohort_step.step_builds`, the step cache's
misses.
"""
from __future__ import annotations

import contextlib
import dataclasses

from repro_torch.analysis.audits import AuditFailure


class CompileBudgetExceeded(AuditFailure):
    """More cohort steps were built than the region's budget."""


def step_signature(spec):
    """The build identity of a spec: two specs with equal signatures share
    one cached cohort step.  Sigma only matters as noise on/off, and
    faults and screening never reach the step (corruption scales are a
    runtime (K,) argument, thresholds compare on the host).  ``None`` for
    specs that never touch the step cache (legacy backend)."""
    if spec.backend != "cohort":
        return None
    tb = dataclasses.replace(
        spec.testbed,
        sigma=1.0 if (spec.testbed.use_dp and spec.testbed.sigma > 0)
        else 0.0,
        faults=None, screening=None)
    return (tb, spec.engine)


def sweep_max_builds(specs) -> int:
    """Upper bound on step builds for running ``specs`` cold: the number of
    distinct build signatures in the grid.  A warm session builds fewer
    (possibly zero); more means a rebuild leak."""
    return len({sig for sig in map(step_signature, specs)
                if sig is not None})


@dataclasses.dataclass
class GuardReport:
    """Live view of a :func:`compile_guard` region: ``delta`` is the number
    of step builds since entry."""

    start: int
    max_builds: int
    label: str = "compile_guard"

    @property
    def delta(self) -> int:
        from repro_torch.engine.cohort_step import step_builds
        return step_builds() - self.start


@contextlib.contextmanager
def compile_guard(max_builds: int, label: str = "compile_guard"):
    """Fail if more than ``max_builds`` cohort steps are built inside the
    ``with`` block (checked on clean exit only, so an exception already on
    its way out is never masked)."""
    from repro_torch.engine.cohort_step import step_builds
    if max_builds < 0:
        raise ValueError(f"max_builds must be >= 0: {max_builds}")
    report = GuardReport(start=step_builds(), max_builds=max_builds,
                         label=label)
    yield report
    delta = report.delta
    if delta > max_builds:
        raise CompileBudgetExceeded(
            f"{label}: {delta} cohort steps built in a region budgeted for "
            f"{max_builds}. A rebuild is leaking: most likely a config value "
            "that should be a runtime argument (sigma was one) entered the "
            "cached_cohort_step key, so consecutive grid points stopped "
            "sharing a step.")


__all__ = ["CompileBudgetExceeded", "GuardReport", "compile_guard",
           "step_signature", "sweep_max_builds"]
