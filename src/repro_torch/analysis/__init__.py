"""Static analysis and program audits for the PyTorch port (port of
``repro.analysis``).

* **Lint time** — :mod:`repro_torch.analysis.lint` and
  :mod:`repro_torch.analysis.rules`: ``python -m
  repro_torch.analysis.lint src/repro_torch`` runs the REP rules over
  the port's sources (REP004 has no counterpart: PyTorch donates no
  buffer).
* **Run time** — :mod:`repro_torch.analysis.audits` checks what a run
  leaves behind (this rank's cohort rows, the arenas' storages, the
  collective counts, the recorded engine stats) on top of the program
  walk in :mod:`repro_torch.analysis.hlo`, and
  :mod:`repro_torch.analysis.guard` makes the sweep's step-build budget
  structural (``Session.sweep`` runs under :func:`compile_guard`).

``parse_module`` has no counterpart: the port emits no HLO text.
"""
from repro_torch.analysis.audits import (
    AuditFailure, audit_collectives, audit_donation, audit_engine_stats,
    audit_sharding)
from repro_torch.analysis.guard import (
    CompileBudgetExceeded, compile_guard, step_signature, sweep_max_builds)
from repro_torch.analysis.hlo import analyze, donation_aliases

__all__ = [
    "AuditFailure", "CompileBudgetExceeded",
    "analyze", "donation_aliases",
    "audit_collectives", "audit_donation", "audit_engine_stats",
    "audit_sharding",
    "compile_guard", "step_signature", "sweep_max_builds",
]
