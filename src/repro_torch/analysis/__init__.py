"""Port of ``repro.analysis``: so far only the step-build budget
(:mod:`repro_torch.analysis.guard`)."""
