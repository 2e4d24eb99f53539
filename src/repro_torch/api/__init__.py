"""Port of ``repro.api``."""
