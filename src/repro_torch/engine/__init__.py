"""Port of ``repro.engine``."""
