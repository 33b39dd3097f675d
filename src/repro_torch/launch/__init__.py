"""Launchers. Port of ``src/repro/launch/`` (``serve`` only so far)."""
