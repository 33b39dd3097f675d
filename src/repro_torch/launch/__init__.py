"""Launchers and meshes. Port of ``src/repro/launch/`` (``serve``,
``train`` and ``mesh``; ``dryrun`` is not ported yet)."""
