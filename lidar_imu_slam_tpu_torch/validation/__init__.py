"""Validation tooling: the independent numpy oracle of the reference's wired
odometry path, used by the trajectory-parity tests and `chip_smoke.py`."""

from . import oracle  # noqa: F401
