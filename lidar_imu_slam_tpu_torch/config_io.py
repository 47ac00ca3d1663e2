"""Config loading: YAML / dict overrides over the frozen defaults
(counterpart of the JAX package's `config_io.py`, on the port's config).

The reference's config is ROS parameters with inline defaults (SURVEY §5
"Config / flag system"; reference lidar/frame.hpp:64-80, odom_run.cpp:19-35,
and the limu.launch:4 comment referencing a parameter file that doesn't
exist). Here: nested dicts / YAML files override the dataclass defaults,
with unknown keys rejected loudly.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

from . import config as cfgmod


def _apply(dc, overrides: Mapping[str, Any]):
    fields = {f.name: f for f in dataclasses.fields(dc)}
    kw = {}
    for key, value in overrides.items():
        if key not in fields:
            raise KeyError(
                f"unknown config key '{key}' for {type(dc).__name__}; "
                f"valid: {sorted(fields)}"
            )
        current = getattr(dc, key)
        if dataclasses.is_dataclass(current) and isinstance(value, Mapping):
            kw[key] = _apply(current, value)
        else:
            kw[key] = type(current)(value) if current is not None else value
    return dataclasses.replace(dc, **kw)


def from_dict(overrides: Mapping[str, Any], base=None) -> cfgmod.PipelineConfig:
    """PipelineConfig from nested dict overrides, e.g.
    {"map": {"voxel_size": 0.5}, "icp": {"deskew": True}}."""
    base = base if base is not None else cfgmod.PipelineConfig()
    return _apply(base, overrides)


def from_yaml(path: str, base=None) -> cfgmod.PipelineConfig:
    try:
        import yaml
    except ImportError as e:
        raise ImportError("from_yaml needs PyYAML (the yaml module); "
                          "from_dict takes the same overrides as a dict") from e

    with open(path) as f:
        data = yaml.safe_load(f) or {}
    return from_dict(data, base)


def to_dict(cfg) -> dict:
    return dataclasses.asdict(cfg)
