"""The port's pipeline configuration of a configuration file."""

from __future__ import annotations

import dataclasses


def port_config(config: dict):
    """The port's configuration of a configuration file: its preset, the
    file's overrides, then `streams.batch_config` with the file's unroll;
    raises unless it equals the file's `pipeline` record."""
    from lidar_imu_slam_tpu_torch import config as lis_config
    from lidar_imu_slam_tpu_torch.parallel import streams

    cfg = getattr(lis_config, config["preset"])()
    for group, fields in config.get("overrides", {}).items():
        cfg = cfg.replace(**{group: dataclasses.replace(getattr(cfg, group), **fields)})
    cfg = streams.batch_config(cfg, config["batch"]["outer"], config["batch"]["inner"])
    as_run = dataclasses.asdict(cfg)
    if as_run != config["pipeline"]:
        diff = {g: {k: (v, config["pipeline"].get(g, {}).get(k)) for k, v in f.items()
                    if config["pipeline"].get(g, {}).get(k) != v}
                for g, f in as_run.items()}
        raise ValueError(f"the configuration file's pipeline is not what runs: "
                         f"{ {g: d for g, d in diff.items() if d} }")
    return cfg
