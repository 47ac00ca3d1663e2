"""A small cell built in a temporary directory from new files only (a
configuration, a mix, a BENCHMARK.json naming them and the benchmark's
metric readers and drivers), as a later change adds one: the harness runs
it on the CPU with the port's plain kernel versions."""

from __future__ import annotations

import dataclasses
import json
import os
import shutil

from odom_bench.common import manifest

SMALL = {"lidar": {"max_points": 4096}, "map": {"capacity": 16384},
         "icp": {"max_map_points": 2048, "max_source_points": 512}}
# the Monte-Carlo VLP-16 pipeline (configs/vlp16_mc.json) with a 4096-point buffer
SMALL_MC = {"lidar": {"num_scan_lines": 16, "max_points": 4096, "min_range": 1.0,
                      "max_range": 40.0, "sort_by_time": False},
            "map": {"voxel_size": 1.0, "max_range": 40.0, "capacity": 8192, "neighborhood": 8,
                    "nn_points": 2, "grid_z": 32, "store_points": False},
            "icp": {"max_map_points": 2048, "max_source_points": 512, "gn_backend": "pallas"}}


def pipeline(preset: str, overrides: dict) -> dict:
    from lidar_imu_slam_tpu_torch import config as lis_config
    from lidar_imu_slam_tpu_torch.parallel import streams

    cfg = getattr(lis_config, preset)()
    for group, fields in overrides.items():
        cfg = cfg.replace(**{group: dataclasses.replace(getattr(cfg, group), **fields)})
    return dataclasses.asdict(streams.batch_config(cfg, 2, 4))


def build(tmp: str, preset: str = "kitti_64beam", streams: int = 4, compare: int = 2,
          driver: str = "fleet", ensembles: int = 2) -> str:
    """Write the cell `small.s<streams>`'s files under tmp; returns its
    name. With driver `ensemble` the preset is the Monte-Carlo VLP-16
    pipeline (`preset` is not read) and the streams are `ensembles`
    ensembles of streams // ensembles."""
    if driver == "ensemble":
        return _write(tmp, _ensemble_config(), {"ensembles": ensembles,
                                                "members": streams // ensembles,
                                                "noise_sigma": 0.01}, streams, compare)
    rolling = preset == "kitti_64beam"
    if rolling:  # a spinning sensor in make_world's street, empty returns
        world = {"kind": "box", "n_points": 20000, "extent": [20.0, 15.0, 6.0]}
        sensor = {"fov_deg": {"horizontal": 360.0, "vertical": [-30.0, 15.0]},
                  "ring": {"kind": "elevation", "lines": 64, "fov": [-30.0, 15.0]},
                  "dropout": 0.05, "centre": [5.0, 0.0], "speed": 2.0}
    else:  # six interleaved lines in the ring street
        world = {"kind": "ring_street", "n_points": 30000, "half_width": 8.0, "height": 6.0}
        sensor = {"fov_deg": {"horizontal": 360.0, "vertical": [-38.6, 38.6]},
                  "ring": {"kind": "interleaved", "lines": 6}, "dropout": 0.0,
                  "centre": [0.0, 0.0], "speed": 4.0}
    config = {
        "name": "small", "preset": preset, "batch": {"outer": 2, "inner": 4},
        "overrides": SMALL,
        "world": world,
        "drive": {"kind": "circuit", "dt": 0.1, "scans_per_lap": 200,
                  "z": 2.0, "rolling": rolling, "points": 4096,
                  "min_range": 2.5 if rolling else 5.0, "max_range": 30.0, "noise": 0.02,
                  **sensor},
        "reference_grid": {"x": [-48, 48], "y": [-48, 48], "z": [-8, 10]},
        "limits": {"pose_gap_m": 0.01, "pose_gap_rad": 0.001, "sigma_gap_rel": 1e-9,
                   "map_off_share": 0.01, "ref_out_of_box": 0, "scans_compared": 5},
        "pipeline": pipeline(preset, SMALL),
    }
    return _write(tmp, config, {"streams": streams}, streams, compare)


def _ensemble_config() -> dict:
    """vlp16_mc's world and sensor at a 4096-point buffer and a 40,000-point
    world."""
    with open(os.path.join(manifest.BENCH_DIR, "configs", "vlp16_mc.json")) as f:
        config = json.load(f)
    config.update(name="small", overrides=SMALL_MC, pipeline=pipeline("default", SMALL_MC))
    config["world"] = dict(config["world"], n_points=40000)
    config["drive"] = dict(config["drive"], points=4096)
    config["limits"] = {"pose_gap_m": 0.01, "pose_gap_rad": 0.001, "sigma_gap_rel": 1e-9,
                        "map_off_share": 0.01, "ref_out_of_box": 0, "scans_compared": 5,
                        "scan_gap": 0}
    return config


def _write(tmp: str, config: dict, mix_streams: dict, streams: int, compare: int) -> str:
    mix = {**mix_streams, "warmup_steps": 4, "compare_streams": compare,
           "profile_steps": 3, "enqueue_steps": 2, "opcount_steps": 1}
    os.makedirs(os.path.join(tmp, "configs"), exist_ok=True)
    os.makedirs(os.path.join(tmp, "mixes"), exist_ok=True)
    with open(os.path.join(tmp, "configs", "small.json"), "w") as f:
        json.dump(config, f)
    with open(os.path.join(tmp, "mixes", f"s{streams}.json"), "w") as f:
        json.dump(mix, f)
    for folder in ("metrics", "drivers"):
        shutil.copytree(os.path.join(manifest.BENCH_DIR, folder), os.path.join(tmp, folder),
                        dirs_exist_ok=True, ignore=shutil.ignore_patterns("__pycache__"))
    man = manifest.load_manifest(os.path.dirname(manifest.BENCH_DIR))
    name = f"small.s{streams}"
    man["configs"] = [{"name": "small", "source": "odom_bench/tests/cells.py",
                       "file": "configs/small.json", "reduced": [], "why": "tests"}]
    man["workloads"] = [{"name": name, "config": "small", "traffic": f"s{streams}", "chips": 1,
                         "why": "tests"}]
    for m in man["per_layer"]:
        m["workloads"] = [name]
    with open(os.path.join(tmp, "BENCHMARK.json"), "w") as f:
        json.dump(man, f)
    return name
