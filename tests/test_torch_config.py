"""The port's configuration dataclasses against the JAX package's: every
class, field, default, property and preset equal."""

import dataclasses

import pytest
import torch

from lidar_imu_slam_tpu import config as jcfg
from lidar_imu_slam_tpu_torch import config as tcfg

torch.set_num_threads(1)

CLASSES = ["LidarConfig", "MapConfig", "IcpConfig", "ImuConfig", "EkfConfig",
           "BackendConfig", "PipelineConfig"]


def _fields(cls):
    out = {}
    for f in dataclasses.fields(cls):
        if f.default is not dataclasses.MISSING:
            out[f.name] = f.default
        else:
            out[f.name] = dataclasses.asdict(f.default_factory())
    return out


@pytest.mark.parametrize("name", CLASSES)
def test_fields_and_defaults_equal(name):
    jc, tc = getattr(jcfg, name), getattr(tcfg, name)
    assert _fields(jc) == _fields(tc)
    assert jc.__dataclass_params__.frozen and tc.__dataclass_params__.frozen


@pytest.mark.parametrize("preset", ["kitti_64beam", "livox_dense", "default"])
def test_presets_equal(preset):
    assert dataclasses.asdict(getattr(jcfg, preset)()) == dataclasses.asdict(
        getattr(tcfg, preset)())


def test_properties_and_replace():
    for kw in [{}, dict(voxel_size=0.5, max_range=30.0), dict(grid_xy=100, grid_z=40),
               dict(nn_points=4, max_range=80.0)]:
        jm, tm = jcfg.MapConfig(**kw), tcfg.MapConfig(**kw)
        assert jm.grid_dims == tm.grid_dims
        assert jm.packed_width == tm.packed_width
    assert jcfg.LidarConfig(min_angle=10.0).angle_limit == tcfg.LidarConfig(
        min_angle=10.0).angle_limit
    assert jcfg.EkfConfig().state_dim == tcfg.EkfConfig().state_dim
    assert jcfg.GRAVITY == tcfg.GRAVITY
    t = tcfg.PipelineConfig().replace(min_scan_count=3)
    j = jcfg.PipelineConfig().replace(min_scan_count=3)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    hash(t)  # frozen and hashable
