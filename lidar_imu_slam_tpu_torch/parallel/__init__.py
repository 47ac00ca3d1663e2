import importlib

from . import mesh, sharded_map, streams

__all__ = ["dryrun", "mesh", "sharded_map", "streams"]


def __getattr__(name):
    # imported on first use, so `python -m lidar_imu_slam_tpu_torch.parallel.dryrun`
    # does not find the module imported already
    if name == "dryrun":
        return importlib.import_module(".dryrun", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
