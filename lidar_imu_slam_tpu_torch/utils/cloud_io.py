"""Point-cloud file output (counterpart of the JAX package's
`utils/cloud_io.py`: the same bytes for the same points).

The reference publishes per-scan deskewed/keypoint clouds and (advertises
but never publishes) the local map over ROS topics
(reference src/odom_run.cpp:187-238, :9). File-based equivalent: ASCII PLY
(readable by CloudCompare/MeshLab/Open3D) per scan plus the full map export.
"""

from __future__ import annotations

import os

import numpy as np
import torch


def write_ply(path: str, points: np.ndarray) -> None:
    """ASCII PLY of an (N, 3) float array."""
    pts = np.asarray(points, np.float32)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write(
            "ply\nformat ascii 1.0\n"
            f"element vertex {len(pts)}\n"
            "property float x\nproperty float y\nproperty float z\n"
            "end_header\n"
        )
        np.savetxt(f, pts, fmt="%.4f")


def read_ply(path: str) -> np.ndarray:
    """Minimal reader for the PLYs written above (tests/round-trips)."""
    with open(path) as f:
        n = 0
        for line in f:
            if line.startswith("element vertex"):
                n = int(line.split()[-1])
            if line.strip() == "end_header":
                break
        return np.loadtxt(f, dtype=np.float32, max_rows=n).reshape(n, 3)


def export_map_ply(path: str, state_map, map_cfg) -> None:
    """Write the live voxel-map cloud (reference voxel_hash_map.cpp:173-198
    pointcloud(), which ROS-side was advertised as `local_map` but never
    published — odom_run.cpp:9)."""
    from ..ops import voxel_map

    write_ply(path, masked_points(*voxel_map.export_points(state_map, map_cfg)))


def masked_points(points: torch.Tensor, mask: torch.Tensor) -> np.ndarray:
    """The (N, 3) rows of `points` where `mask` holds, as a host array:
    points and mask come to the host in one copy (no device-side count)."""
    host = torch.cat([points.to(torch.float32), mask[:, None].to(torch.float32)],
                     dim=1).cpu().numpy()
    return host[host[:, 3] > 0, :3]
