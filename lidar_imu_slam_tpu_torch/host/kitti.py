"""KITTI odometry dataset reader (BASELINE.json config 2; counterpart of
the JAX package's `host/kitti.py`, numpy only).

Reads velodyne .bin scans, calibration, timestamps and ground-truth poses.
HDL-64E bins carry no per-point time; per-point relative time is
reconstructed from azimuth by the preprocessing rotation model
(ops/preprocess.rotation_model_rel_time), mirroring how the reference's
constant-rotation fallback handles timestamp-less sensors
(reference src/sensors/lidar/frame.cpp:128-133,159-182).
"""

from __future__ import annotations

import os
from typing import Iterator, Optional

import numpy as np


def read_velodyne_bin(path: str) -> np.ndarray:
    """(N, 4) float32: x, y, z, intensity."""
    return np.fromfile(path, dtype=np.float32).reshape(-1, 4)


def estimate_rings(xyz: np.ndarray, num_rings: int = 64) -> np.ndarray:
    """Ring index from elevation angle (KITTI bins carry no ring field)."""
    elev = np.arctan2(xyz[:, 2], np.linalg.norm(xyz[:, :2], axis=1))
    lo, hi = np.percentile(elev, [0.5, 99.5])
    ring = ((elev - lo) / max(hi - lo, 1e-9) * (num_rings - 1)).round()
    return np.clip(ring, 0, num_rings - 1).astype(np.int32)


def read_times(seq_dir: str) -> np.ndarray:
    return np.loadtxt(os.path.join(seq_dir, "times.txt"))


def read_poses(poses_file: str) -> np.ndarray:
    """(N, 4, 4) ground-truth poses from a KITTI poses txt (12 floats/row)."""
    rows = np.loadtxt(poses_file).reshape(-1, 3, 4)
    n = rows.shape[0]
    out = np.tile(np.eye(4), (n, 1, 1))
    out[:, :3, :4] = rows
    return out


def read_calib(seq_dir: str) -> dict:
    calib = {}
    path = os.path.join(seq_dir, "calib.txt")
    if not os.path.exists(path):
        return calib
    with open(path) as f:
        for line in f:
            key, _, vals = line.partition(":")
            try:
                calib[key.strip()] = np.fromstring(vals, sep=" ")
            except ValueError:
                continue
    return calib


def velo_to_cam_poses(poses: np.ndarray, calib: dict) -> np.ndarray:
    """Conjugate velodyne-frame trajectory poses into the camera frame:
    T_cam(t) = Tr @ T_velo(t) @ Tr^-1, with Tr the velo-to-cam calibration.

    KITTI ground-truth poses are camera-frame; the per-frame conjugation is
    NOT a single rigid transform, so Umeyama alignment cannot absorb it —
    estimates must be converted before ATE/RPE (standard KITTI evaluation
    practice).
    """
    poses = np.asarray(poses)
    if "Tr" not in calib or calib["Tr"].size < 12:
        return poses
    Tr = np.eye(4)
    Tr[:3, :4] = calib["Tr"][:12].reshape(3, 4)
    Tr_inv = np.linalg.inv(Tr)
    return np.einsum("ij,njk,kl->nil", Tr, poses, Tr_inv)


class KittiSequence:
    """Iterator over a KITTI odometry sequence directory:
    <seq_dir>/velodyne/*.bin [+ times.txt, calib.txt]."""

    def __init__(self, seq_dir: str, poses_file: Optional[str] = None):
        self.seq_dir = seq_dir
        vdir = os.path.join(seq_dir, "velodyne")
        self.files = sorted(
            os.path.join(vdir, f) for f in os.listdir(vdir) if f.endswith(".bin")
        )
        self.times = (
            read_times(seq_dir)
            if os.path.exists(os.path.join(seq_dir, "times.txt"))
            else np.arange(len(self.files)) * 0.1
        )
        self.gt_poses = read_poses(poses_file) if poses_file else None
        self.calib = read_calib(seq_dir)

    def __len__(self) -> int:
        return len(self.files)

    def __iter__(self) -> Iterator[dict]:
        for i, path in enumerate(self.files):
            pts = read_velodyne_bin(path)
            yield {
                "index": i,
                "stamp": float(self.times[i]),
                "xyz": pts[:, :3],
                "intensity": pts[:, 3],
                "ring": estimate_rings(pts[:, :3]),
            }
