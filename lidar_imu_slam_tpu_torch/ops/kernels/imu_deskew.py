"""The IMU deskew kernel (`csrc/imu_deskew.cu`): each point's interval
search, exp(w dt), trail pose and scan-end transform in one read and one
write of the point.

It replaces no Pallas kernel: the JAX package's per-point undistortion is
plain `jnp` (`models/ekf.py:motion_compensation_with_imu`). Its plain
PyTorch version is `models/ekf.deskew_points_plain`, and
`models/ekf.deskew_points` holds the dispatch rule: the plain version when
every tensor lies on the CPU, else this wrapper, which launches the kernel
or raises. The kernel is bound by bytes (the points, their f64 times and
mask read once, the points written once). The wrapper takes `_common`'s
lean launch path.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from ._common import LAUNCHES, expect, lean_entry

F32 = torch.float32
F64 = torch.float64
COLS = 21  # a trail entry: R row-major (9), gyro, position, velocity, acceleration (3 each)

_vp, _i = ctypes.c_void_p, ctypes.c_int
_ARGS = [_vp] * 8 + [_i, _i, _i, _vp, _vp]

_fns: dict[str, object] = {}  # bound C entries (`_common.bind`)


def imu_deskew(points: torch.Tensor, rel_t: torch.Tensor, pts_mask: torch.Tensor,
               offsets: torch.Tensor, table: torch.Tensor, t_il: torch.Tensor,
               pos_lidar_end: torch.Tensor, rot_end: torch.Tensor) -> torch.Tensor:
    """The deskewed points lead + (N, 3) f32 (`models/ekf.deskew_points`).

    points lead + (N, 3) f32, rel_t lead + (N,) f64, pts_mask lead + (N,)
    bool; offsets lead + (M,) f32, table lead + (M, 21) f32, t_il and
    pos_lidar_end lead + (3,) f32, rot_end lead + (3, 3) f32; lead is () or
    (S,). Contiguous CUDA tensors on one device only."""
    lead = points.shape[:-2]
    n = points.shape[-2]
    m = offsets.shape[-1]
    expect("points", points, F32, (*lead, n, 3))
    expect("rel_t", rel_t, F64, (*lead, n))
    expect("pts_mask", pts_mask, torch.bool, (*lead, n))
    expect("offsets", offsets, F32, (*lead, m))
    expect("table", table, F32, (*lead, m, COLS))
    expect("t_il", t_il, F32, (*lead, 3))
    expect("pos_lidar_end", pos_lidar_end, F32, (*lead, 3))
    expect("rot_end", rot_end, F32, (*lead, 3, 3))
    fn, stream = lean_entry(_fns, "lis_imu_deskew", _ARGS, points, rel_t, pts_mask, offsets,
                            table, t_il, pos_lidar_end, rot_end)
    out = points.new_empty(points.shape)
    status = fn(points.data_ptr(), rel_t.data_ptr(), pts_mask.data_ptr(), offsets.data_ptr(),
                table.data_ptr(), t_il.data_ptr(), pos_lidar_end.data_ptr(), rot_end.data_ptr(),
                math.prod(lead), n, m, out.data_ptr(), stream)
    _build.check(status, "imu_deskew")
    LAUNCHES["imu_deskew"] += 1
    return out
