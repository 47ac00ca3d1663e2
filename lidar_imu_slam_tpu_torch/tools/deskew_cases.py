"""Seeded inputs for the per-point pass of the IMU deskew
(`models/ekf.deskew_points`): the cases on which the IMU deskew kernel
(`csrc/imu_deskew.cu`) must write the plain version's points bit for bit.
The card tests (tests/test_torch_cuda_kernels.py) and chip_smoke.py run
every case through both; the CPU tests (tests/test_torch_imu_deskew.py)
hold the cases' coverage with the plain version.

`case(name, device, small=False)` returns the pass's arguments (points,
rel_t, pts_mask, offsets, table, t_il, pos_lidar_end, rot_end). The
per-stream terms come from the port's own trail (`ekf.imu_trail`, the
batched product chain, a 20-pose trail) over a filter state and a packet
of the LIO ensemble's drive (vlp16_lio_mc): 2 m/s on a circle at 0.2094
rad/s, a 500 Hz IMU, 50 samples a 0.1 s scan plus the previous packet's
last in a 65-sample packet, the 3DM-GX5-25's per-sample noise (gyro
0.00195 rad/s, accelerometer 0.0055 m/s^2), a lidar-imu offset of ~0.2 m.
Each stream's VLP-16 points lie 1-40 m out within +-15 degrees of
elevation, stamped by azimuth over the scan, 5% of them masked padding.

* drive: 64 streams of 16,384 points, the cell's drive as above;
* lead_none: one stream without a stream axis;
* masked: a third of the points masked out, their coordinates and times
  NaN (copied through as they are);
* ties: half the points stamped exactly on a trail offset (searchsorted's
  ties, side "left");
* past_last: the packet ends 40 ms before the scan, so the later points lie
  past the last valid offset, before the +inf padding;
* few_samples: a packet of three valid samples (two pairs);
* small_angle: a gyro of ~1e-3 rad/s, so |w dt|^2 falls on both sides of
  the small-angle branch's 1e-12;
* lio_slice: the single-stream LIO step's shape (chip_smoke.py's LIO
  slice): no stream axis, 131,072 points, a 100 Hz packet of 16 samples
  (10 valid) after the carried one, so a 17-entry trail.
`small` cuts every case to at most 3 streams of 1,000 points (CPU tests).
`deployment(device)` is the LIO ensemble's full shape for chip_smoke.py's
timings: the drive case's 64 streams, each repeated 64 times (4096 streams
of 16,384 points).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import config as cfgmod
from ..models import ekf

CASES = ("drive", "lead_none", "masked", "ties", "past_last", "few_samples", "small_angle",
         "lio_slice")

RATE = 0.2094  # rad/s: the circuit's yaw rate
SPEED = 2.0  # m/s
IMU_HZ = 500.0
SCAN_S = 0.1
CAP = 64  # samples a packet, the previous packet's last sample prepended
GYRO_SIGMA, ACC_SIGMA = 0.00195, 0.0055
F32, F64 = torch.float32, torch.float64


def _shape(name: str):
    """(streams or None, points a stream, valid samples in the packet after
    the prepended one, gyro rate, IMU rate, samples a packet)."""
    streams, n, samples, rate, hz, cap = 8, 4096, int(round(IMU_HZ * SCAN_S)), RATE, IMU_HZ, CAP
    if name == "drive":
        streams, n = 64, 16384
    elif name == "lead_none":
        streams, n = None, 16384
    elif name == "past_last":
        samples = int(round(IMU_HZ * (SCAN_S - 0.04)))
    elif name == "few_samples":
        samples = 2
    elif name == "small_angle":
        rate = 1e-3
    elif name == "lio_slice":
        streams, n, hz, cap = None, 131072, 100.0, 16
        samples = int(round(hz * SCAN_S))
    return streams, n, samples, rate, hz, cap


def _state(rng, s, t0):
    cfg = cfgmod.EkfConfig()
    st = ekf.init(cfg, "cpu", streams=s)
    m = st.m.numpy().copy()
    yaw = rng.uniform(-math.pi, math.pi, s)
    m[:, ekf.POS:ekf.POS + 3] = rng.normal(0.0, 10.0, (s, 3))
    m[:, ekf.VEL:ekf.VEL + 3] = np.stack(
        [SPEED * np.cos(yaw), SPEED * np.sin(yaw), np.zeros(s)], -1)
    # the filter quaternion is world->body (w, x, y, z), a yaw and a tilt
    half = -0.5 * yaw
    q = np.stack([np.cos(half), rng.normal(0, 0.01, s), rng.normal(0, 0.01, s), np.sin(half)], -1)
    m[:, ekf.ORI:ekf.ORI + 4] = q / np.linalg.norm(q, axis=-1, keepdims=True)
    m[:, ekf.BGA:ekf.BGA + 3] = rng.normal(0, 1e-4, (s, 3))
    m[:, ekf.BAA:ekf.BAA + 3] = rng.normal(0, 1e-3, (s, 3))
    m[:, ekf.PIL:ekf.PIL + 3] = rng.normal(0, 0.2, (s, 3))
    t = torch.full((s,), t0, dtype=F64)
    return st._replace(m=torch.from_numpy(m), last_lidar_end_time=t), cfg


def _packet(rng, s, samples, rate, t0, hz=IMU_HZ, cap=CAP):
    """(S, cap + 1) packets: the previous packet's last sample at the scan
    begin, then `samples` at `hz`."""
    k = np.arange(cap + 1)
    time = np.broadcast_to(t0 + k / hz, (s, cap + 1)).copy()
    mask = np.broadcast_to(k <= samples, (s, cap + 1)).copy()
    gyro = np.zeros((s, cap + 1, 3))
    gyro[..., 2] = rate
    acc = np.zeros((s, cap + 1, 3))
    acc[..., 1] = SPEED * RATE
    acc[..., 2] = cfgmod.GRAVITY
    gyro += rng.normal(0, GYRO_SIGMA if rate == RATE else 0.0, gyro.shape)
    acc += rng.normal(0, ACC_SIGMA, acc.shape)
    gyro[~mask], acc[~mask], time[~mask] = 0.0, 0.0, 0.0
    return ekf.ImuPacket(*(torch.from_numpy(x) for x in (time, gyro, acc, mask)))


def _points(rng, s, n):
    rng_m = rng.uniform(1.0, 40.0, (s, n))
    az = rng.uniform(0.0, 2 * math.pi, (s, n))
    el = np.deg2rad(rng.uniform(-15.0, 15.0, (s, n)))
    xyz = np.stack([rng_m * np.cos(el) * np.cos(az), rng_m * np.cos(el) * np.sin(az),
                    rng_m * np.sin(el)], -1).astype(np.float32)
    rel = az / (2 * math.pi) * SCAN_S
    mask = rng.uniform(size=(s, n)) >= 0.05
    xyz[~mask], rel[~mask] = 0.0, 0.0
    return torch.from_numpy(xyz), torch.from_numpy(rel), torch.from_numpy(mask)


def case(name: str, device, small: bool = False):
    """The pass's arguments for case `name` on `device` (see the module)."""
    if name not in CASES:
        raise ValueError(f"unknown case {name!r}")
    streams, n, samples, rate, hz, cap = _shape(name)
    if small:
        streams, n = (None if streams is None else min(streams, 3)), min(n, 1000)
    s = 1 if streams is None else streams
    rng = np.random.default_rng(CASES.index(name))
    t0 = 12.3
    state, cfg = _state(rng, s, t0)
    packet = _packet(rng, s, samples, rate, t0, hz, cap)
    points, rel, mask = _points(rng, s, n)
    mean_acc_norm = torch.full((s,), math.hypot(SPEED * RATE, cfgmod.GRAVITY), dtype=F64)
    beg = torch.full((s,), t0, dtype=F64)
    if name == "masked":
        mask = torch.from_numpy(rng.uniform(size=(s, n)) >= 1 / 3)
        points[~mask], rel[~mask] = float("nan"), float("nan")
    elif name == "ties":  # the offsets do not depend on the points' times
        offsets = ekf.imu_trail(state, packet, rel, mask, mean_acc_norm, beg, cfg)[2][0]
        finite = offsets[0, torch.isfinite(offsets[0])]
        pick = torch.from_numpy(rng.integers(0, finite.numel(), (s, n)))
        tie = torch.from_numpy(rng.uniform(size=(s, n)) < 0.5)
        rel = torch.where(tie, finite[pick].to(F64), rel)
    terms = ekf.imu_trail(state, packet, rel, mask, mean_acc_norm, beg, cfg)[2]
    args = (points, rel, mask) + terms
    if streams is None:
        args = tuple(t[0] for t in args)
    return tuple(t.to(device).contiguous() for t in args)


def deployment(device):
    """The LIO ensemble's shape: the drive case's 64 streams repeated 64
    times, 4096 streams of 16,384 points, built on `device`."""
    return tuple(t.repeat((64,) + (1,) * (t.dim() - 1)) for t in case("drive", device))


def coverage(points, rel_t, pts_mask, offsets, table, t_il, pos_lidar_end, rot_end) -> dict:
    """What a case's unmasked points exercise: ties on an offset, points
    past the last finite offset, and each side of the small-angle branch
    (the plain version's own interval search and rounding)."""
    rel32 = rel_t.to(F32)
    k = torch.clamp(torch.searchsorted(offsets, rel32, side="left") - 1, 0,
                    offsets.shape[-1] - 1)
    off0 = torch.where(torch.isfinite(offsets), offsets, 0.0)
    at_k = torch.gather(off0, -1, k)
    dtp = rel32 - at_k
    g = torch.gather(table[..., 9:12], -2, k[..., None].expand(k.shape + (3,)))
    w = g * dtp[..., None]
    sq = w[..., 0] * w[..., 0] + w[..., 1] * w[..., 1] + w[..., 2] * w[..., 2]
    last = torch.amax(off0, -1, keepdim=True)
    on = pts_mask
    tie = (rel32[..., None] == offsets[..., None, :]).any(-1) & (rel32 > 0)
    return dict(masked=int((~on).sum()), ties=int((tie & on).sum()),
                past_last=int(((rel32 > last) & on).sum()),
                small=int(((sq < 1e-12) & on).sum()), large=int(((sq >= 1e-12) & on).sum()))
