"""Seeded inputs for the pose kernels K2 (`pose_pre`) and K3 (`pose_post`),
one case for each of their branches, and the comparison they are held to.
The card tests (tests/test_torch_cuda_kernels.py) and chip_smoke.py run
every case through the kernels and through the plain versions.

A case is a pose state (pose, pose_prev, first_pose, the threshold
accumulators, num_poses), K2's options and an ICP correction for K3:

* np0, np1, np2, np5: num_poses 0, 1, 2 and 5 (no guess, no prediction,
  no deskew twist, all live);
* deskew_off: the twist zeroed by the option;
* sn_zero: exactly identity rotations in pose and pose_prev, so the
  relative rotation's sine is exactly 0 (the twist gated off);
* sn_tiny: a 1e-8 rad relative rotation (the small-angle series);
* not_moved: the first pose 1 cm from the pose (sigma the initial
  threshold, nothing accumulated);
* not_accepted: an identity model deviation (model error 0, not
  accumulated);
* no_samples: as not_accepted with no samples yet (sigma the initial
  threshold although moved);
* diverged, diverged_first: a 30 m correction, past the 10 m divergence
  gate, at 5 poses and at the first scan.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import lie

F64 = torch.float64
KW = dict(min_motion_th=0.1, initial_threshold=2.0, max_range=30.0)
MAX_MODEL_DEVIATION = 10.0
CASES = ("np0", "np1", "np2", "np5", "deskew_off", "sn_zero", "sn_tiny", "not_moved",
         "not_accepted", "no_samples", "diverged", "diverged_first")


def _pose(rng, scale_t: float, scale_r: float) -> torch.Tensor:
    xi = np.concatenate([rng.normal(size=3) * scale_t, rng.normal(size=3) * scale_r])
    return lie.se3_exp(torch.from_numpy(xi))


def case(name: str, device="cpu"):
    """(K2's tensor arguments, K2's keyword options, K3's correction (12,)
    f64 [R 9 | t 3]) of case `name`, on `device`."""
    rng = np.random.default_rng(CASES.index(name))
    prev = _pose(rng, 300.0, 0.5)
    pose = prev @ _pose(rng, 0.5, 0.02)
    first = _pose(rng, 300.0, 0.5)
    md = _pose(rng, 0.05, 0.01)
    corr = _pose(rng, 0.05, 0.001)
    sse, num_poses, thr_n, deskew = 1.234, 5, 7, True
    if name in ("np0", "np1", "np2"):
        num_poses = int(name[2:])
    elif name == "deskew_off":
        deskew = False
    elif name in ("sn_zero", "sn_tiny"):
        prev[:3, :3] = torch.eye(3, dtype=F64)
        rot = torch.eye(3, dtype=F64)
        if name == "sn_tiny":
            rot = lie.se3_exp(torch.tensor([0.0, 0.0, 0.0, 6e-9, -3e-9, 7e-9], dtype=F64))[:3, :3]
        pose = prev.clone()
        pose[:3, :3] = rot
        pose[:3, 3] += torch.tensor([0.5, -0.2, 0.1], dtype=F64)
    elif name == "not_moved":
        first = pose.clone()
        first[:3, 3] += 0.01
    elif name in ("not_accepted", "no_samples"):
        md = torch.eye(4, dtype=F64)
        if name == "no_samples":
            sse, thr_n = 0.0, 0
    elif name.startswith("diverged"):
        corr[:3, 3] += 30.0
        num_poses = 0 if name == "diverged_first" else num_poses
    pre_args = tuple(t.to(device) for t in (
        pose, prev, first, torch.tensor(sse, dtype=F64), md,
        torch.tensor(num_poses, dtype=torch.int32), torch.tensor(thr_n, dtype=torch.int32)))
    corr12 = torch.cat([corr[:3, :3].reshape(9), corr[:3, 3]]).to(device)
    return pre_args, dict(KW, deskew_on=deskew), corr12


def post_args(pre_args, corr, row):
    """K3's tensor arguments for a case: its correction, the K2 row as the
    guess, and the state's pose, first_pose and num_poses."""
    return corr, row, pre_args[0], pre_args[2], pre_args[5]


def max_err(out, ref) -> float:
    """Largest |a - b| over the f64 outputs of two K2 or K3 results; raises
    AssertionError when an i32 output differs."""
    err = 0.0
    for name, a, b in zip(out._fields, out, ref):
        if a.dtype == F64:
            err = max(err, float((a - b).abs().max()))
        elif a.dtype == torch.int32 and not torch.equal(a, b):
            raise AssertionError(f"{name}: {a.tolist()} != {b.tolist()}")
    return err


def delta_is_own_rounding(post) -> bool:
    """K3's f32 map delta equals its own f64 delta (row [13:25]) rounded
    to f32, bit for bit."""
    return (torch.equal(post.delta_R, post.row[13:22].reshape(3, 3).to(torch.float32))
            and torch.equal(post.delta_t, post.row[22:25].to(torch.float32)))
