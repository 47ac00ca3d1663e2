"""Steps planted in place of the port's, to show that `correct` comes out
false: the control (the reference itself, computed one precision below
the configuration's, put in the program's place) and three faults of the
timed path. Each is a `wrap_step` for `harness.run_cell`."""

from __future__ import annotations

import types

import torch

from .reference.odometry import RefOdometry

_KEY_MASK = 1023


def _port_tables(dense, k: int):
    """A reference map as the port's tables: (keys (B, G) wrapped 10-bit
    voxel keys or -1, points (B, G, K * 3), npts (B, G))."""
    g = dense.cells
    vox = dense.voxels()
    key = (((vox[:, 0] & _KEY_MASK) << 20) | ((vox[:, 1] & _KEY_MASK) << 10)
           | (vox[:, 2] & _KEY_MASK)).to(torch.int32)
    cnt = dense.cnt[:, :g]
    keys = torch.where(cnt > 0, key[None], torch.full_like(cnt, -1))
    return types.SimpleNamespace(keys=keys, points=dense.pts[:, :g].reshape(cnt.shape[0], g, k * 3),
                                 npts=cnt)


def control(pose_dtype=torch.float32):
    """The reference in the program's place, its poses, threshold sums and
    solve in `pose_dtype`, following its own trajectory."""
    box = {}

    def step(driver):
        if "ref" not in box:
            cfg = driver.cell.config
            box["ref"] = RefOdometry(cfg["pipeline"], driver.s, cfg["reference_grid"],
                                     driver.device, pose_dtype=pose_dtype)
        ref = box["ref"]
        raw = driver.raw(driver.k)
        pose, sigma = ref.step(raw.xyz, raw.time, raw.ring, raw.mask, raw.stamp)
        driver.poses.append(pose.to(torch.float64))
        driver.sigmas.append(sigma.to(torch.float64))
        driver.states = types.SimpleNamespace(map=_port_tables(ref.map, ref.map.k))
        driver.k += 1

    return step


def _functional_step(driver):
    from lidar_imu_slam_tpu_torch.ops.preprocess import preprocess_scan

    scans = preprocess_scan(driver.raw(driver.k), driver.cfg.lidar)
    return driver.streams.batched_register_frame(driver.states, scans, driver.cfg)


def _select(keep_new, new, old):
    """Per stream: the leaves of `new` where keep_new (S,), else `old`."""
    def pick(a, b):
        if isinstance(a, tuple):
            return type(a)(*(pick(x, y) for x, y in zip(a, b)))
        return torch.where(keep_new.reshape((-1,) + (1,) * (a.dim() - 1)), a, b)
    return pick(new, old)


def state_unchanged(driver):
    """The step computes, then returns the state it was given."""
    _, out = _functional_step(driver)
    driver.poses.append(driver.states.pose)
    driver.sigmas.append(out.sigma)
    driver.k += 1


def half_batch(driver):
    """Only the first half of the streams is stepped; the rest keep their
    state."""
    new, out = _functional_step(driver)
    keep = torch.arange(driver.s, device=driver.device) < driver.s // 2
    driver.states = _select(keep, new, driver.states)
    driver.poses.append(driver.states.pose)
    driver.sigmas.append(torch.where(keep, out.sigma, driver.sigmas[-1] if driver.sigmas
                                     else out.sigma))
    driver.k += 1


def altered_pose(at_step: int, metres: float = 0.1):
    """The step's pose of every stream moved by `metres` along x at step
    `at_step`, in the output and in the state it carries on."""
    def step(driver):
        k = driver.k
        driver.step()
        if k == at_step:
            pose = driver.poses[-1].clone()
            pose[:, 0, 3] += metres
            driver.poses[-1] = pose
            driver.states = driver.states._replace(pose=pose)

    return step
