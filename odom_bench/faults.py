"""Steps planted in place of the port's, to show that `correct` comes out
false: the control (the reference itself, computed one precision below
the configuration's, put in the program's place) and three faults of the
timed path. Each is a `wrap_step` for `harness.run_cell`."""

from __future__ import annotations

import types

import torch

from .reference.odometry import pack_code

_KEY_MASK = 1023


def _port_tables(dense, fields, mapc):
    """A reference map as the port's tables named in `fields`: keys (B, G)
    wrapped 10-bit voxel keys or -1, npts (B, G), points (B, G, K * 3) (the
    f32 slab) or packed (B, G, Kp) (the packed mirror of each voxel's first
    Kp points, 10 bits an axis)."""
    g = dense.cells
    vox = dense.voxels()
    key = (((vox[:, 0] & _KEY_MASK) << 20) | ((vox[:, 1] & _KEY_MASK) << 10)
           | (vox[:, 2] & _KEY_MASK)).to(torch.int32)
    cnt = dense.cnt[:, :g]
    keys = torch.where(cnt > 0, key[None], torch.full_like(cnt, -1))
    out = types.SimpleNamespace(keys=keys, npts=cnt)
    if "points" in fields:
        out.points = dense.pts[:, :g].reshape(cnt.shape[0], g, dense.k * 3)
    if "packed" in fields:
        kp = mapc["nn_points"] or mapc["max_points_per_voxel"]
        code = pack_code(dense.pts[:, :g, :kp], vox[None, :, None, :],
                         mapc["voxel_size"]).to(torch.int32)
        out.packed = (code[..., 0] << 20) | (code[..., 1] << 10) | code[..., 2]
    return out


def control(pose_dtype=torch.float32):
    """The reference in the program's place, its poses, threshold sums and
    solve in `pose_dtype`, following its own trajectory on the inputs the
    driver gives it."""
    box = {}

    def step(driver):
        if "ref" not in box:
            box["ref"] = driver.reference(driver.s, pose_dtype)
        ref = box["ref"]
        pose, sigma = driver.ref_step(ref, driver.k)
        driver.poses.append(pose.to(torch.float64))
        driver.sigmas.append(sigma.to(torch.float64))
        driver.states = types.SimpleNamespace(map=_port_tables(
            ref.map, driver.MAP_FIELDS, driver.cell.config["pipeline"]["map"]))
        driver.k += 1

    return step


def _functional_step(driver):
    return driver.streams.batched_register_frame(driver.states, driver.batch(driver.k),
                                                 driver.cfg)


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
