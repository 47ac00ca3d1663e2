"""Steps planted in place of the LIO ensemble driver's
(`drivers/lio_ensemble.py`), to show that `correct` comes out false: the
control (the reference in the program's place, its filter one precision
below the configuration's, on its own trajectory) and four faults of the
timed path: one IMU sample dropped, the IMU deskew replaced by the
constant-velocity deskew, one stream's filter state moved, and half the
batch left out. Each is a `wrap_step` for `harness.run_cell`."""

from __future__ import annotations

import types

import torch

from . import faults, harness


def control(filter_dtype=torch.float32):
    """The reference in the program's place, its filter in `filter_dtype`,
    following its own guesses and poses on the inputs the driver makes."""
    box = {}

    def step(driver):
        if "ref" not in box:
            box["ref"] = driver.reference(driver.s, filter_dtype)
            driver.lio = None
        ref = box["ref"]
        inputs = driver.ref_inputs(driver.k, torch.arange(driver.s, device=driver.device))
        own, sigma, desk, _ = ref.step(*inputs)
        pts, tau, rel, mask, tb, te, t, g, a, pm = inputs
        scans = types.SimpleNamespace(xyz=pts, tau=tau, rel_t=rel, mask=mask, t_begin=tb,
                                      t_end=te)
        packets = types.SimpleNamespace(time=t, gyro=g, acc=a, mask=pm)
        out = types.SimpleNamespace(pose=ref.odo.pose.clone(), sigma=sigma.to(torch.float64),
                                    guess=ref.guess, scan_deskewed=desk,
                                    streams_initialized=ref.done.sum(),
                                    streams_imu=ref.done.sum())
        ekf = types.SimpleNamespace(m=ref.m.clone(), P=ref.P)
        tables = faults._port_tables(ref.odo.map, driver.MAP_FIELDS,
                                     driver.cell.config["pipeline"]["map"])
        driver.record(scans, packets, out, ekf, tables)

    return step


def imu_sample_dropped(at_step: int, sample: int = 10):
    """At step `at_step` the port's step loses one valid IMU sample of every
    stream's packet (the driver's packets are as they were)."""
    def step(driver):
        def run(lio, scans, packets):
            if driver.k == at_step:
                mask = packets.mask.clone()
                mask[:, sample] = False
                packets = packets._replace(mask=mask)
            return driver.streams.batched_lio_step(lio, scans, packets, driver.cfg,
                                                   init_samples=driver.seen)

        driver.step(run)

    return step


def cv_deskew(driver):
    """Every step deskews the scan at constant velocity (the odometry's
    last two poses) in place of the IMU trail."""
    from lidar_imu_slam_tpu_torch.models import ekf
    from lidar_imu_slam_tpu_torch.ops import deskew

    def run(lio, scans, packets):
        odo = lio.odo
        cv = deskew.constant_velocity_deskew_fast(scans.xyz, scans.tau, odo.pose_prev, odo.pose)
        cv = torch.where((odo.num_poses > 2)[:, None, None], cv, scans.xyz)
        imu = ekf.motion_compensation_with_imu

        def cv_instead(*args, **kwargs):
            state, _, diag = imu(*args, **kwargs)
            return state, cv, diag

        ekf.motion_compensation_with_imu = cv_instead
        try:
            return driver.streams.batched_lio_step(lio, scans, packets, driver.cfg,
                                                   init_samples=driver.seen)
        finally:
            ekf.motion_compensation_with_imu = imu

    driver.step(run)


def filter_moved(at_step: int, metres: float = 0.1):
    """After step `at_step` the filter position of the first compared stream
    moves by `metres` along x, in the state it carries on."""
    def step(driver):
        k = driver.k
        driver.step()
        if k == at_step:
            j = int(harness.compared_streams(driver, driver.cell.mix, driver.seed)[0])
            m = driver.lio.ekf.m.clone()
            m[j, 0] += metres
            driver.lio = driver.lio._replace(ekf=driver.lio.ekf._replace(m=m))
            driver.means[-1] = m[:, :driver.means[-1].shape[1]].contiguous()
            driver.ekf_end = driver.lio.ekf

    return step


def half_batch(driver):
    """Only the first half of the streams is stepped; the rest keep their
    state."""
    from lidar_imu_slam_tpu_torch.models import lio as lio_mod

    def run(lio, scans, packets):
        ready = driver.seen >= driver.cfg.imu.max_init_count
        new, out = lio_mod.step_streams(lio, scans, packets, driver.cfg, imu_ready=ready)
        keep = torch.arange(driver.s, device=driver.device) < driver.s // 2
        kept = faults._select(keep, new, lio)
        prev = driver.sigmas[-1] if driver.sigmas else out.sigma
        return kept, out._replace(pose=kept.odo.pose, sigma=torch.where(keep, out.sigma, prev))

    driver.step(run)
