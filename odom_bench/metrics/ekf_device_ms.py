"""ekf_device_ms (ms/step, device trace): device time per step of the
operations launched inside the port's LiDAR-inertial filter spans
(nested spans included): `imu.init` (the static initialization's running
statistics, while any stream initializes), `ekf.predict` (the packet's
predict and the hold to scan end) and `ekf.update` (the pose update, ZUPT
and the trail augmentation, and the seed from the odometry on the scan
that completes the initialization)."""

from odom_bench.common import spans

SPANS = ("imu.init", "ekf.predict", "ekf.update")


def read(ctx):
    return spans.ms_per_step(ctx, "total", SPANS)
