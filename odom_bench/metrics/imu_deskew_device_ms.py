"""imu_deskew_device_ms (ms/step, device trace): device time per step of
the operations launched inside the port's `ekf.deskew` span: the IMU pose
trail of each stream's packet, the scan-end extrapolation and every
point's undistortion to scan end (`models/ekf.motion_compensation_with_imu`)."""

from odom_bench.common import spans

SPANS = ("ekf.deskew",)


def read(ctx):
    return spans.ms_per_step(ctx, "total", SPANS)
