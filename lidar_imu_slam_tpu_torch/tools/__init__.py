"""Command-line tools of the port (`python -m lidar_imu_slam_tpu_torch.tools.<name>`)."""
