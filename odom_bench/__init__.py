"""odom_bench: the benchmark of the PyTorch / CUDA port
(`lidar_imu_slam_tpu_torch`). `python3 odom_bench/run.py --workload <cell>
--seed <n> --seconds <s> --trace <0|1>` runs one cell of BENCHMARK.json."""
