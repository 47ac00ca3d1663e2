"""No module of odom_bench loads JAX or the JAX package, compared by
whole top-level names (the port's name begins with the JAX package's);
the reference alone loads nothing of the port either."""

import os
import subprocess
import sys

import pytest

from odom_bench.common import manifest

ROOT = os.path.dirname(manifest.BENCH_DIR)


def _modules():
    out = []
    for dirpath, _, files in os.walk(manifest.BENCH_DIR):
        rel = os.path.relpath(dirpath, ROOT).replace(os.sep, ".")
        for f in sorted(files):
            if f.endswith(".py") and f != "__init__.py":
                out.append(f"{rel}.{f[:-3]}")
    return out


def _loaded(module: str) -> set:
    code = (f"import sys; sys.path.insert(0, {ROOT!r}); import {module}; "
            "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, timeout=120, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    return set(proc.stdout.split())


@pytest.mark.parametrize("module", [m for m in _modules() if ".tests." not in m])
def test_no_jax(module):
    loaded = _loaded(module)
    assert not loaded & {"jax", "jaxlib", "flax", "lidar_imu_slam_tpu"}, module


def test_reference_loads_nothing_of_the_port():
    loaded = _loaded("odom_bench.reference.odometry")
    assert not loaded & {"jax", "jaxlib", "lidar_imu_slam_tpu", "lidar_imu_slam_tpu_torch"}
