"""lidar_imu_slam_tpu_torch — the PyTorch / CUDA port of the JAX package.

Same module layout and function names as the JAX package beside it
(the same name without `_torch`), which stays the reference. Plain tensor code is
PyTorch; every Pallas kernel on the ported path is a hand-written CUDA C++
kernel for Hopper (`csrc/*.cu`, built by `ops/kernels/_build.py` at first
use) with a plain PyTorch version beside it.

Precision policy: per-point geometry f32; poses, the ICP carry, threshold
accumulators and the 6x6 solve native f64. TF32 is switched off at import:
reduced-precision matmul quantizes point coordinates (the JAX package
records the same fault for bf16 matmul on a TPU).

This package imports torch and numpy only — never jax.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

__version__ = "0.1.0"

from . import config  # noqa: E402

__all__ = ["config", "__version__"]
