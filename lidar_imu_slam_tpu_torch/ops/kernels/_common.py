"""What every kernel wrapper shares: the launch counters, the CPU-or-CUDA
dispatch rule and the argument checks.

Dispatch rule: a wrapper runs its kernel's plain PyTorch version only when
every tensor it was given lies on the CPU. Otherwise it loads the kernel
library (building it on first use) and launches the kernel on CUDA tensors,
or raises — there is no fallback.
"""

from __future__ import annotations

import torch

# launches per kernel; incremented by each wrapper right where it launches
LAUNCHES: dict[str, int] = {"fused_gn_carry": 0, "pose_pre": 0, "pose_post": 0,
                            "fused_gn": 0, "fused_gn_batched": 0, "nn_bruteforce": 0,
                            "take_rows": 0, "take_lanes": 0, "gn_proto": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def on_cpu(*tensors: torch.Tensor) -> bool:
    """True when all tensors lie on the CPU; False when none does; raises
    on a mix."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return True
    if "cpu" in kinds:
        raise ValueError(f"tensors on mixed devices: {sorted(kinds)}")
    return False


def expect(name: str, t: torch.Tensor, dtype: torch.dtype, shape=None,
           min_numel: int | None = None) -> None:
    """Raise unless `t` has the dtype, shape (None entries: any) and
    contiguity the kernel takes."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if shape is not None:
        ok = t.dim() == len(shape) and all(
            s is None or s == d for s, d in zip(shape, t.shape))
        if not ok:
            raise ValueError(f"{name}: expected shape {shape}, got {tuple(t.shape)}")
    if min_numel is not None and (t.dim() != 1 or t.numel() < min_numel):
        raise ValueError(f"{name}: expected a 1-D tensor of >= {min_numel} elements")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def expect_cuda(*tensors: torch.Tensor) -> None:
    devs = {t.device for t in tensors}
    if len(devs) != 1 or next(iter(devs)).type != "cuda":
        raise ValueError(f"kernel needs all tensors on one CUDA device, got {devs}")


def stream_handle(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
