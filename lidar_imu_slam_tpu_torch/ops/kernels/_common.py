"""What every kernel wrapper shares: the launch counters, the CPU-or-CUDA
dispatch rule, the argument checks and the launch path.

Dispatch rule: a wrapper runs its kernel's plain PyTorch version only when
every tensor it was given lies on the CPU. Otherwise it loads the kernel
library (building it on first use) and launches the kernel on CUDA tensors,
or raises — there is no fallback.

Launch path: `bind` binds a C entry of the library (its ctypes argtypes)
once. The lean path (`lean_entry`, every wrapper but K1 / K4 / K5's)
checks with a few direct attribute comparisons (`expect` of a fixed
shape) and reads the current stream's raw handle without building a
`torch.cuda.Stream`, so the host spends on a call little more than the
ctypes call and its outputs' `new_empty`.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

# launches per kernel; incremented by each wrapper right where it launches
LAUNCHES: dict[str, int] = {"fused_gn_carry": 0, "pose_pre": 0, "pose_post": 0,
                            "fused_gn": 0, "fused_gn_batched": 0, "nn_bruteforce": 0,
                            "take_rows": 0, "take_lanes": 0, "gn_proto": 0,
                            "gn_spread": 0,  # K1 / K4 launches over several clusters
                            "candidate_fetch": 0, "imu_deskew": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def on_cpu(*tensors: torch.Tensor) -> bool:
    """True when all tensors lie on the CPU; False when none does; raises
    on a mix."""
    cpu = tensors[0].is_cpu
    for t in tensors[1:]:
        if t.is_cpu is not cpu:
            raise ValueError(
                f"tensors on mixed devices: {sorted({t.device.type for t in tensors})}")
    return cpu


def expect(name: str, t: torch.Tensor, dtype: torch.dtype, shape=None,
           min_numel: int | None = None) -> None:
    """Raise unless `t` has the dtype, shape (None entries: any) and
    contiguity the kernel takes. A shape with no None entry is one direct
    comparison."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if shape is not None:
        if None in shape:
            ok = t.dim() == len(shape) and all(
                s is None or s == d for s, d in zip(shape, t.shape))
        else:
            ok = t.shape == shape
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


def bind(cache: dict, name: str, argtypes: list):
    """The library's C entry `name` with its argtypes, loaded (the library
    built on first use) and bound once, then served from `cache`."""
    fn = cache.get(name)
    if fn is None:
        fn = getattr(_build.load(), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        cache[name] = fn
    return fn


def lean_entry(cache: dict, name: str, argtypes: list, *tensors: torch.Tensor):
    """The lean launch path: (the bound entry, the raw handle of the current
    stream of the first tensor's device). Loads the library before it
    looks at the devices (a CPU-only torch has no raw-stream call) and
    raises unless all tensors lie on one CUDA device."""
    fn = bind(cache, name, argtypes)
    dev = tensors[0].get_device()
    for t in tensors:
        if not t.is_cuda or t.get_device() != dev:
            raise ValueError("kernel needs all tensors on one CUDA device, got "
                             f"{[str(t.device) for t in tensors]}")
    return fn, torch._C._cuda_getCurrentRawStream(dev)
