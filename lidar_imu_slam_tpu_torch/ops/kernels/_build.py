"""Build and load the port's CUDA kernels (`lidar_imu_slam_tpu_torch/csrc`).

At the first call of a kernel wrapper on CUDA tensors, every `csrc/*.cu`
is compiled by nvcc into ONE shared library with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o build/libkernels_<hash>.so csrc/*.cu

(no --use_fast_math: the kernels rely on +inf candidates and exact sqrt /
sin / cos) and loaded with ctypes. The library name carries a sha256 of
every source, so an edited source is never served stale. The build goes
into `lidar_imu_slam_tpu_torch/build/` (git-ignored); nvcc's output,
including ptxas' register / spill report, is kept beside it as
`nvcc_<hash>.log`.

There is no fallback: when nvcc is missing or fails, `load()` raises with
the compiler's stderr, and the wrappers raise with it.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "build")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_seconds: float | None = None  # wall time of the last nvcc run (None: cached)


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused the sources."""


def sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu"))
                  + glob.glob(os.path.join(CSRC_DIR, "*.cuh")))


def source_hash() -> str:
    h = hashlib.sha256()
    for path in sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        cand = os.path.join(cuda_home, "bin", "nvcc")
        nvcc = cand if os.path.exists(cand) else None
    if nvcc is None:
        raise KernelBuildError(
            "nvcc not found on PATH or in $CUDA_HOME/bin: the CUDA kernels of "
            "lidar_imu_slam_tpu_torch cannot be built"
        )
    return nvcc


def build() -> str:
    """Compile csrc/*.cu into the hash-keyed library (if not built yet) and
    return its path. Raises KernelBuildError with nvcc's stderr on failure."""
    global build_seconds
    tag = source_hash()
    lib_path = os.path.join(BUILD_DIR, f"libkernels_{tag}.so")
    if os.path.exists(lib_path):
        return lib_path
    nvcc = find_nvcc()
    cu = [p for p in sources() if p.endswith(".cu")]
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib_path}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", tmp, *cu],
                          capture_output=True, text=True)
    build_seconds = time.perf_counter() - t0
    with open(os.path.join(BUILD_DIR, f"nvcc_{tag}.log"), "w") as f:
        f.write(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise KernelBuildError(
            f"nvcc failed (exit {proc.returncode}) building "
            f"{', '.join(os.path.basename(p) for p in cu)}:\n{proc.stderr}"
        )
    os.replace(tmp, lib_path)
    return lib_path


def load() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = ctypes.CDLL(build())
        return _lib


def check(status: int, name: str) -> None:
    """Raise when a launcher reported a CUDA error (cudaGetLastError)."""
    if status != 0:
        raise RuntimeError(f"CUDA launch of {name} failed with cudaError {status}")
