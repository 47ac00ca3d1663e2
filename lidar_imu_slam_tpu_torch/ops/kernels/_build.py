"""Build and load the port's CUDA kernels (`lidar_imu_slam_tpu_torch/csrc`).

At the first call of a kernel wrapper on CUDA tensors, every `csrc/*.cu`
is compiled by its own nvcc, all started together,

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
         -Xcompiler -fPIC -Xptxas -v -c -o <obj> csrc/<source>.cu

(no --use_fast_math: the kernels rely on +inf candidates and exact sqrt /
sin / cos), the objects are linked into ONE shared library with a plain C
interface (`nvcc -shared -o build/libkernels_<hash>.so`) and loaded with
ctypes. The library name carries a sha256 of
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
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
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
    objs = [f"{tmp}.{os.path.basename(p)}.o" for p in cu]
    t0 = time.perf_counter()
    try:
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", o, p], text=True,
                                  stdout=subprocess.PIPE, stderr=subprocess.PIPE)
                 for p, o in zip(cu, objs)]
        steps = []
        for p, proc in zip(cu, procs):
            out, err = proc.communicate()
            steps.append((os.path.basename(p), proc.returncode, out, err))
        if all(rc == 0 for _, rc, _, _ in steps):
            link = subprocess.run([nvcc, "-shared", "-o", tmp, *objs],
                                  capture_output=True, text=True)
            steps.append(("link", link.returncode, link.stdout, link.stderr))
        build_seconds = time.perf_counter() - t0
        with open(os.path.join(BUILD_DIR, f"nvcc_{tag}.log"), "w") as f:
            f.writelines(f"== {name}\n{out}{err}" for name, _, out, err in steps)
        failed = [(name, rc, err) for name, rc, _, err in steps if rc != 0]
        if failed:
            raise KernelBuildError("\n".join(
                f"nvcc failed (exit {rc}) on {name}:\n{err}" for name, rc, err in failed))
        os.replace(tmp, lib_path)
    finally:
        for o in objs:
            if os.path.exists(o):
                os.remove(o)
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
