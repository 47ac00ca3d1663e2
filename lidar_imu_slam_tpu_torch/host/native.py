"""ctypes bindings for the native host runtime (native/scan_packer.cpp;
counterpart of the JAX package's `host/native.py`, with the same C ABI).

Compiles the shared library on first use with g++ (plain C ABI, no
pybind11) into the port's build directory, `lidar_imu_slam_tpu_torch/
build/`, and rebuilds it when the source's hash changes. `available()` is
False when no compiler is found; callers then use the Python path
(`ops/preprocess`). No path of the port calls the native packer: it is
host code, not the device path.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_SRC = os.path.join(os.path.dirname(__file__), "..", "..", "native", "scan_packer.cpp")
_BUILD_DIR = os.path.join(os.path.dirname(__file__), "..", "build")
_LIB_PATH = os.path.join(_BUILD_DIR, "libscanpack.so")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


class _PackParams(ctypes.Structure):
    _fields_ = [
        ("min_range", ctypes.c_double),
        ("max_range", ctypes.c_double),
        ("stamp", ctypes.c_double),
        ("frame_rate", ctypes.c_double),
        ("angle_limit", ctypes.c_double),
        ("num_scan_lines", ctypes.c_int32),
        ("max_points", ctypes.c_int32),
    ]


def _src_hash() -> str:
    import hashlib

    with open(os.path.abspath(_SRC), "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def _build() -> Optional[str]:
    # no -march=native: the library must stay loadable on any host CPU
    os.makedirs(_BUILD_DIR, exist_ok=True)
    src = os.path.abspath(_SRC)
    # build beside the target, then rename: a process that loads the
    # library never sees a half-written file
    tmp = f"{_LIB_PATH}.{os.getpid()}.tmp"
    try:
        subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", src, "-o", tmp],
            check=True,
            capture_output=True,
        )
        os.replace(tmp, _LIB_PATH)
        with open(_LIB_PATH + ".srchash", "w") as f:
            f.write(_src_hash())
        return _LIB_PATH
    except (subprocess.CalledProcessError, FileNotFoundError):
        return None


def _prebuilt_current() -> bool:
    """A prebuilt library is only trusted if its source-hash sidecar matches
    the current scan_packer.cpp — otherwise an edit would silently keep
    executing a stale binary."""
    if not os.path.exists(_LIB_PATH):
        return False
    try:
        with open(_LIB_PATH + ".srchash") as f:
            return f.read().strip() == _src_hash()
    except OSError:
        return False


def get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = _LIB_PATH if _prebuilt_current() else _build()
        if path is None:
            return None
        lib = ctypes.CDLL(path)
        lib.pack_scan.restype = ctypes.c_int
        lib.pack_scan.argtypes = [
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int32,
            ctypes.POINTER(_PackParams),
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_double),
        ]
        lib.voxel_downsample.restype = ctypes.c_int
        lib.voxel_downsample.argtypes = [
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_int32,
            ctypes.c_double,
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_int32,
        ]
        _lib = lib
        return _lib


def available() -> bool:
    return get_lib() is not None


def _require_lib() -> ctypes.CDLL:
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native library unavailable (no g++, or its build failed)")
    return lib


def pack_scan_native(
    xyz: np.ndarray,
    time: Optional[np.ndarray],
    ring: Optional[np.ndarray],
    stamp: float,
    lidar_cfg,
):
    """Native equivalent of host packing + preprocess: returns the arrays
    of a `Scan` (xyz, tau, rel_t, mask, t_begin, t_end) as numpy, matching
    ops/preprocess.preprocess_scan semantics."""
    lib = _require_lib()
    xyz = np.ascontiguousarray(xyz, np.float32)
    n = len(xyz)
    cap = lidar_cfg.max_points
    t = np.ascontiguousarray(time, np.float64) if time is not None else None
    r = np.ascontiguousarray(ring, np.int32) if ring is not None else None

    out_xyz = np.zeros((cap, 3), np.float32)
    out_tau = np.zeros((cap,), np.float32)
    out_rel = np.zeros((cap,), np.float64)
    out_mask = np.zeros((cap,), np.uint8)
    t_begin = ctypes.c_double()
    t_end = ctypes.c_double()
    params = _PackParams(
        min_range=lidar_cfg.min_range,
        max_range=lidar_cfg.max_range,
        stamp=float(stamp),
        frame_rate=lidar_cfg.frame_rate,
        angle_limit=lidar_cfg.angle_limit,
        num_scan_lines=lidar_cfg.num_scan_lines,
        max_points=cap,
    )

    def ptr(a, ct):
        return a.ctypes.data_as(ctypes.POINTER(ct)) if a is not None else None

    lib.pack_scan(
        ptr(xyz, ctypes.c_float),
        ptr(t, ctypes.c_double),
        ptr(r, ctypes.c_int32),
        n,
        ctypes.byref(params),
        ptr(out_xyz, ctypes.c_float),
        ptr(out_tau, ctypes.c_float),
        ptr(out_rel, ctypes.c_double),
        ptr(out_mask, ctypes.c_uint8),
        ctypes.byref(t_begin),
        ctypes.byref(t_end),
    )
    return out_xyz, out_tau, out_rel, out_mask.astype(bool), t_begin.value, t_end.value


def voxel_downsample_native(xyz: np.ndarray, voxel_size: float, out_cap: int):
    lib = _require_lib()
    xyz = np.ascontiguousarray(xyz, np.float32)
    out = np.zeros((out_cap, 3), np.float32)
    m = lib.voxel_downsample(
        xyz.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        len(xyz),
        voxel_size,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        out_cap,
    )
    return out[:m]
