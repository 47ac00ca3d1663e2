"""A small rosbag v2.0 writer, a fixture for the tests and `chip_smoke.py`
(not a user feature): sensor_msgs/PointCloud2 scans and sensor_msgs/Imu
samples on two topics, as the readers (`host/rosbag.py` here and in the
JAX package) decode them. Messages go in time order; unchunked, or in
chunks stored uncompressed or with bz2.

    write_bag(path, scans, imu_rows, compression="bz2")

`scans`: dicts {"xyz" (n, 3), optional "time" (n,) absolute per-point
seconds, "stamp"}; `imu_rows`: (M, 7) rows [t, gx, gy, gz, ax, ay, az].
Format: http://wiki.ros.org/Bags/Format/2.0 (public spec).
"""

from __future__ import annotations

import bz2
import struct

import numpy as np

_PC2 = "sensor_msgs/PointCloud2"
_IMU = "sensor_msgs/Imu"
_F32, _F64 = 7, 8  # PointField datatypes


def _header(fields: dict) -> bytes:
    out = b""
    for k, v in fields.items():
        entry = k + b"=" + v
        out += struct.pack("<I", len(entry)) + entry
    return out


def _record(fields: dict, data: bytes) -> bytes:
    h = _header(fields)
    return struct.pack("<I", len(h)) + h + struct.pack("<I", len(data)) + data


def _ros_string(s: str) -> bytes:
    b = s.encode()
    return struct.pack("<I", len(b)) + b


def _time(t: float) -> bytes:
    secs = int(np.floor(t))
    nsecs = int(round((t - secs) * 1e9))
    if nsecs >= 1_000_000_000:
        secs, nsecs = secs + 1, nsecs - 1_000_000_000
    return struct.pack("<II", secs, nsecs)


def _ros_header(stamp: float) -> bytes:
    return struct.pack("<I", 7) + _time(stamp) + _ros_string("base")


def imu_msg(stamp: float, gyro, acc) -> bytes:
    """A serialized sensor_msgs/Imu."""
    zeros9 = struct.pack("<9d", *([0.0] * 9))
    return (_ros_header(stamp) + struct.pack("<4d", 0, 0, 0, 1) + zeros9
            + struct.pack("<3d", *gyro) + zeros9 + struct.pack("<3d", *acc) + zeros9)


def pointcloud2_msg(stamp: float, xyz: np.ndarray, times: np.ndarray | None = None) -> bytes:
    """A serialized sensor_msgs/PointCloud2: x, y, z f32 and, when given, a
    per-point `time` f64, little endian, one row."""
    xyz = np.asarray(xyz, np.float32)
    n = len(xyz)
    fields = [("x", 0, _F32), ("y", 4, _F32), ("z", 8, _F32)]
    dtype = [("x", "<f4"), ("y", "<f4"), ("z", "<f4")]
    if times is not None:
        fields.append(("time", 12, _F64))
        dtype.append(("time", "<f8"))
    rows = np.zeros(n, np.dtype(dtype))
    rows["x"], rows["y"], rows["z"] = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    if times is not None:
        rows["time"] = np.asarray(times, np.float64)
    step = rows.dtype.itemsize
    out = _ros_header(stamp) + struct.pack("<II", 1, n) + struct.pack("<I", len(fields))
    for name, off, dt in fields:
        out += _ros_string(name) + struct.pack("<IBI", off, dt, 1)
    out += struct.pack("<B", 0) + struct.pack("<II", step, step * n)  # little endian
    data = rows.tobytes()
    return out + struct.pack("<I", len(data)) + data + struct.pack("<B", 1)  # is_dense


def _connection(conn: int, topic: str, msg_type: str) -> bytes:
    return _record(
        {b"op": b"\x07", b"conn": struct.pack("<I", conn), b"topic": topic.encode()},
        _header({b"type": msg_type.encode(), b"md5sum": b"x",
                 b"message_definition": b"", b"topic": topic.encode()}),
    )


def _message(conn: int, t: float, data: bytes) -> bytes:
    return _record({b"op": b"\x02", b"conn": struct.pack("<I", conn), b"time": _time(t)}, data)


def write_bag(path: str, scans, imu_rows=(), compression: str | None = None,
              chunk_messages: int = 64, lidar_topic: str = "/points",
              imu_topic: str = "/imu") -> None:
    """Write the scans (at their stamps) and IMU rows in time order.
    compression None: unchunked message records; "none" or "bz2": chunks
    of `chunk_messages` messages, stored as given."""
    if compression not in (None, "none", "bz2"):
        raise ValueError(f"compression must be None, 'none' or 'bz2', not {compression!r}")
    msgs = [(float(r[0]), 0, _message(1, r[0], imu_msg(r[0], r[1:4], r[4:7])))
            for r in np.asarray(imu_rows, np.float64).reshape(-1, 7)]
    msgs += [(float(s.get("stamp", 0.0)), 1, _message(0, s.get("stamp", 0.0), pointcloud2_msg(
        s.get("stamp", 0.0), s["xyz"], s.get("time")))) for s in scans]
    msgs.sort(key=lambda m: m[:2])  # by time; IMU before a scan at the same time
    records = [m[2] for m in msgs]
    with open(path, "wb") as f:
        f.write(b"#ROSBAG V2.0\n")
        f.write(_connection(0, lidar_topic, _PC2) + _connection(1, imu_topic, _IMU))
        if compression is None:
            f.write(b"".join(records))
            return
        for k in range(0, len(records), chunk_messages):
            body = b"".join(records[k:k + chunk_messages])
            stored = bz2.compress(body) if compression == "bz2" else body
            f.write(_record({b"op": b"\x05", b"compression": compression.encode(),
                             b"size": struct.pack("<I", len(body))}, stored))
