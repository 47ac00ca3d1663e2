"""Minimal pure-Python rosbag v2.0 reader — no ROS dependency (counterpart
of the JAX package's `host/rosbag.py`, the same decoded arrays).

The reference consumes live ROS topics / `rosbag play` (reference
launch/limu.launch:3-11); this framework has no ROS in its core, so bags are
decoded directly: chunk records (none/bz2 compression), connection records,
and deserializers for the two message types the pipeline needs —
sensor_msgs/PointCloud2 and sensor_msgs/Imu.

Format: http://wiki.ros.org/Bags/Format/2.0 (public spec).
"""

from __future__ import annotations

import bz2
import struct
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

OP_MSG_DATA = 0x02
OP_BAG_HEADER = 0x03
OP_INDEX = 0x04
OP_CHUNK = 0x05
OP_CHUNK_INFO = 0x06
OP_CONNECTION = 0x07

_DATATYPE_NP = {
    1: np.int8, 2: np.uint8, 3: np.int16, 4: np.uint16,
    5: np.int32, 6: np.uint32, 7: np.float32, 8: np.float64,
}


def _parse_header(buf: bytes) -> Dict[bytes, bytes]:
    fields = {}
    i = 0
    while i < len(buf):
        (flen,) = struct.unpack_from("<I", buf, i)
        i += 4
        entry = buf[i:i + flen]
        i += flen
        name, _, value = entry.partition(b"=")
        fields[name] = value
    return fields


def _read_record(f) -> Optional[Tuple[Dict[bytes, bytes], bytes]]:
    raw = f.read(4)
    if len(raw) < 4:
        return None
    (hlen,) = struct.unpack("<I", raw)
    header = _parse_header(f.read(hlen))
    (dlen,) = struct.unpack("<I", f.read(4))
    data = f.read(dlen)
    return header, data


class _Cursor:
    """Byte cursor for little-endian ROS message deserialization."""

    __slots__ = ("buf", "i")

    def __init__(self, buf: bytes):
        self.buf = buf
        self.i = 0

    def u32(self) -> int:
        (v,) = struct.unpack_from("<I", self.buf, self.i)
        self.i += 4
        return v

    def u8(self) -> int:
        v = self.buf[self.i]
        self.i += 1
        return v

    def f64(self, n: int = 1):
        v = struct.unpack_from(f"<{n}d", self.buf, self.i)
        self.i += 8 * n
        return v if n > 1 else v[0]

    def string(self) -> str:
        n = self.u32()
        s = self.buf[self.i:self.i + n]
        self.i += n
        return s.decode("utf-8", "replace")

    def time(self) -> float:
        secs, nsecs = struct.unpack_from("<II", self.buf, self.i)
        self.i += 8
        return secs + nsecs * 1e-9

    def skip(self, n: int) -> None:
        self.i += n

    def rest(self, n: int) -> bytes:
        b = self.buf[self.i:self.i + n]
        self.i += n
        return b


def _parse_ros_header(c: _Cursor) -> float:
    c.u32()  # seq
    stamp = c.time()
    c.string()  # frame_id
    return stamp


def parse_imu(data: bytes) -> dict:
    c = _Cursor(data)
    stamp = _parse_ros_header(c)
    orientation = c.f64(4)  # x, y, z, w
    c.f64(9)
    angular_velocity = c.f64(3)
    c.f64(9)
    linear_acceleration = c.f64(3)
    c.f64(9)
    return {
        "stamp": stamp,
        "orientation": np.asarray(orientation),
        "gyro": np.asarray(angular_velocity),
        "acc": np.asarray(linear_acceleration),
    }


def parse_pointcloud2(data: bytes) -> dict:
    c = _Cursor(data)
    stamp = _parse_ros_header(c)
    height, width = c.u32(), c.u32()
    n_fields = c.u32()
    fields = []
    for _ in range(n_fields):
        name = c.string()
        offset = c.u32()
        datatype = c.u8()
        count = c.u32()
        fields.append((name, offset, datatype, count))
    is_bigendian = c.u8()
    point_step = c.u32()
    c.u32()  # row_step
    n_bytes = c.u32()
    raw = c.rest(n_bytes)
    # is_dense trails; ignore

    n_points = height * width
    out = {"stamp": stamp, "n_points": n_points, "fields": {}}
    arr = np.frombuffer(raw[: n_points * point_step], dtype=np.uint8).reshape(
        n_points, point_step
    )
    for name, offset, datatype, count in fields:
        np_t = _DATATYPE_NP.get(datatype)
        if np_t is None:
            continue
        width_b = np.dtype(np_t).itemsize * count
        col = arr[:, offset:offset + width_b].copy().view(np_t)
        if is_bigendian:
            col = col.byteswap()
        out["fields"][name] = col.reshape(n_points, count).squeeze(-1) if count == 1 else col.reshape(n_points, count)
    return out


class BagReader:
    """Streaming reader yielding (topic, msg_type, stamp, raw_bytes)."""

    def __init__(self, path: str):
        self.path = path
        self.connections: Dict[int, Tuple[str, str]] = {}

    def records(self) -> Iterator[Tuple[str, str, float, bytes]]:
        with open(self.path, "rb") as f:
            magic = f.readline()
            if not magic.startswith(b"#ROSBAG V2.0"):
                raise ValueError(f"not a rosbag 2.0 file: {magic!r}")
            while True:
                rec = _read_record(f)
                if rec is None:
                    return
                header, data = rec
                op = header.get(b"op", b"\x00")[0]
                if op == OP_CONNECTION:
                    yield from self._handle_connection(header, data)
                elif op == OP_CHUNK:
                    yield from self._iter_chunk(header, data)
                elif op == OP_MSG_DATA:
                    yield self._msg(header, data)

    def _handle_connection(self, header, data):
        conn = struct.unpack("<I", header[b"conn"])[0]
        topic = header.get(b"topic", b"").decode()
        sub = _parse_header(data)
        msg_type = sub.get(b"type", b"").decode()
        self.connections[conn] = (topic, msg_type)
        return
        yield  # make this a generator

    def _iter_chunk(self, header, data):
        compression = header.get(b"compression", b"none").decode()
        if compression == "bz2":
            data = bz2.decompress(data)
        elif compression == "lz4":
            try:
                import lz4.frame  # type: ignore

                data = lz4.frame.decompress(data)
            except ImportError as e:
                raise RuntimeError("lz4-compressed bag but no lz4 module") from e
        i = 0
        while i < len(data):
            (hlen,) = struct.unpack_from("<I", data, i)
            i += 4
            h = _parse_header(data[i:i + hlen])
            i += hlen
            (dlen,) = struct.unpack_from("<I", data, i)
            i += 4
            d = data[i:i + dlen]
            i += dlen
            op = h.get(b"op", b"\x00")[0]
            if op == OP_CONNECTION:
                list(self._handle_connection(h, d))
            elif op == OP_MSG_DATA:
                yield self._msg(h, d)

    def _msg(self, header, data):
        conn = struct.unpack("<I", header[b"conn"])[0]
        secs, nsecs = struct.unpack("<II", header[b"time"])
        topic, msg_type = self.connections.get(conn, ("?", "?"))
        return topic, msg_type, secs + nsecs * 1e-9, data


def read_sensor_streams(
    path: str,
    lidar_topic: Optional[str] = None,
    imu_topic: Optional[str] = None,
):
    """Decode all PointCloud2 and Imu messages (auto-detect topics when not
    given). Returns (lidar_msgs: list[dict], imu_msgs: list[dict])."""
    reader = BagReader(path)
    lidar_msgs: List[dict] = []
    imu_msgs: List[dict] = []
    for topic, msg_type, stamp, data in reader.records():
        if msg_type == "sensor_msgs/PointCloud2" and (
            lidar_topic is None or topic == lidar_topic
        ):
            msg = parse_pointcloud2(data)
            msg["topic"] = topic
            msg["bag_stamp"] = stamp
            lidar_msgs.append(msg)
        elif msg_type == "sensor_msgs/Imu" and (
            imu_topic is None or topic == imu_topic
        ):
            msg = parse_imu(data)
            msg["topic"] = topic
            msg["bag_stamp"] = stamp
            imu_msgs.append(msg)
    return lidar_msgs, imu_msgs
