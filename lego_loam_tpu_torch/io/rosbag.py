"""Minimal ROS1 bag (format 2.0) reader — no ROS dependency.  A jax-free
copy of ``lego_loam_tpu.io.rosbag``, plus quat_to_mat, the bag replay's
quaternion decode (``examples/run_rosbag.py``'s quat_to_mat_np).

The reference ingests data exclusively by replaying rosbags
(`rosbag play *.bag`, reference: README.md:98-113).  This module reads the
two message types the pipeline needs — sensor_msgs/PointCloud2 (with the
Velodyne ring channel) and sensor_msgs/Imu — directly from the bag file:
record framing, connection registry, chunk decompression (none / bz2, and
lz4 when the module is available), and hand-rolled message deserialization.

Host-side pure Python; bags are an offline ingest path, not the hot loop.
A matching minimal writer lives in tests (tests/rosbag_writer.py) so the
reader is testable without the reference datasets.
"""

from __future__ import annotations

import bz2
import struct
from dataclasses import dataclass
from typing import Iterator

import numpy as np

_OP_MSG = 0x02
_OP_BAG_HEADER = 0x03
_OP_INDEX = 0x04
_OP_CHUNK = 0x05
_OP_CHUNK_INFO = 0x06
_OP_CONNECTION = 0x07

MAGIC = b"#ROSBAG V2.0\n"


def _parse_header(buf: bytes) -> dict:
    fields = {}
    off = 0
    while off < len(buf):
        (flen,) = struct.unpack_from("<I", buf, off)
        off += 4
        entry = buf[off : off + flen]
        off += flen
        k, _, v = entry.partition(b"=")
        fields[k.decode()] = v
    return fields


def _records(buf: bytes, off: int = 0) -> Iterator[tuple[dict, bytes]]:
    n = len(buf)
    while off + 8 <= n:
        (hlen,) = struct.unpack_from("<I", buf, off)
        off += 4
        if off + hlen + 4 > n:
            raise ValueError(
                f"truncated bag record header at offset {off - 4}")
        header = _parse_header(buf[off : off + hlen])
        off += hlen
        (dlen,) = struct.unpack_from("<I", buf, off)
        off += 4
        if off + dlen > n:
            raise ValueError(f"truncated bag record data at offset {off - 4}")
        data = buf[off : off + dlen]
        off += dlen
        yield header, data
    if off != n:
        raise ValueError(f"{n - off} trailing bytes after last bag record")


@dataclass
class Connection:
    cid: int
    topic: str
    msg_type: str


def _read_string(buf, off):
    (n,) = struct.unpack_from("<I", buf, off)
    off += 4
    return buf[off : off + n].decode(errors="replace"), off + n


def _read_header_msg(buf, off):
    """std_msgs/Header: seq, stamp(sec, nsec), frame_id."""
    seq, sec, nsec = struct.unpack_from("<III", buf, off)
    off += 12
    frame, off = _read_string(buf, off)
    return (sec + 1e-9 * nsec, frame), off


_PC2_DTYPES = {
    1: np.int8, 2: np.uint8, 3: np.int16, 4: np.uint16,
    5: np.int32, 6: np.uint32, 7: np.float32, 8: np.float64,
}


def parse_pointcloud2(data: bytes) -> dict:
    """Returns {t, frame, xyz (N,3) f32, ring (N,) i32 | None,
    intensity (N,) f32 | None}.

    Handles arbitrary field offsets/strides (sparse point_step with
    padding, extra vendor fields, float64 coordinates, count>1 fields —
    the first element is taken, matching rosbag/PCL behavior).  Raises a
    clear ValueError on big-endian clouds, missing x/y/z, unknown field
    dtypes, or a data section shorter than height*width*point_step."""
    (t, frame), off = _read_header_msg(data, 0)
    height, width = struct.unpack_from("<II", data, off)
    off += 8
    (nfields,) = struct.unpack_from("<I", data, off)
    off += 4
    fields = []
    for _ in range(nfields):
        name, off = _read_string(data, off)
        foffset, dtype, count = struct.unpack_from("<IBI", data, off)
        off += 9
        fields.append((name, foffset, dtype, count))
    (is_bigendian,) = struct.unpack_from("<B", data, off)
    off += 1
    if is_bigendian:
        raise ValueError("big-endian PointCloud2 not supported")
    point_step, row_step = struct.unpack_from("<II", data, off)
    off += 8
    (dlen,) = struct.unpack_from("<I", data, off)
    off += 4
    raw = np.frombuffer(data, np.uint8, count=min(dlen, len(data) - off),
                        offset=off)
    off += dlen
    n = height * width
    if raw.size < n * point_step:
        raise ValueError(
            f"PointCloud2 data truncated: {raw.size} bytes for "
            f"{n} x {point_step}-byte points")
    raw = raw[: n * point_step].reshape(n, point_step)

    def take(name, required=False):
        for fname, foff, dt, cnt in fields:
            if fname == name:
                if dt not in _PC2_DTYPES:
                    raise ValueError(
                        f"PointCloud2 field {name!r} has unknown dtype {dt}")
                npdt = _PC2_DTYPES[dt]
                w = np.dtype(npdt).itemsize
                if foff + w > point_step:
                    raise ValueError(
                        f"PointCloud2 field {name!r} at offset {foff} "
                        f"overruns point_step {point_step}")
                return raw[:, foff : foff + w].copy().view(npdt)[:, 0]
        if required:
            raise ValueError(f"PointCloud2 missing required field {name!r}")
        return None

    x = take("x", required=True)
    y = take("y", required=True)
    z = take("z", required=True)
    xyz = np.stack([x, y, z], axis=1).astype(np.float32)
    ring = take("ring")
    intensity = take("intensity")
    return {
        "t": t, "frame": frame, "xyz": xyz,
        "ring": None if ring is None else ring.astype(np.int32),
        "intensity": None if intensity is None else intensity.astype(np.float32),
    }


def parse_imu(data: bytes) -> dict:
    """Returns {t, quat (4,) [x,y,z,w], gyro (3,), acc (3,)}."""
    (t, frame), off = _read_header_msg(data, 0)
    quat = np.array(struct.unpack_from("<4d", data, off))
    off += 32 + 72
    gyro = np.array(struct.unpack_from("<3d", data, off))
    off += 24 + 72
    acc = np.array(struct.unpack_from("<3d", data, off))
    return {"t": t, "quat": quat, "gyro": gyro, "acc": acc}


def _decompress(header: dict, data: bytes) -> bytes:
    comp = header.get("compression", b"none").decode()
    if comp == "none":
        return data
    if comp == "bz2":
        return bz2.decompress(data)
    if comp == "lz4":
        try:
            import lz4.frame

            return lz4.frame.decompress(data)
        except ImportError as e:
            raise RuntimeError("bag uses lz4; lz4 module unavailable") from e
    raise ValueError(f"unknown chunk compression {comp!r}")


def read_messages(path: str, topics: set[str] | None = None
                  ) -> Iterator[tuple[str, float, str, bytes]]:
    """Yield (topic, record_time, msg_type, raw_bytes) in file order."""
    with open(path, "rb") as f:
        blob = f.read()
    if not blob.startswith(MAGIC):
        raise ValueError(f"{path} is not a ROS bag 2.0 file")
    conns: dict[int, Connection] = {}

    def handle(header, data):
        op = header["op"][0]
        if op == _OP_CONNECTION:
            cid = struct.unpack("<I", header["conn"])[0]
            topic = header["topic"].decode()
            sub = _parse_header(data)
            conns[cid] = Connection(cid, topic, sub.get(b"type", b"").decode())
        elif op == _OP_MSG:
            cid = struct.unpack("<I", header["conn"])[0]
            sec, nsec = struct.unpack("<II", header["time"])
            c = conns.get(cid)
            if c and (topics is None or c.topic in topics):
                return (c.topic, sec + 1e-9 * nsec, c.msg_type, data)
        elif op == _OP_CHUNK:
            inner = _decompress(header, data)
            for h2, d2 in _records(inner):
                out = handle(h2, d2)
                if out:
                    yield_list.append(out)
        return None

    yield_list: list = []
    for header, data in _records(blob, len(MAGIC)):
        out = handle(header, data)
        if out:
            yield_list.append(out)
        while yield_list:
            yield yield_list.pop(0)


class BagSource:
    """Stream (kind, payload) events from a bag: kind in {'scan', 'imu'}."""

    def __init__(self, path: str,
                 cloud_topic: str = "/velodyne_points",
                 imu_topic: str = "/imu/data"):
        self.path = path
        self.cloud_topic = cloud_topic
        self.imu_topic = imu_topic

    def __iter__(self):
        for topic, t, mtype, raw in read_messages(
                self.path, {self.cloud_topic, self.imu_topic}):
            if topic == self.cloud_topic:
                yield "scan", parse_pointcloud2(raw)
            else:
                yield "imu", parse_imu(raw)


def quat_to_mat(q) -> np.ndarray:
    """[x, y, z, w] quaternion (sensor_msgs/Imu orientation) -> (3, 3)
    float32 rotation matrix; a zero quaternion gives the identity."""
    x, y, z, w = q
    n = x * x + y * y + z * z + w * w
    s = 0.0 if n == 0.0 else 2.0 / n
    xx, yy, zz = s * x * x, s * y * y, s * z * z
    xy, xz, yz = s * x * y, s * x * z, s * y * z
    wx, wy, wz = s * w * x, s * w * y, s * w * z
    return np.array([
        [1.0 - (yy + zz), xy - wz, xz + wy],
        [xy + wz, 1.0 - (xx + zz), yz - wx],
        [xz - wy, yz + wx, 1.0 - (xx + yy)],
    ], dtype=np.float32)
