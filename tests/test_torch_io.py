"""The port's io copies against the JAX package's (CPU): the ROS bag reader
and its quaternion decode, the KITTI reader and padding, the swept
raycasts and corridor fixtures of io/synthetic.py, and the course
helpers of tests/torch_courses.py that chip_smoke.py uses.

Outputs must be equal: the same messages, bytes, arrays and exception
types.  The swept raycasts interpolate rotations with each package's own
float32 SO(3) maps; they are held to 1e-5 m with equal validity masks (on
these poses they come out byte-identical).
"""

import dataclasses
import os
import sys

import numpy as np
import pytest

from lego_loam_tpu import config_for as jconfig_for
from lego_loam_tpu.io import kitti as jkitti
from lego_loam_tpu.io import rosbag as jbag
from lego_loam_tpu.io import synthetic as jsyn
from lego_loam_tpu.utils import metrics
from lego_loam_tpu_torch import config_for
from lego_loam_tpu_torch.io import kitti as tkitti
from lego_loam_tpu_torch.io import rosbag as tbag
from lego_loam_tpu_torch.io import synthetic as tsyn

from tests import rosbag_writer as bw
from tests.test_kitti_fixture import seq_dir  # noqa: F401  (a fixture)
from tests.torch_courses import aligned_ate, fast_yaw_imu, fast_yaw_pose

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "examples"))
from run_rosbag import quat_to_mat_np  # noqa: E402


def _cloud(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, 3)).astype(np.float32),
            (np.arange(n) % 16).astype(np.uint16),
            rng.uniform(size=n).astype(np.float32))


def _messages(n=7, pts=30):
    """Alternating clouds and IMU messages, as tests/test_io.py writes."""
    xyz, ring, inten = _cloud(pts, 7)
    msgs = []
    for k in range(n):
        msgs.append(("/velodyne_points", "sensor_msgs/PointCloud2", 10.0 + k,
                     bw.encode_pointcloud2(10.0 + k, xyz, ring, inten)))
        msgs.append(("/imu/data", "sensor_msgs/Imu", 10.0 + k + 0.01,
                     bw.encode_imu(10.0 + k + 0.01, [0, 0, 0.1, 0.995],
                                   [0.01, 0.02, 0.1 * k], [0.1, 0.2, 9.81])))
    return msgs


def _same_bag(path):
    """Both readers over one bag: the same raw messages, then the same
    decoded events."""
    a, b = list(jbag.read_messages(path)), list(tbag.read_messages(path))
    assert a == b and a
    events = 0
    for (ka, pa), (kb, pb) in zip(jbag.BagSource(path), tbag.BagSource(path)):
        assert ka == kb
        assert pa.keys() == pb.keys()
        for key in pa:
            if isinstance(pa[key], np.ndarray):
                assert pa[key].dtype == pb[key].dtype
                assert np.array_equal(pa[key], pb[key])
            else:
                assert pa[key] == pb[key]
        events += 1
    assert events == len(list(jbag.BagSource(path)))
    return events


@pytest.mark.parametrize("compression", ["none", "bz2"])
def test_bag_reader_matches_jax_on_a_roundtrip_bag(tmp_path, compression):
    p = str(tmp_path / "rt.bag")
    bw.write_bag(p, _messages(3, 50), compression=compression)
    assert _same_bag(p) == 6


@pytest.mark.parametrize("compression", ["none", "bz2"])
@pytest.mark.parametrize("conns_every_chunk", [False, True])
def test_bag_reader_matches_jax_on_multichunk_bags(tmp_path, compression,
                                                   conns_every_chunk):
    p = str(tmp_path / "multi.bag")
    bw.write_bag_adversarial(p, _messages(), compression=compression, chunk_size=3,
                             conns_every_chunk=conns_every_chunk,
                             index_between_chunks=True)
    assert _same_bag(p) == 14


def test_bag_reader_matches_jax_with_duplicate_connections(tmp_path):
    p = str(tmp_path / "dup.bag")
    msgs = [m for m in _messages(6, 20) if m[0] == "/velodyne_points"]
    bw.write_bag_adversarial(p, msgs, chunk_size=2, duplicate_connections=True)
    assert _same_bag(p) == 6


@pytest.mark.parametrize("kw", [
    dict(base_offset=8, tail_pad=13),
    dict(coord_dtype=np.float64),
    dict(reverse_fields=True, extra_field=True),
    dict(organized_rows=4),
    dict(coord_count=2),
    dict(base_offset=4, tail_pad=1, coord_dtype=np.float64,
         reverse_fields=True, organized_rows=2),
])
def test_pointcloud2_adversarial_layouts_match_jax(kw):
    raw = bw.encode_pointcloud2_adversarial(5.0, *_cloud(40, 7), **kw)
    a, b = jbag.parse_pointcloud2(raw), tbag.parse_pointcloud2(raw)
    for key in ("xyz", "ring", "intensity"):
        assert a[key].dtype == b[key].dtype and np.array_equal(a[key], b[key])
    assert (a["t"], a["frame"]) == (b["t"], b["frame"])


def _bad_clouds():
    xyz, ring, inten = _cloud(8, 7)
    raw = bw.encode_pointcloud2(5.0, xyz, ring, inten)
    no_z = bytearray(raw)
    i = no_z.find(b"\x01\x00\x00\x00z")
    no_z[i + 4:i + 5] = b"w"
    pos = len(raw) - (8 * 18 + 14)          # the is_bigendian flag
    return {"missing z": bytes(no_z),
            "big-endian": raw[:pos] + b"\x01" + raw[pos + 1:],
            "truncated data": raw[:-40]}


@pytest.mark.parametrize("case", ["missing z", "big-endian", "truncated data"])
def test_pointcloud2_errors_match_jax(case):
    raw = _bad_clouds()[case]
    with pytest.raises(ValueError) as ja:
        jbag.parse_pointcloud2(raw)
    with pytest.raises(ValueError) as tb:
        tbag.parse_pointcloud2(raw)
    assert str(ja.value) == str(tb.value)


def test_truncated_bag_and_unknown_compression_raise_as_in_jax(tmp_path):
    xyz, ring, inten = _cloud(30, 7)
    p = str(tmp_path / "trunc.bag")
    bw.write_bag(p, [("/velodyne_points", "sensor_msgs/PointCloud2", 10.0,
                      bw.encode_pointcloud2(10.0, xyz, ring, inten))])
    blob = open(p, "rb").read()
    open(p, "wb").write(blob[:-37])
    for mod in (jbag, tbag):
        with pytest.raises(ValueError, match="truncated|trailing"):
            list(mod.read_messages(p))
    bad = str(tmp_path / "zstd.bag")
    import struct

    with open(bad, "wb") as f:
        f.write(b"#ROSBAG V2.0\n")
        f.write(bw._record({"op": b"\x05", "compression": b"zstd",
                            "size": struct.pack("<I", 0)}, b"\x00\x00"))
    for mod in (jbag, tbag):
        with pytest.raises(ValueError, match="unknown chunk compression"):
            list(mod.read_messages(bad))
    not_bag = str(tmp_path / "x.bag")
    open(not_bag, "wb").write(b"not a bag")
    for mod in (jbag, tbag):
        with pytest.raises(ValueError, match="not a ROS bag"):
            list(mod.read_messages(not_bag))


def test_quat_to_mat_matches_run_rosbag():
    rng = np.random.default_rng(0)
    qs = [np.zeros(4), np.array([0.0, 0.0, 0.0, 1.0]),
          np.array([0.0, 0.0, np.sin(np.pi / 4), np.cos(np.pi / 4)])]
    qs += list(rng.standard_normal((20, 4)))           # unnormalised too
    for q in qs:
        a, b = quat_to_mat_np(q), tbag.quat_to_mat(q)
        assert a.dtype == b.dtype == np.float32 and np.array_equal(a, b)


def test_kitti_reader_matches_jax(seq_dir, tmp_path):  # noqa: F811
    root, scans, _, _ = seq_dir
    jcfg, tcfg = jconfig_for("hdl64e"), config_for("hdl64e")
    velo = os.path.join(root, "velodyne")
    for name in sorted(os.listdir(velo)):
        a = jkitti.read_bin(os.path.join(velo, name))
        b = tkitti.read_bin(os.path.join(velo, name))
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()   # NaNs too
        for cap in (None, 64, 1000):
            for x, y in zip(jkitti.pad_scan(a, jcfg, cap), tkitti.pad_scan(b, tcfg, cap)):
                assert x.dtype == y.dtype and np.array_equal(x, y)
    calib = tkitti.read_calib(root)
    assert np.array_equal(calib, jkitti.read_calib(root))
    pose_file = os.path.join(root, "00.txt")
    assert np.array_equal(tkitti.read_poses(pose_file, calib),
                          jkitti.read_poses(pose_file, calib))
    seq_j = list(jkitti.KittiSequence(root, jcfg, max_frames=2))
    seq_t = list(tkitti.KittiSequence(root, tcfg, max_frames=2))
    assert len(seq_t) == len(seq_j) == 2
    for (xa, va, ta), (xb, vb, tb) in zip(seq_j, seq_t):
        assert np.array_equal(xa, xb) and np.array_equal(va, vb) and ta == tb
    T = jkitti.read_poses(pose_file, calib)
    pa, pb = str(tmp_path / "a.txt"), str(tmp_path / "b.txt")
    jkitti.write_poses_kitti(pa, T[:, :3, :3], T[:, :3, 3])
    tkitti.write_poses_kitti(pb, T[:, :3, :3], T[:, :3, 3])
    assert open(pa).read() == open(pb).read()


def _small_sensor(mod):
    """VLP-16's rows at a tenth of its columns: the swept casts trace a
    full sensor grid column by column, and the JAX package's _slerp
    dispatches per column."""
    return dataclasses.replace(mod.VLP16, horizon_scan=180, ang_res_x=2.0)


@pytest.mark.parametrize("seed", [3, 7])
def test_swept_raycasts_match_jax(seed):
    import lego_loam_tpu.config as jc
    import lego_loam_tpu_torch.config as tc

    jw, tw = jsyn.default_world(seed), tsyn.default_world(seed)
    (R0, t0), (R1, t1) = fast_yaw_pose(seed), fast_yaw_pose(seed + 1)
    a = jsyn.raycast_swept(jw, R0, t0, R1, t1, _small_sensor(jc), noise=0.02,
                           rng=np.random.default_rng(seed))
    b = tsyn.raycast_swept(tw, R0, t0, R1, t1, _small_sensor(tc), noise=0.02,
                           rng=np.random.default_rng(seed))
    assert np.array_equal(a[1], b[1]) and np.array_equal(a[2], b[2])
    np.testing.assert_allclose(b[0], a[0], atol=1e-5, rtol=0)
    for u in (0.0, 0.37, 1.0):
        np.testing.assert_allclose(tsyn._slerp(R0, R1, u), jsyn._slerp(R0, R1, u),
                                   atol=1e-6, rtol=0)
    # an arbitrary profile: the JAX test's accelerated sweep
    from tests.torch_courses import accel_profile

    pose = accel_profile(np.array([0.0, 0.0, 1.6]), np.array([8.0, 0, 0]),
                         np.array([0.0, 8.0, 0.0]), 0.6, 24.0)[0]
    a = jsyn.raycast_swept_profile(jw, pose, _small_sensor(jc))
    b = tsyn.raycast_swept_profile(tw, pose, _small_sensor(tc))
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes()


def test_corridor_world_and_straight_trajectory_match_jax():
    for kw in (dict(), dict(end_caps=False),
               dict(pole_period=7.0, landmarks=np.array([[30.0, 1.0, 0.0, 31.0, 2.0, 1.5]]))):
        a, b = jsyn.corridor_world(**kw), tsyn.corridor_world(**kw)
        assert np.array_equal(a.boxes, b.boxes)
        assert np.array_equal(a.cylinders, b.cylinders)
        assert a.ground_z == b.ground_z
    for (Ra, ta), (Rb, tb) in zip(jsyn.straight_trajectory(5, start=1.0, step=0.3, y=0.2),
                                  tsyn.straight_trajectory(5, start=1.0, step=0.3, y=0.2)):
        assert np.array_equal(Ra, Rb) and np.array_equal(ta, tb)


def test_course_helpers_match_bench_and_metrics():
    """tests/torch_courses.py's aligned ATE is metrics.ate_rmse, and its
    fast-yaw IMU stream is bench.py's (with the port's gravity)."""
    rng = np.random.default_rng(2)
    gt = rng.normal(size=(30, 3))
    est = gt @ np.linalg.qr(rng.normal(size=(3, 3)))[0].T + rng.normal(size=(30, 3)) * 0.01
    assert aligned_ate(est, gt) == pytest.approx(metrics.ate_rmse(est, gt), abs=1e-12)
    samples = fast_yaw_imu(3)
    assert [s[0] for s in samples] == [(3 + j / 10.0) * 0.1 for j in range(10)]
    R, _ = fast_yaw_pose(3.5)
    a = 0.45 * 3.5 / 6.0
    assert np.allclose(R, [[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]])


def test_a_course_bag_replays_as_the_course():
    """tests/torch_courses.py writes a course to a bag the way chip_smoke.py
    feeds the IMU arm; BagSource, pad_scan and quat_to_mat give back the
    same clouds, stamps and samples (rotations to float32 rounding)."""
    import tempfile

    from tests.torch_courses import quat_from_mat, write_imu_bag

    rng = np.random.default_rng(4)
    for R in [np.eye(3), np.diag([1.0, -1.0, -1.0]), np.diag([-1.0, 1.0, -1.0]),
              np.linalg.qr(rng.normal(size=(3, 3)))[0] * [1, 1, -1]]:
        R = R * np.sign(np.linalg.det(R))
        np.testing.assert_allclose(tbag.quat_to_mat(quat_from_mat(R)), R, atol=1e-6)
    cfg = config_for("vlp16")
    scans = [tsyn.raycast(tsyn.default_world(1), np.eye(3), np.array([0.0, k, 1.6]),
                          cfg.sensor) for k in range(2)]
    stamps = [0.0, 0.1]
    imu = [fast_yaw_imu(k) for k in range(2)]
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "course.bag")
        write_imu_bag(path, scans, stamps, imu, 0.1)
        events = list(tbag.BagSource(path))
    assert [k for k, _ in events] == (["imu"] * 10 + ["scan"]) * 2
    clouds = [m for k, m in events if k == "scan"]
    for (xyz, valid, ring), t, m in zip(scans, stamps, clouds):
        assert abs(m["t"] - t) < 1e-6
        pxyz, pvalid = tkitti.pad_scan(m["xyz"], cfg)
        n = int(valid.sum())
        assert np.array_equal(pxyz[:n], xyz[valid]) and pvalid[:n].all() and not pvalid[n:].any()
        assert np.array_equal(m["ring"], ring[valid])
    got = [m for k, m in events if k == "imu"]
    for (t, R, acc, gyro), m in zip([s for ss in imu for s in ss], got):
        assert abs(m["t"] - t) < 1e-6
        np.testing.assert_allclose(tbag.quat_to_mat(m["quat"]), R, atol=1e-6)
        assert np.allclose(m["acc"], acc) and np.allclose(m["gyro"], gyro)
