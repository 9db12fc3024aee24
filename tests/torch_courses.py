"""Shared test courses of the PyTorch port, free of jax: the CPU parity
tests and chip_smoke.py (which runs where jax is not installed) drive the
same configs over the same seeded synthetic scans.

  * SMALL: the small capacities of tests/test_pipeline.py with the exact
    5-NN (the port's kernel is exact; the JAX default approximates on a
    TPU); slice_course() is tests/test_torch_pipeline.py's 6-scan course.
  * LOOP: tests/test_loop_pipeline.py's config overrides, of which
    LOOP_COURSE_KNOBS are the course's own; loop_course() is its
    out-and-back course (out along x, back 0.3 m to the side), with its
    scan stamps, or a shorter one (LOOP_SHORT_OUT scans out).
  * the fleet: fleet_course(sensor, b) is sequence b of chip_smoke.py's
    fleet phase (circles of growing radius and arc in world seed 0).
  * IMU: bench.py's fast-yaw de-skew course (fast_yaw_course,
    fast_yaw_imu), tests/test_imu_deskew.py's in-sweep profiles and truth
    buffers (accel_profile, truth_buffer), bench.py's aligned ATE
    (aligned_ate) and a course written to a ROS bag (write_imu_bag).
  * KITTI: a course written as a KITTI odometry sequence directory
    (write_kitti_sequence: .bin scans, KITTI-00's calibration, poses).
  * FAITHFUL: the reference-faithful knobs (sequential sector picks,
    two-step odometry, the 3-point surf plane, no ground-label gate, no
    prominence gate) of examples/accuracy_sweep.py's "faithful" arm and
    of the NumPy oracles of the C++ reference; ORACLE_CFG and
    oracle_course() are tests/test_oracle_pipeline.py's config and
    15-scan course.
  * E1: seeded symmetric 6x6 or 3x3 systems for the degeneracy
    projection (eig6_spectra), every eigenvalue well away from the
    threshold.
  * A20, the JAX package's behaviour tests: ROBUST and
    robustness_course() are tests/test_robustness.py's config and its four
    degenerate courses (ROBUST_COURSES); loop_robust_cfg(), CORRIDOR_START,
    CORRIDOR_LANDMARKS, corridor_out_and_back() and corridor_state() are
    tests/test_loop_robustness.py's _cfg, START, LANDMARKS, _out_and_back
    and _make_state, the state built with the port's voxel_downsample;
    STRESS, stress_corridor() and stress_fast_yaw() are
    tests/test_stress.py's config and courses (scans cast by
    stress_scans).

Scans come from the port's raycaster, which casts byte-identical scans to
the JAX package's (tests/test_torch_import.py).
"""

from __future__ import annotations

import os

import numpy as np

from lego_loam_tpu_torch.io import synthetic as syn
from lego_loam_tpu_torch.utils.metrics import ate_rmse

SMALL = dict(deskew=False, max_keyframes=64, max_map_corner=2048,
             max_map_surf=8192, kf_corner_cap=512, kf_surf_cap=2048,
             kf_outlier_cap=512, max_scan_corner_ds=512, max_scan_surf_ds=2048,
             nn_query_tile=256, mapping_process_every=2, nn_exact=True)
SLICE_SCANS = 6

# the reference-faithful configuration: the C++ reference's decisions
# (examples/accuracy_sweep.py's "faithful" arm, PARITY.md)
FAITHFUL = dict(deskew=False, nn_exact=True, sector_parallel=False,
                odom_class_gate=False, edge_prominence=0.0,
                odom_mode="two_step", odom_surf_fit="tri")
# tests/test_oracle_pipeline.py's CFG overrides (its odometry is the
# default block schedule; its oracle runs the reference's two-step)
ORACLE_CFG = dict(deskew=False, max_keyframes=64, max_map_corner=4096,
                  max_map_surf=16384, kf_corner_cap=512, kf_surf_cap=2048,
                  kf_outlier_cap=512, max_scan_corner_ds=512,
                  max_scan_surf_ds=2048, nn_query_tile=512, max_loop_edges=8,
                  pg_gn_iters=4, nn_exact=True, sector_parallel=False,
                  odom_class_gate=False, edge_prominence=0.0,
                  odom_surf_fit="tri")

# the knobs of the out-and-back course: a revisit 3 s after the first
# visit counts, every scan is mapped, and keyframes are 0.25 m apart
LOOP_COURSE_KNOBS = dict(mapping_process_every=1, loop_min_time_gap=3.0,
                         keyframe_min_translation=0.25)
LOOP = dict(deskew=False, max_keyframes=64, max_map_corner=2048,
            max_map_surf=8192, kf_corner_cap=256, kf_surf_cap=1024,
            kf_outlier_cap=256, max_scan_corner_ds=256, max_scan_surf_ds=1024,
            nn_query_tile=256, loop_closure_enabled=True, max_loop_edges=8,
            pg_gn_iters=4, **LOOP_COURSE_KNOBS)
LOOP_CHECK_EVERY = 2
LOOP_SCAN_PERIOD = 0.55     # s between stamps of the out-and-back course
LOOP_FINAL_BOUND = 0.12     # m, the final-pose bound of test_loop_pipeline.py
LOOP_OUT = 8                # scans out (and as many back) on the full course
LOOP_SHORT_OUT = 5          # the shorter course the CPU parity test drives


def slice_course(sensor, n: int = SLICE_SCANS):
    """(poses, scans): the first n poses of a 12-pose circle arc of radius
    8 m in world seed 4, each scan with 1 cm range noise (seed = index)."""
    world = syn.default_world(seed=4)
    poses = syn.circle_trajectory(12, radius=8.0, arc=0.35 * np.pi)[:n]
    scans = [syn.raycast(world, R, t, sensor, noise=0.01,
                         rng=np.random.default_rng(k))
             for k, (R, t) in enumerate(poses)]
    return poses, scans


def oracle_course(sensor, n: int = 15):
    """(poses, scans) of tests/test_oracle_pipeline.py's trajectory test:
    the first n of 15 poses of a 12 m circle over 0.35 rad in world seed
    11, 1 cm range noise (seed 500 + index)."""
    world = syn.default_world(seed=11)
    poses = syn.circle_trajectory(15, radius=12.0, arc=0.35)[:n]
    scans = [syn.raycast(world, R, t, sensor, noise=0.01,
                         rng=np.random.default_rng(500 + k))
             for k, (R, t) in enumerate(poses)]
    return poses, scans


def fleet_course(sensor, b: int, n: int = 30, radius_step: float = 0.5):
    """(poses, scans) of fleet sequence b (chip_smoke.py's fleet phase,
    tests/fleet_gaps.py): circle_trajectory(n, radius=12 + radius_step b,
    arc=(0.35 + 0.02 b) pi) in default_world(0), 1 cm range noise (seed
    1000 b + index).  Sequence 0 is chip_smoke.py's slice course.  With
    radius_step 1, sequence 6 runs an 18 m circle on which process_scan
    loses track from scan 21 on."""
    world = syn.default_world(seed=0)
    poses = syn.circle_trajectory(n, radius=12.0 + radius_step * b,
                                  arc=(0.35 + 0.02 * b) * np.pi)
    scans = [syn.raycast(world, R, t, sensor, noise=0.01,
                         rng=np.random.default_rng(1000 * b + k))
             for k, (R, t) in enumerate(poses)]
    return poses, scans


def loop_positions(n_out: int = LOOP_OUT, step: float = 0.45, side: float = 0.3):
    """Sensor positions of the out-and-back course: n_out steps out along
    x, then the same steps back, `side` metres to the left."""
    out = [np.array([step * i, 0.0, 1.6]) for i in range(n_out)]
    back = [np.array([step * (n_out - 1 - i), side, 1.6]) for i in range(n_out)]
    return out + back


def loop_course(sensor, n_out: int = LOOP_OUT):
    """(positions, scans, stamps) of the out-and-back course in world
    seed 6 (no rotation, 1 cm range noise, seed = index)."""
    world = syn.default_world(seed=6)
    ts = loop_positions(n_out)
    scans = [syn.raycast(world, np.eye(3), t, sensor, noise=0.01,
                         rng=np.random.default_rng(k))
             for k, t in enumerate(ts)]
    return ts, scans, [LOOP_SCAN_PERIOD * k for k in range(len(ts))]


# ---------------------------------------------------------------- IMU

def yaw_R(a) -> np.ndarray:
    return np.array([[np.cos(a), -np.sin(a), 0.0],
                     [np.sin(a), np.cos(a), 0.0],
                     [0.0, 0.0, 1.0]])


def accel_profile(t0_pos, v0, acc, w0, alpha, R_base=None, dt=0.1):
    """tests/test_imu_deskew.py's quadratic in-sweep profile: world pose,
    velocity and integrated gyro at sweep fraction u, for position
    t0 + v0 tau + acc tau^2 / 2 and yaw w0 tau + alpha tau^2 / 2."""
    R_base = np.eye(3) if R_base is None else R_base

    def pose(u):
        tau = u * dt
        yaw = w0 * tau + 0.5 * alpha * tau * tau
        return R_base @ yaw_R(yaw), t0_pos + v0 * tau + 0.5 * acc * tau * tau

    def velo(u):
        return v0 + acc * (u * dt)

    def gyro_int(u):
        tau = u * dt
        return np.array([0.0, 0.0, w0 * tau + 0.5 * alpha * tau * tau])

    return pose, velo, gyro_int


def truth_buffer(t_start, pose, velo, gyro_int, n=40, pad=0.02, dt=0.1):
    """tests/test_imu_deskew.py's ideal AHRS + dead-reckoner buffer over
    one sweep, as numpy leaves (time, att, velo, shift, ang, ptr, count)
    of the ring (QUE_LEN slots)."""
    from lego_loam_tpu_torch.models.imu import QUE_LEN, ImuBuffer

    ts = np.linspace(t_start - pad, t_start + dt + pad, n)
    time = np.full((QUE_LEN,), -np.inf, np.float32)
    att = np.tile(np.eye(3, dtype=np.float32), (QUE_LEN, 1, 1))
    vel = np.zeros((QUE_LEN, 3), np.float32)
    shf = np.zeros((QUE_LEN, 3), np.float32)
    ang = np.zeros((QUE_LEN, 3), np.float32)
    for i, t in enumerate(ts):
        u = (t - t_start) / dt
        R, p = pose(u)
        time[i], att[i], vel[i], shf[i], ang[i] = t, R, velo(u), p, gyro_int(u)
    return ImuBuffer(time, att, vel, shf, ang, np.int32(len(ts) - 1),
                     np.int32(len(ts)))


# bench.py's fast-yaw de-skew course: a 6 m circle at 0.45 m a scan (4.3
# deg of yaw a scan) in world seed 3, each sweep cast along its in-sweep
# motion with 2 cm range noise (seed 7000 + k), and an ideal AHRS and
# accelerometer at 10 samples a sweep
FAST_YAW_RADIUS, FAST_YAW_SPEED, FAST_YAW_IMU_PER_SCAN = 6.0, 0.45, 10


def fast_yaw_pose(k: float):
    """World pose at scan k (fractional k: inside the sweep)."""
    a = FAST_YAW_SPEED * k / FAST_YAW_RADIUS
    return yaw_R(a), np.array([FAST_YAW_RADIUS * np.sin(a),
                               FAST_YAW_RADIUS * (1 - np.cos(a)), 1.6])


def fast_yaw_course(sensor, n: int):
    """(poses, scans, stamps) of the first n scans: scan k sweeps from pose
    k to pose k + 1 and is stamped k * scan_period."""
    world = syn.default_world(seed=3)
    poses = [fast_yaw_pose(k) for k in range(n + 1)]
    scans = [syn.raycast_swept(world, *poses[k], *poses[k + 1], sensor,
                               noise=0.02, rng=np.random.default_rng(7000 + k))
             for k in range(n)]
    return poses[:n], scans, [k * sensor.scan_period for k in range(n)]


def fast_yaw_imu(k: int, dt: float = 0.1):
    """The IMU samples (t, att_R, acc_body, gyro) covering sweep k, pushed
    before the scan: constant-speed circular motion, so the specific force
    is the centripetal acceleration plus the gravity reaction (the port's
    GRAVITY: bench.py's 9.80665 is a quirk not copied, ROADMAP C)."""
    from lego_loam_tpu_torch.models.imu import GRAVITY

    wz = FAST_YAW_SPEED / FAST_YAW_RADIUS / dt
    out = []
    for j in range(FAST_YAW_IMU_PER_SCAN):
        u = k + j / FAST_YAW_IMU_PER_SCAN
        R, _ = fast_yaw_pose(u)
        a = FAST_YAW_SPEED * u / FAST_YAW_RADIUS
        a_w = (FAST_YAW_SPEED / dt) ** 2 / FAST_YAW_RADIUS * np.array(
            [-np.sin(a), np.cos(a), 0.0])
        acc_body = R.T @ (a_w + np.array([0.0, 0.0, GRAVITY]))
        out.append((u * dt, R, acc_body, np.array([0.0, 0.0, wz])))
    return out


def aligned_ate(est, gt) -> float:
    """ATE RMSE (m) of (N, 3) positions after the rigid least-squares
    (Umeyama) alignment of est onto gt, which bench.py reports for its
    de-skew trio: the port's utils.metrics.ate_rmse."""
    return ate_rmse(est, gt)


def quat_from_mat(R) -> np.ndarray:
    """(3, 3) rotation -> [x, y, z, w] unit quaternion (sensor_msgs/Imu
    orientation), the inverse of io/rosbag.quat_to_mat."""
    R = np.asarray(R, np.float64)
    tr = np.trace(R)
    if tr > 0.0:
        w = np.sqrt(1.0 + tr) / 2.0
        x, y, z = (R[2, 1] - R[1, 2]) / (4 * w), (R[0, 2] - R[2, 0]) / (4 * w), \
            (R[1, 0] - R[0, 1]) / (4 * w)
    else:
        i = int(np.argmax(np.diag(R)))
        j, k = (i + 1) % 3, (i + 2) % 3
        q = np.empty(3)
        q[i] = np.sqrt(1.0 + R[i, i] - R[j, j] - R[k, k]) / 2.0
        q[j] = (R[j, i] + R[i, j]) / (4 * q[i])
        q[k] = (R[k, i] + R[i, k]) / (4 * q[i])
        w = (R[k, j] - R[j, k]) / (4 * q[i])
        x, y, z = q
    return np.array([x, y, z, w])


def write_imu_bag(path: str, scans, stamps, imu, scan_period: float) -> None:
    """A ROS bag of a course, laid out as a recorded drive: for each scan,
    its IMU samples (/imu/data, orientation as a quaternion), then the
    cloud of its valid points with their rings (/velodyne_points, stamped
    at the sweep start, recorded at the sweep end)."""
    from tests import rosbag_writer as bw

    msgs = []
    for (xyz, valid, ring), t, samples in zip(scans, stamps, imu):
        for ti, R, acc, gyro in samples:
            msgs.append(("/imu/data", "sensor_msgs/Imu", ti,
                         bw.encode_imu(ti, quat_from_mat(R), gyro, acc)))
        msgs.append(("/velodyne_points", "sensor_msgs/PointCloud2", t + scan_period,
                     bw.encode_pointcloud2(t, xyz[valid], ring[valid].astype(np.uint16))))
    bw.write_bag(path, msgs)


# ---------------------------------------------------------------- KITTI

# KITTI odometry sequence 00's Tr (cam0 <- velo) calibration line, as
# tests/test_kitti_fixture.py writes it
TR_KITTI00 = (
    "Tr: 4.276802385584e-04 -9.999672484946e-01 -8.084491683471e-03 "
    "-1.198459927713e-02 -7.210626507497e-03 8.081198471645e-03 "
    "-9.999413164504e-01 -5.403984729748e-02 9.999738645903e-01 "
    "4.859485810390e-04 -7.206933692422e-03 -2.921968648686e-01"
)


def write_kitti_sequence(root: str, scans, poses) -> str:
    """A KITTI odometry sequence directory of a course: velodyne/<k>.bin
    with each scan's valid points as float32 x, y, z, reflectance (0),
    calib.txt with TR_KITTI00, and poses.txt with the course's velodyne
    poses (R, t) as KITTI's T_w_cam0 rows.  Returns the poses file."""
    velo = os.path.join(root, "velodyne")
    os.makedirs(velo, exist_ok=True)
    for k, (xyz, valid, _ring) in enumerate(scans):
        pts = np.zeros((int(valid.sum()), 4), np.float32)
        pts[:, :3] = xyz[valid]
        pts.tofile(os.path.join(velo, f"{k:06d}.bin"))
    with open(os.path.join(root, "calib.txt"), "w") as f:
        f.write(f"{TR_KITTI00}\n")
    Tr = np.eye(4)
    Tr[:3] = np.array([float(x) for x in TR_KITTI00.split()[1:]]).reshape(3, 4)
    rows = []
    for R, t in poses:
        T = np.eye(4)
        T[:3, :3], T[:3, 3] = R, t
        rows.append((T @ np.linalg.inv(Tr))[:3].reshape(12))
    path = os.path.join(root, "poses.txt")
    np.savetxt(path, np.stack(rows))
    return path


# ---------------------------------------------------------------- E1

def _rotation(rng, n: int) -> np.ndarray:
    q, r = np.linalg.qr(rng.normal(size=(n, n)))
    return q * np.sign(np.diag(r))


def _sym32(H) -> np.ndarray:
    """float64 H symmetrised, then rounded to float32 (exactly symmetric)."""
    return (0.5 * (H + H.T)).astype(np.float32)


def eig6_spectra(thresh: float, seed: int = 0, n: int = 6) -> list:
    """(name, H) pairs of symmetric (n, n) float32 systems, n = 6 or 3, for
    the degeneracy projection at `thresh`, each with every eigenvalue at
    least 20 % of thresh away from it (so float32 and float64 eigen-solvers
    take the same keep mask): spectra across the threshold, all kept, all
    dropped, repeated eigenvalues on either side, a rank-one system, the
    odometry's block system with one block masked to exact zeros (at 3x3:
    a 2x2 block and a zero row and column), a zero matrix and Gram matrices
    J^T J of random constraint rows.  A 3x3 spectrum is the 6x6 one's
    entries 0, 2 and 5 (3 and 5 for repeated_across)."""
    rng = np.random.default_rng(seed)
    out = []
    for name, lam in (
            ("across", [0.05, 0.2, 0.7, 4.0, 30.0, 200.0]),
            ("all_kept", [1.5, 5.0, 10.0, 100.0, 1e3, 3e3]),
            ("all_dropped", [0.0, 1e-4, 0.01, 0.1, 0.3, 0.8]),
            ("repeated_kept", [5.0, 5.0, 5.0, 0.1, 0.1, 0.1]),
            ("repeated_across", [0.3, 0.3, 40.0, 40.0, 40.0, 40.0]),
            ("rank_one", [0.0, 0.0, 0.0, 0.0, 0.0, 50.0])):
        if n == 3:
            lam = [lam[i] for i in ((0, 3, 5) if name == "repeated_across"
                                    else (0, 2, 5))]
        Q = _rotation(rng, n)
        out.append((name, _sym32(Q @ np.diag(np.asarray(lam) * thresh) @ Q.T)))
    # block mode: surf rows fill (pitch, roll, tz) = columns 0, 1, 5, and
    # no corner constraint survives, so rows / columns 2-4 are exact zeros
    blk = np.zeros((n, n))
    kept = [0, 1, 5] if n == 6 else [0, 2]
    Q = _rotation(rng, len(kept))
    blk[np.ix_(kept, kept)] = Q @ np.diag([2.0, 20.0, 90.0][-len(kept):]) @ Q.T * thresh
    out.append(("block_masked", _sym32(blk)))
    out.append(("zero", np.zeros((n, n), np.float32)))
    for k in range(3):
        J = rng.normal(size=(64, n)) * rng.uniform(0.05, 1.5, size=n)
        H = J.T @ J
        lam = np.linalg.eigvalsh(H)
        # keep the Gram spectra off the threshold too: rescale so that the
        # eigenvalue nearest it sits at 1.5x or 0.5x of it
        near = lam[np.argmin(np.abs(np.log(np.maximum(lam, 1e-30) / thresh)))]
        H = H * (thresh * (1.5 if near >= thresh else 0.5) / near)
        out.append((f"gram_{k}", _sym32(H)))
    return out


# ---------------------------------------------------------------- A20

# tests/test_robustness.py's CFG overrides (config_for("vlp16", **ROBUST))
ROBUST = dict(deskew=False, max_keyframes=32, max_map_corner=1024,
              max_map_surf=4096, kf_corner_cap=256, kf_surf_cap=1024,
              kf_outlier_cap=256, max_scan_corner_ds=256, max_scan_surf_ds=1024,
              nn_query_tile=256)
# its four tests, one course each
ROBUST_COURSES = ("empty_and_sparse", "nan_and_extreme", "identical_repeated",
                  "garbage_then_recovery")
IDENTICAL_BOUND = 0.02   # m, test_identical_repeated_scans' displacement bound


def robustness_course(name: str, sensor) -> list:
    """The scans of one of tests/test_robustness.py's tests, in its order,
    as (xyz, valid, ring, t) with t None where the test passes no stamp
    (process_scan then stamps frame * scan_period):

      * empty_and_sparse: an all-invalid scan, one valid point, 50 random
        points (seed 0);
      * nan_and_extreme: the same scan twice (seed 1): every 7th point NaN
        and invalid (then zeroed), every 7th from the 2nd at 1e8 m and
        valid (the range gate must drop it);
      * identical_repeated: one noiseless scan of world seed 2 from the
        origin, four times (zero motion);
      * garbage_then_recovery: world seed 3 on a 6-pose 8 m arc of 0.15 pi:
        poses 0-1, two all-invalid scans, poses 2-5."""
    P = sensor.n_scan * sensor.horizon_scan
    ring = (np.arange(P) % sensor.n_scan).astype(np.int32)
    empty = (np.zeros((P, 3), np.float32), np.zeros(P, bool), ring)
    if name == "empty_and_sparse":
        rng = np.random.default_rng(0)
        one = np.zeros((P, 3), np.float32)
        one[0] = [5.0, 1.0, 0.2]
        one_valid = np.zeros(P, bool)
        one_valid[0] = True
        fifty = np.zeros((P, 3), np.float32)
        fifty[:50] = rng.uniform(-20, 20, (50, 3))
        fifty_valid = np.zeros(P, bool)
        fifty_valid[:50] = True
        return [empty + (None,), (one, one_valid, ring, None),
                (fifty, fifty_valid, ring, None)]
    if name == "nan_and_extreme":
        rng = np.random.default_rng(1)
        xyz = rng.uniform(-30, 30, (P, 3)).astype(np.float32)
        xyz[::7] = np.nan
        xyz[1::7] = 1e8
        valid = np.ones(P, bool)
        valid[::7] = False
        xyz = np.where(valid[:, None], xyz, 0.0).astype(np.float32)
        return [(xyz, valid, ring, 0.1 * k) for k in range(2)]
    if name == "identical_repeated":
        xyz, valid, r = syn.raycast(syn.default_world(seed=2), np.eye(3),
                                    np.array([0.0, 0.0, 1.6]), sensor)
        return [(xyz, valid, r, 0.1 * k) for k in range(4)]
    if name == "garbage_then_recovery":
        world = syn.default_world(seed=3)
        poses = syn.circle_trajectory(6, radius=8.0, arc=0.15 * np.pi)
        good = [syn.raycast(world, *poses[k], sensor) for k in range(6)]
        return ([good[k] + (0.1 * k,) for k in range(2)]
                + [empty + (0.2 + 0.1 * k,) for k in range(2)]
                + [good[k] + (0.2 + 0.1 * k,) for k in range(2, 6)])
    raise ValueError(f"unknown robustness course {name!r}")


# tests/test_loop_robustness.py: the keyframe 0 pose in the world (the map
# origin), the landmark boxes of its capped corridor, and its _cfg
CORRIDOR_START = np.array([2.0, 0.0, 1.6])
CORRIDOR_LANDMARKS = np.array([
    [6.0, 1.2, 0.0, 7.6, 2.6, 2.4],      # cabinet against the +y wall
    [10.5, -2.6, 0.0, 11.3, -1.4, 1.8],  # crate against the -y wall
])
CORRIDOR_REVISIT_X = 8.0


def loop_robust_cfg(**over) -> dict:
    """tests/test_loop_robustness.py's _cfg(**over) overrides (VLP-16, loop
    closure on, the reference's 100 ICP iterations, honest corridor
    odometry noise in the pose graph)."""
    over.setdefault("loop_icp_iters", 100)
    return dict(max_keyframes=32, kf_corner_cap=256, kf_surf_cap=4096,
                kf_outlier_cap=256, max_map_corner=2048, max_map_surf=16384,
                nn_query_tile=1024, loop_closure_enabled=True,
                pg_trans_sigma=0.1, pg_rot_sigma=0.01, **over)


def corridor_world(landmarks: bool):
    """The open 300 m corridor without end caps, or the 40 m capped one
    with the landmark boxes."""
    if landmarks:
        return syn.corridor_world(landmarks=CORRIDOR_LANDMARKS, length=40.0)
    return syn.corridor_world(length=300.0, end_caps=False)


def corridor_out_and_back(drift_x: float, far_x: float = 14.0,
                          revisit_x: float = CORRIDOR_REVISIT_X):
    """_out_and_back: the first pass at world x = 2..far every 0.5 m
    (estimate exact), then a return to world x = revisit_x with the
    estimate drifted drift_x along the axis; (true_world, est_map, times),
    map frame = world minus CORRIDOR_START; the return stamped 40 s after
    the last first-pass keyframe."""
    true_world, est_map, times = [], [], []
    for i, x in enumerate(np.arange(CORRIDOR_START[0], far_x + 0.25, 0.5)):
        w = np.array([x, 0.0, CORRIDOR_START[2]])
        true_world.append((np.eye(3), w))
        est_map.append((np.eye(3), w - CORRIDOR_START))
        times.append(float(i))
    w = np.array([revisit_x, 0.0, CORRIDOR_START[2]])
    true_world.append((np.eye(3), w))
    est_map.append((np.eye(3), w - CORRIDOR_START + np.array([drift_x, 0.0, 0.0])))
    times.append(times[-1] + 40.0)
    return true_world, est_map, times


def corridor_clouds(cfg, world, true_world, noise: float = 0.01) -> list:
    """Each keyframe's raycast at its true world pose (seed 900 + k), as
    _make_state casts them: (xyz, valid) host arrays."""
    out = []
    for k, (Rt, tt) in enumerate(true_world):
        xyz, valid, _ = syn.raycast(world, Rt, tt, cfg.sensor, noise=noise,
                                    rng=np.random.default_rng(900 + k))
        out.append((xyz, valid))
    return out


def corridor_state(cfg, clouds, est_map, times, device):
    """_make_state with the port: a MappingState on `device` whose keyframe
    surf blocks are the port's voxel_downsample of the clouds captured at
    the true poses, while the keyframe poses and chain measurements carry
    the estimate's drift; aft_mapped is the last estimate."""
    import torch

    from lego_loam_tpu_torch.models import mapping as mp
    from lego_loam_tpu_torch.ops.voxel import voxel_downsample
    from lego_loam_tpu_torch.utils.math3d import Pose

    assert np.allclose(est_map[0][1], 0.0)
    state = mp.init_state(cfg, device)
    kf_R = state.kf_R.cpu().numpy()
    kf_t = state.kf_t.cpu().numpy()
    meas_R = state.kf_meas_R.cpu().numpy()
    meas_t = state.kf_meas_t.cpu().numpy()
    kf_time = state.kf_time.cpu().numpy()
    kf_surf, kf_surf_valid = state.kf_surf.clone(), state.kf_surf_valid.clone()
    for k, (xyz, valid) in enumerate(clouds):
        pts, ok = voxel_downsample(torch.as_tensor(xyz, device=device),
                                   torch.as_tensor(valid, device=device),
                                   cfg.leaf_scan_surf, cfg.kf_surf_cap)
        kf_surf[k], kf_surf_valid[k] = pts, ok
        Re, te = est_map[k]
        kf_R[k], kf_t[k] = Re, te
        kf_time[k] = times[k]
        if k > 0:
            Rp, tp = est_map[k - 1]
            meas_R[k] = Rp.T @ Re
            meas_t[k] = Rp.T @ (te - tp)

    def dev32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    return state._replace(
        kf_R=dev32(kf_R), kf_t=dev32(kf_t), kf_surf=kf_surf,
        kf_surf_valid=kf_surf_valid, kf_meas_R=dev32(meas_R),
        kf_meas_t=dev32(meas_t), kf_time=dev32(kf_time),
        n_kf=torch.tensor(len(clouds), dtype=torch.int32, device=device),
        aft_mapped=Pose(dev32(est_map[-1][0]), dev32(est_map[-1][1])))


# the three corridor cases of tests/test_loop_robustness.py: (name, landmark
# world, drift along the axis, config overrides)
CORRIDOR_CASES = (("open_corridor", False, 1.5, {}),
                  ("landmark_revisit", True, 1.5, {}),
                  ("drift_gate", True, 3.5, {}),
                  ("drift_gate_raised", True, 3.5, dict(loop_drift_frac=0.5)))

def corridor_gate_faults(name: str, cfg, res, kf_t_before, new_state, n: int) -> list:
    """tests/test_loop_robustness.py's assertions on one loop check of the
    CORRIDOR_CASES case `name` (res a LoopResult, new_state the state
    after it, kf_t_before the keyframe positions before, n keyframes), as
    a list of the ones that fail."""
    drift = {c[0]: c[2] for c in CORRIDOR_CASES}[name]
    fitness, obs, closed = float(res.fitness), float(res.obs_ratio), bool(res.closed)
    def host(a):
        return np.asarray(a.cpu() if hasattr(a, "cpu") else a)

    kf_t = host(new_state.kf_t)
    x_corr = float(kf_t[n - 1, 0])
    x_true = CORRIDOR_REVISIT_X - CORRIDOR_START[0]
    checks = {"the fit is tight": fitness < cfg.history_keyframe_fitness_score,
              "no loop edge": int(new_state.n_loops) == 0}
    if name == "open_corridor":
        checks.update({"obs_ratio exposes the slip axis": obs < cfg.loop_degen_eig_frac,
                       "rejected": not closed,
                       "keyframes untouched": np.array_equal(kf_t, host(kf_t_before))})
    elif name == "drift_gate":
        checks.update({"ICP recovers most of the offset": float(res.drift) > 2.5,
                       "rejected": not closed})
    else:
        checks = {"closed": closed,
                  "the revisit moves back": abs(x_corr - x_true) < 0.5 * drift}
        if name == "landmark_revisit":
            checks["landmarks pin x"] = obs >= cfg.loop_degen_eig_frac
    return [f"{name}: not {what} (fitness {fitness:.4f}, drift {float(res.drift):.3f}, "
            f"obs_ratio {obs:.4f}, closed {closed}, corrected x {x_corr:.3f})"
            for what, ok in checks.items() if not ok]


# tests/test_stress.py's CFG overrides, its corridor (50 scans at 0.8 m down
# a 300 m corridor with poles every 12 m) and fast-yaw (40 scans, a full
# turn on a 4 m circle) courses, 2 cm range noise (seed = seed0 + index)
STRESS = dict(deskew=False, max_keyframes=128, max_map_corner=4096,
              max_map_surf=16384, kf_corner_cap=512, kf_surf_cap=2048,
              kf_outlier_cap=512, max_scan_corner_ds=512, max_scan_surf_ds=2048,
              nn_query_tile=512)
STRESS_CORRIDOR_N, STRESS_CORRIDOR_STEP = 50, 0.8
STRESS_YAW_N = 40
# its bounds: the corridor's lateral / vertical (m) and along-axis (a
# fraction of the path), the fast-yaw ATE and final error (m)
STRESS_LAT, STRESS_VERT, STRESS_ALONG_FRAC = 0.15, 0.15, 0.05
STRESS_YAW_ATE, STRESS_YAW_FINAL = 0.25, 0.35


def stress_corridor():
    """(world, poses) of test_corridor_degenerate_geometry_bounded_drift."""
    world = syn.corridor_world(length=300.0, pole_period=12.0, end_caps=False)
    return world, syn.straight_trajectory(STRESS_CORRIDOR_N, start=2.0,
                                          step=STRESS_CORRIDOR_STEP)


def stress_fast_yaw():
    """(world, poses) of test_fast_yaw_high_dynamics."""
    poses = []
    for k in range(STRESS_YAW_N):
        a = 2.0 * np.pi * k / STRESS_YAW_N
        poses.append((yaw_R(a), np.array([4.0 * np.sin(a), 4.0 * (1 - np.cos(a)),
                                          1.6])))
    return syn.default_world(seed=3), poses


def stress_scans(world, poses, sensor, noise: float = 0.02, seed0: int = 0):
    """test_stress.py's _run scans: (xyz, valid, ring) a pose."""
    return [syn.raycast(world, R, t, sensor, noise=noise,
                        rng=np.random.default_rng(seed0 + k))
            for k, (R, t) in enumerate(poses)]


def stress_errors(traj, poses) -> dict:
    """test_stress.py's measures of a trajectory (N, 3) in the first
    pose's frame (the courses start unrotated) against the course: the
    largest lateral (y), vertical (z) and along-axis (x) errors, the ATE
    and the final error (m)."""
    traj = np.asarray(traj, np.float64)
    gt = np.asarray([t for (_, t) in poses]) - poses[0][1]
    err = traj - gt
    return {"lat": float(np.abs(err[:, 1]).max()),
            "vert": float(np.abs(err[:, 2]).max()),
            "along": float(np.abs(err[:, 0]).max()),
            "ate": float(np.sqrt(np.mean(np.sum(err ** 2, axis=1)))),
            "final": float(np.linalg.norm(err[-1])),
            "finite": bool(np.isfinite(traj).all())}
