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
  * IMU: bench.py's fast-yaw de-skew course (fast_yaw_course,
    fast_yaw_imu), tests/test_imu_deskew.py's in-sweep profiles and truth
    buffers (accel_profile, truth_buffer), bench.py's aligned ATE
    (aligned_ate) and a course written to a ROS bag (write_imu_bag).
  * E1: seeded symmetric 6x6 systems for the degeneracy projection
    (eig6_spectra), every eigenvalue well away from the threshold.

Scans come from the port's raycaster, which casts byte-identical scans to
the JAX package's (tests/test_torch_import.py).
"""

from __future__ import annotations

import numpy as np

from lego_loam_tpu_torch.io import synthetic as syn

SMALL = dict(deskew=False, max_keyframes=64, max_map_corner=2048,
             max_map_surf=8192, kf_corner_cap=512, kf_surf_cap=2048,
             kf_outlier_cap=512, max_scan_corner_ds=512, max_scan_surf_ds=2048,
             nn_query_tile=256, mapping_process_every=2, nn_exact=True)
SLICE_SCANS = 6

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
    (Umeyama) alignment of est onto gt: lego_loam_tpu.utils.metrics.
    ate_rmse, which bench.py reports for its de-skew trio (jax-free copy)."""
    est, gt = np.asarray(est, np.float64), np.asarray(gt, np.float64)
    mu_e, mu_g = est.mean(0), gt.mean(0)
    U, _, Vt = np.linalg.svd((gt - mu_g).T @ (est - mu_e) / est.shape[0])
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    est = est @ R.T + (mu_g - R @ mu_e)
    return float(np.sqrt(np.mean(np.sum((est - gt) ** 2, axis=1))))


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


# ---------------------------------------------------------------- E1

def _rotation(rng, n: int) -> np.ndarray:
    q, r = np.linalg.qr(rng.normal(size=(n, n)))
    return q * np.sign(np.diag(r))


def _sym32(H) -> np.ndarray:
    """float64 H symmetrised, then rounded to float32 (exactly symmetric)."""
    return (0.5 * (H + H.T)).astype(np.float32)


def eig6_spectra(thresh: float, seed: int = 0) -> list:
    """(name, H) pairs of symmetric (6, 6) float32 systems for the
    degeneracy projection at `thresh`, each with every eigenvalue at least
    20 % of thresh away from it (so float32 and float64 eigen-solvers take
    the same keep mask): spectra across the threshold, all kept, all
    dropped, repeated eigenvalues on either side, a rank-one system, the
    odometry's block system with one block masked to exact zeros, a zero
    matrix and Gram matrices J^T J of random constraint rows."""
    rng = np.random.default_rng(seed)
    out = []
    for name, lam in (
            ("across", [0.05, 0.2, 0.7, 4.0, 30.0, 200.0]),
            ("all_kept", [1.5, 5.0, 10.0, 100.0, 1e3, 3e3]),
            ("all_dropped", [0.0, 1e-4, 0.01, 0.1, 0.3, 0.8]),
            ("repeated_kept", [5.0, 5.0, 5.0, 0.1, 0.1, 0.1]),
            ("repeated_across", [0.3, 0.3, 40.0, 40.0, 40.0, 40.0]),
            ("rank_one", [0.0, 0.0, 0.0, 0.0, 0.0, 50.0])):
        Q = _rotation(rng, 6)
        out.append((name, _sym32(Q @ np.diag(np.asarray(lam) * thresh) @ Q.T)))
    # block mode: surf rows fill (pitch, roll, tz) = columns 0, 1, 5, and
    # no corner constraint survives, so rows / columns 2-4 are exact zeros
    blk = np.zeros((6, 6))
    Q = _rotation(rng, 3)
    blk[np.ix_([0, 1, 5], [0, 1, 5])] = Q @ np.diag([2.0, 20.0, 90.0]) @ Q.T * thresh
    out.append(("block_masked", _sym32(blk)))
    out.append(("zero", np.zeros((6, 6), np.float32)))
    for k in range(3):
        J = rng.normal(size=(64, 6)) * rng.uniform(0.05, 1.5, size=6)
        H = J.T @ J
        lam = np.linalg.eigvalsh(H)
        # keep the Gram spectra off the threshold too: rescale so that the
        # eigenvalue nearest it sits at 1.5x or 0.5x of it
        near = lam[np.argmin(np.abs(np.log(np.maximum(lam, 1e-30) / thresh)))]
        H = H * (thresh * (1.5 if near >= thresh else 0.5) / near)
        out.append((f"gram_{k}", _sym32(H)))
    return out
