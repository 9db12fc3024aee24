"""Synthetic lidar world: analytic raycasting with exact ground truth.

A jax-free copy of the scan generator in ``lego_loam_tpu.io.synthetic``
(``default_world``, ``corridor_world``, ``circle_trajectory``,
``straight_trajectory``, ``raycast`` and the motion-distorted
``raycast_swept`` / ``raycast_swept_profile``), so the port can make its
test and smoke-run scans without importing the JAX package.  ``raycast``
casts byte-identical scans (``tests/test_torch_import.py`` checks); the
swept casts interpolate rotations with the port's float32 SO(3) maps where
the JAX package uses its own, so they agree to float32 rounding
(``tests/test_torch_io.py``).

Host-side NumPy: this feeds the device pipeline, it is not on the hot path.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from lego_loam_tpu_torch.config import SensorSpec
from lego_loam_tpu_torch.utils.math3d import so3_exp, so3_log


@dataclass
class World:
    ground_z: float = 0.0
    # (B, 6): xmin, ymin, zmin, xmax, ymax, zmax
    boxes: np.ndarray = field(default_factory=lambda: np.zeros((0, 6), np.float64))
    # (C, 4): cx, cy, radius, height (from ground_z up)
    cylinders: np.ndarray = field(default_factory=lambda: np.zeros((0, 4), np.float64))


def default_world(seed: int = 0) -> World:
    """A courtyard: four walls, some interior boxes, a grid of poles."""
    rng = np.random.default_rng(seed)
    walls = np.array([
        [-42.0, -42.0, 0.0, 42.0, -40.0, 4.0],
        [-42.0, 40.0, 0.0, 42.0, 42.0, 4.0],
        [-42.0, -42.0, 0.0, -40.0, 42.0, 4.0],
        [40.0, -42.0, 0.0, 42.0, 42.0, 4.0],
    ])
    boxes = []
    for _ in range(10):
        cx, cy = rng.uniform(-32, 32, 2)
        if abs(cx) < 6 and abs(cy) < 6:
            continue  # keep the start area clear
        w, d = rng.uniform(1.5, 5.0, 2)
        h = rng.uniform(1.0, 3.5)
        boxes.append([cx - w / 2, cy - d / 2, 0.0, cx + w / 2, cy + d / 2, h])
    cyl = []
    for _ in range(14):
        cx, cy = rng.uniform(-36, 36, 2)
        if abs(cx) < 5 and abs(cy) < 5:
            continue
        cyl.append([cx, cy, rng.uniform(0.12, 0.4), rng.uniform(2.0, 5.0)])
    return World(
        ground_z=0.0,
        boxes=np.concatenate([walls, np.asarray(boxes)], axis=0),
        cylinders=np.asarray(cyl) if cyl else np.zeros((0, 4)),
    )


def corridor_world(length: float = 120.0, width: float = 6.0,
                   wall_h: float = 4.0, landmarks: np.ndarray | None = None,
                   pole_period: float = 0.0, end_caps: bool = True) -> World:
    """A straight corridor along +x: two smooth walls + ground.

    Degenerate-geometry fixture: nothing pins translation along x.
    Optional extras re-introduce x information: `landmarks`, (B, 6) extra
    boxes; `pole_period` > 0, identical poles every pole_period metres on
    both walls (locally full rank, globally ambiguous modulo the period);
    `end_caps`, walls closing both ends (a distant x observation)."""
    y0 = width / 2.0
    boxes = [
        [-5.0, y0, 0.0, length, y0 + 2.0, wall_h],
        [-5.0, -y0 - 2.0, 0.0, length, -y0, wall_h],
    ]
    if end_caps:
        boxes += [
            [length, -y0 - 2.0, 0.0, length + 2.0, y0 + 2.0, wall_h],
            [-7.0, -y0 - 2.0, 0.0, -5.0, y0 + 2.0, wall_h],
        ]
    if landmarks is not None:
        boxes.extend(np.asarray(landmarks, np.float64).tolist())
    cyl = []
    if pole_period > 0.0:
        for x in np.arange(0.0, length, pole_period):
            cyl.append([x, y0 - 0.3, 0.18, 2.5])
            cyl.append([x + pole_period / 2.0, -y0 + 0.3, 0.18, 2.5])
    return World(
        ground_z=0.0,
        boxes=np.asarray(boxes),
        cylinders=np.asarray(cyl) if cyl else np.zeros((0, 4)),
    )


def straight_trajectory(n: int, start: float = 0.0, step: float = 0.25,
                        height: float = 1.6, y: float = 0.0):
    """Poses walking straight down +x (for corridor worlds)."""
    poses = []
    for k in range(n):
        t = np.array([start + k * step, y, height])
        poses.append((np.eye(3), t))
    return poses


def ray_directions(sensor: SensorSpec) -> np.ndarray:
    """(n_scan, horizon_scan, 3) unit directions in the sensor frame.

    Column c maps to azimuth (c - H/2) * ang_res_x so that the projection
    kernel lands each return exactly back on (row, col).
    """
    R, H = sensor.n_scan, sensor.horizon_scan
    elev = np.radians(-sensor.ang_bottom + np.arange(R) * sensor.ang_res_y)
    azim = np.radians((np.arange(H) - H // 2) * sensor.ang_res_x)
    ce, se = np.cos(elev)[:, None], np.sin(elev)[:, None]
    ca, sa = np.cos(azim)[None, :], np.sin(azim)[None, :]
    return np.stack([ce * ca, ce * sa, np.broadcast_to(se, (R, H))], axis=-1)


def _trace(world: World, o: np.ndarray, d: np.ndarray) -> np.ndarray:
    """Nearest-hit ray parameter for per-ray origins o and directions d."""
    s_best = np.full(d.shape[0], np.inf)

    # ground plane
    dz = d[:, 2]
    with np.errstate(divide="ignore", invalid="ignore"):
        s = (world.ground_z - o[:, 2]) / dz
    hit = (dz < -1e-9) & (s > 0)
    s_best = np.where(hit & (s < s_best), s, s_best)

    # boxes (slab method)
    for b in world.boxes:
        bmin, bmax = b[:3], b[3:]
        with np.errstate(divide="ignore", invalid="ignore"):
            t1 = (bmin - o) / d
            t2 = (bmax - o) / d
        tn = np.nanmax(np.minimum(t1, t2), axis=1)
        tf = np.nanmin(np.maximum(t1, t2), axis=1)
        hit = (tn <= tf) & (tf > 0) & (tn > 1e-6)
        s_best = np.where(hit & (tn < s_best), tn, s_best)

    # vertical cylinders
    for c in world.cylinders:
        cx, cy, rad, h = c
        ox, oy = o[:, 0] - cx, o[:, 1] - cy
        a = d[:, 0] ** 2 + d[:, 1] ** 2
        bq = 2 * (ox * d[:, 0] + oy * d[:, 1])
        cq = ox * ox + oy * oy - rad * rad
        disc = bq * bq - 4 * a * cq
        ok = (disc > 0) & (a > 1e-12)
        sq = np.sqrt(np.maximum(disc, 0.0))
        s = (-bq - sq) / np.maximum(2 * a, 1e-12)
        z = o[:, 2] + s * d[:, 2]
        hit = ok & (s > 1e-6) & (z >= world.ground_z) & (z <= world.ground_z + h)
        s_best = np.where(hit & (s < s_best), s, s_best)
    return s_best


def raycast(
    world: World,
    R_pose: np.ndarray,
    t_pose: np.ndarray,
    sensor: SensorSpec,
    noise: float = 0.0,
    rng: np.random.Generator | None = None,
):
    """Cast one scan from pose (R_pose, t_pose).

    Returns (xyz (n_scan*horizon_scan, 3) float32 in sensor frame, valid
    (same,) bool, ring (same,) int32).  Rays that hit nothing (or outside
    [min_range, max_range]) are invalid.
    """
    Rg, H = sensor.n_scan, sensor.horizon_scan
    d_sensor = ray_directions(sensor).reshape(-1, 3)
    d = d_sensor @ R_pose.T
    o = np.broadcast_to(np.asarray(t_pose, np.float64), d.shape)
    s_best = _trace(world, o, d)
    valid = np.isfinite(s_best) & (s_best >= sensor.min_range) & (s_best <= sensor.max_range)
    if noise > 0.0:
        rng = rng or np.random.default_rng(0)
        s_best = s_best + rng.normal(0.0, noise, s_best.shape) * valid
    s_best = np.where(valid, s_best, 0.0)
    xyz = (s_best[:, None] * d_sensor).astype(np.float32)
    ring = np.repeat(np.arange(Rg, dtype=np.int32), H)
    return xyz, valid, ring


def raycast_swept(
    world: World,
    R0: np.ndarray, t0: np.ndarray,
    R1: np.ndarray, t1: np.ndarray,
    sensor: SensorSpec,
    noise: float = 0.0,
    rng: np.random.Generator | None = None,
):
    """Cast one motion-distorted sweep with constant-velocity motion from
    (R0, t0) to (R1, t1): each column fires from the geodesic / linear
    interpolated pose at its sweep time."""
    pose_fn = lambda u: (_slerp(R0, R1, u), t0 + u * (t1 - t0))  # noqa: E731
    return raycast_swept_profile(world, pose_fn, sensor, noise=noise, rng=rng)


def raycast_swept_profile(
    world: World,
    pose_fn,
    sensor: SensorSpec,
    noise: float = 0.0,
    rng: np.random.Generator | None = None,
):
    """Cast one motion-distorted sweep along an arbitrary in-sweep pose
    profile: pose_fn(u) -> (R (3,3), t (3,)) is the sensor's world pose at
    sweep fraction u in [0, 1].

    Firing order is time-major, like a real Velodyne stream: emission step
    k fires all rings of column (H - k) mod H (the head turns clockwise),
    so the projection recovers s(c) = ((H - c) mod H) / H exactly.

    Returns (xyz, valid, ring) like raycast, each point in the sensor frame
    at its own sample time: raw distorted data."""
    Rg, H = sensor.n_scan, sensor.horizon_scan
    k = np.arange(H)
    cols = (H - k) % H
    s_frac = k / H
    prof = [pose_fn(u) for u in s_frac]
    poses_R = np.stack([p[0] for p in prof])                 # (H, 3, 3)
    poses_t = np.stack([np.asarray(p[1], np.float64) for p in prof])

    d_sensor = ray_directions(sensor)[:, cols]            # (Rg, H, 3), k-order
    d_world = np.einsum("hij,rhj->rhi", poses_R, d_sensor)
    d_world = np.swapaxes(d_world, 0, 1).reshape(-1, 3)   # (H*Rg, 3), k-major
    o = np.broadcast_to(poses_t[:, None], (H, Rg, 3)).reshape(-1, 3)

    s_best = _trace(world, o, d_world)
    valid = (np.isfinite(s_best) & (s_best >= sensor.min_range)
             & (s_best <= sensor.max_range))
    if noise > 0.0:
        rng = rng or np.random.default_rng(0)
        s_best = s_best + rng.normal(0.0, noise, s_best.shape) * valid
    s_best = np.where(valid, s_best, 0.0)
    d_body = np.swapaxes(d_sensor, 0, 1).reshape(-1, 3)   # instantaneous frame
    xyz = (s_best[:, None] * d_body).astype(np.float32)
    ring = np.tile(np.arange(Rg, dtype=np.int32), H)
    return xyz, valid, ring


def _slerp(R0, R1, u):
    """Geodesic rotation interpolation (host-side; the SO(3) maps in
    float32, as the JAX package evaluates them)."""
    w = so3_log(torch.as_tensor(R0.T @ R1, dtype=torch.float32)).numpy()
    return R0 @ so3_exp(torch.as_tensor(u * w, dtype=torch.float32)).numpy()


def circle_trajectory(n: int, radius: float = 12.0, height: float = 1.6,
                      arc: float = 0.8 * np.pi):
    """Ground-truth poses along a circular arc, heading tangent to the path.

    Returns list of (R (3,3), t (3,)) world poses.
    """
    poses = []
    for k in range(n):
        a = arc * k / max(n - 1, 1)
        t = np.array([radius * np.sin(a), radius * (1 - np.cos(a)), height])
        yaw = a
        c, s = np.cos(yaw), np.sin(yaw)
        R = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
        poses.append((R, t))
    return poses
