"""Analytic lidar raycasting in PyTorch, on whatever device the tensors are.

A copy of the port's host NumPy generator (``lego_loam_tpu_torch/io/
synthetic.py``: ``default_world``, ``ray_directions``, ``_trace``,
``raycast``) rewritten to cast many scans in a few large tensor calls, so
that a fleet's inputs are cast on the card during set-up.  With no range
noise it casts the generator's scans to float32 rounding
(``slam_bench/tests/test_bench_raycast.py``); the noise comes from a
``torch.Generator`` instead of NumPy's.  It imports nothing of the port.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class Sensor:
    """The lidar geometry the caster needs (the port's SensorSpec fields)."""

    n_scan: int
    horizon_scan: int
    ang_res_x: float
    ang_res_y: float
    ang_bottom: float
    min_range: float
    max_range: float


@dataclass
class World:
    ground_z: float
    boxes: np.ndarray        # (B, 6): xmin, ymin, zmin, xmax, ymax, zmax
    cylinders: np.ndarray    # (C, 4): cx, cy, radius, height


def default_world(seed: int = 0) -> World:
    """The courtyard of the port's generator: four walls, some interior
    boxes, a grid of poles (the same NumPy draws, so the same world)."""
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
            continue
        w, d = rng.uniform(1.5, 5.0, 2)
        h = rng.uniform(1.0, 3.5)
        boxes.append([cx - w / 2, cy - d / 2, 0.0, cx + w / 2, cy + d / 2, h])
    cyl = []
    for _ in range(14):
        cx, cy = rng.uniform(-36, 36, 2)
        if abs(cx) < 5 and abs(cy) < 5:
            continue
        cyl.append([cx, cy, rng.uniform(0.12, 0.4), rng.uniform(2.0, 5.0)])
    return World(0.0, np.concatenate([walls, np.asarray(boxes)], axis=0),
                 np.asarray(cyl) if cyl else np.zeros((0, 4)))


def ray_directions(sensor: Sensor, device) -> torch.Tensor:
    """(n_scan * horizon_scan, 3) float64 unit directions, row-major: row r
    at elevation -ang_bottom + r * ang_res_y, column c at azimuth
    (c - H/2) * ang_res_x."""
    R, H = sensor.n_scan, sensor.horizon_scan
    elev = torch.deg2rad(-sensor.ang_bottom + torch.arange(
        R, dtype=torch.float64, device=device) * sensor.ang_res_y)
    azim = torch.deg2rad((torch.arange(H, dtype=torch.float64, device=device)
                          - H // 2) * sensor.ang_res_x)
    ce, se = torch.cos(elev)[:, None], torch.sin(elev)[:, None]
    ca, sa = torch.cos(azim)[None, :], torch.sin(azim)[None, :]
    return torch.stack([ce * ca, ce * sa, se.expand(R, H)], -1).reshape(-1, 3)


def trace(world: World, o: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Nearest-hit ray parameter (inf where nothing is hit) for origins o
    (..., 3) and directions d (..., 3), float64."""
    inf = torch.full(d.shape[:-1], math.inf, dtype=d.dtype, device=d.device)
    best = inf
    dz = d[..., 2]
    s = (world.ground_z - o[..., 2]) / dz
    best = torch.where((dz < -1e-9) & (s > 0) & (s < best), s, best)
    for b in world.boxes:
        bmin = torch.as_tensor(b[:3], dtype=d.dtype, device=d.device)
        bmax = torch.as_tensor(b[3:], dtype=d.dtype, device=d.device)
        t1 = (bmin - o) / d
        t2 = (bmax - o) / d
        lo, hi = torch.minimum(t1, t2), torch.maximum(t1, t2)
        # NaN (0/0) drops out of the max / min, as NumPy's nanmax / nanmin
        tn = torch.where(lo.isnan(), -math.inf, lo).amax(-1)
        tf = torch.where(hi.isnan(), math.inf, hi).amin(-1)
        hit = (tn <= tf) & (tf > 0) & (tn > 1e-6)
        best = torch.where(hit & (tn < best), tn, best)
    for cx, cy, rad, h in world.cylinders:
        ox, oy = o[..., 0] - cx, o[..., 1] - cy
        a = d[..., 0] ** 2 + d[..., 1] ** 2
        bq = 2 * (ox * d[..., 0] + oy * d[..., 1])
        cq = ox * ox + oy * oy - rad * rad
        disc = bq * bq - 4 * a * cq
        ok = (disc > 0) & (a > 1e-12)
        s = (-bq - torch.sqrt(disc.clamp(min=0.0))) / (2 * a).clamp(min=1e-12)
        z = o[..., 2] + s * d[..., 2]
        hit = ok & (s > 1e-6) & (z >= world.ground_z) & (z <= world.ground_z + h)
        best = torch.where(hit & (s < best), s, best)
    return best


def raycast(world: World, R: torch.Tensor, t: torch.Tensor, sensor: Sensor,
            noise: float = 0.0, gen: torch.Generator | None = None,
            mid_row: bool = False):
    """Cast S scans from world poses R (S, 3, 3), t (S, 3) (float64, on the
    device to cast on).  Returns xyz (S, N, 3) float32 in the sensor frame,
    valid (S, N) bool, ring (N,) int32, N = n_scan * horizon_scan, row-major.
    Rays that hit nothing or land outside [min_range, max_range] are
    invalid, at the origin.  `noise` is the range noise's standard
    deviation (m), drawn from `gen`.  With `mid_row`, each point is moved
    half an elevation row up, range and azimuth kept (a sensor whose rows
    come from elevation math then never sees a point on a row boundary)."""
    d_sensor = ray_directions(sensor, R.device)                 # (N, 3)
    d = torch.einsum("sij,nj->sni", R, d_sensor)
    o = t[:, None, :].expand_as(d)
    s = trace(world, o, d)
    valid = s.isfinite() & (s >= sensor.min_range) & (s <= sensor.max_range)
    if noise > 0.0:
        s = s + torch.randn(s.shape, generator=gen, dtype=s.dtype,
                            device=s.device) * noise * valid
    s = torch.where(valid, s, 0.0)
    xyz = (s[..., None] * d_sensor).to(torch.float32)
    if mid_row:
        xyz = move_mid_row(xyz, sensor)
    ring = torch.arange(sensor.n_scan, dtype=torch.int32, device=R.device
                        ).repeat_interleave(sensor.horizon_scan)
    return xyz, valid, ring


def move_mid_row(xyz: torch.Tensor, sensor: Sensor) -> torch.Tensor:
    """Each float32 point moved half an elevation row up in float64, range
    and azimuth kept."""
    p = xyz.to(torch.float64)
    rho = torch.hypot(p[..., 0], p[..., 1])
    rng = torch.hypot(rho, p[..., 2])
    el = torch.atan2(p[..., 2], rho) + math.radians(0.5 * sensor.ang_res_y)
    az = torch.atan2(p[..., 1], p[..., 0])
    return torch.stack([rng * torch.cos(el) * torch.cos(az),
                        rng * torch.cos(el) * torch.sin(az),
                        rng * torch.sin(el)], -1).to(torch.float32)
