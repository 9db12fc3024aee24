"""The fleet replay's inputs, from a traffic mix's parameters and a seed.

One general generator for every mix (``slam_bench/traffic/<name>.json``):

* a bank of K closed courses of L scans each, cast on the device in
  set-up: course k is a circle of radius step * L / (2 pi) about
  ``courses[k] = [cx, cy, direction]`` in the courtyard ``default_world(
  world_seed)``, the sensor ``height_m`` up and heading along the path,
  each scan with Gaussian range noise ``noise_m`` drawn from the seed;
* sequence b of the batch drives course b mod K from an offset drawn from
  the seed, one scan a step, round the circle;
* chunk k of the replay is the next ``chunk`` scans of every sequence,
  gathered from the bank on the device, (B, C, N, ...).

Every seed gives the same courses, batch and chunk: only the noise and the
offsets change, so every seed does the same work.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from slam_bench import raycast as rc

CAST_RAYS = 2_000_000     # rays cast a call (float64 temporaries ~50 MB)


@dataclass
class Bank:
    xyz: torch.Tensor      # (K * L, N, 3) float32, sensor frame
    valid: torch.Tensor    # (K * L, N) bool
    ring: torch.Tensor     # (N,) int32
    R: np.ndarray          # (K * L, 3, 3) float64 world poses
    t: np.ndarray          # (K * L, 3)


def course_poses(traffic: dict):
    """(R (K * L, 3, 3), t (K * L, 3)) float64 world poses of every scan
    of every course, course-major."""
    L, step = int(traffic["scans_per_course"]), float(traffic["step_m"])
    r = step * L / (2.0 * math.pi)
    Rs, ts = [], []
    for cx, cy, direction in traffic["courses"]:
        a = direction * 2.0 * math.pi * np.arange(L) / L
        pos = np.stack([cx + r * np.sin(a) * direction,
                        cy - r * np.cos(a) * direction,
                        np.full(L, float(traffic["height_m"]))], 1)
        # starts at (cx, cy - r) heading +x, its yaw `a`; turns left
        # (direction 1) or right (-1) round the centre
        c, s = np.cos(a), np.sin(a)
        R = np.zeros((L, 3, 3))
        R[:, 0, 0], R[:, 0, 1], R[:, 1, 0], R[:, 1, 1] = c, -s, s, c
        R[:, 2, 2] = 1.0
        Rs.append(R)
        ts.append(pos)
    return np.concatenate(Rs), np.concatenate(ts)


def make_bank(traffic: dict, sensor: rc.Sensor, mid_row: bool, seed: int,
              device) -> Bank:
    """Cast every scan of every course on `device`, noise from `seed`."""
    R, t = course_poses(traffic)
    world = rc.default_world(int(traffic["world_seed"]))
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (1 << 63))
    n = sensor.n_scan * sensor.horizon_scan
    per = max(1, CAST_RAYS // n)
    xyz = torch.empty((len(R), n, 3), dtype=torch.float32, device=device)
    valid = torch.empty((len(R), n), dtype=torch.bool, device=device)
    Rd = torch.as_tensor(R, device=device)
    td = torch.as_tensor(t, device=device)
    for i in range(0, len(R), per):
        x, v, ring = rc.raycast(world, Rd[i:i + per], td[i:i + per], sensor,
                                noise=float(traffic["noise_m"]), gen=gen,
                                mid_row=mid_row)
        xyz[i:i + per], valid[i:i + per] = x, v
    return Bank(xyz, valid, ring, R, t)


def offsets(traffic: dict, seed: int) -> np.ndarray:
    """(B,) start offsets of the sequences along their courses."""
    rng = np.random.default_rng([seed % (1 << 63), 1])
    return rng.integers(0, int(traffic["scans_per_course"]),
                        int(traffic["batch"]))


def scan_index(traffic: dict, offs: np.ndarray, step0: int, n: int) -> np.ndarray:
    """(B, n) bank rows of steps step0 .. step0 + n - 1 of every sequence."""
    K, L = len(traffic["courses"]), int(traffic["scans_per_course"])
    b = np.arange(len(offs))
    steps = (offs[:, None] + step0 + np.arange(n)[None, :]) % L
    return (b % K)[:, None] * L + steps


def gather(bank: Bank, rows: np.ndarray, use_ring: bool):
    """(xyz (B, C, N, 3), valid (B, C, N), ring (B, C, N) or None) of the
    bank rows (B, C), on the bank's device."""
    idx = torch.as_tensor(rows.reshape(-1), device=bank.xyz.device)
    B, C = rows.shape
    xyz = bank.xyz.index_select(0, idx).reshape(B, C, *bank.xyz.shape[1:])
    valid = bank.valid.index_select(0, idx).reshape(B, C, -1)
    ring = bank.ring.expand(B, C, -1) if use_ring else None
    return xyz, valid, ring
