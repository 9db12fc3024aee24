"""KITTI odometry dataset ingestion (HDL-64E): a jax-free copy of
``lego_loam_tpu.io.kitti``.

Velodyne .bin scans padded to the fixed pipeline shape (pad_scan, which
the bag replay uses too), ground-truth poses transformed from the
left-camera frame into the velodyne frame via the calibration, and
sequence iteration.  read_bin reads through the native reader
(lego_loam_tpu_torch/native/fast_io, built from native/fast_io.cpp at
first use) and with NumPy where it cannot be built.
"""

from __future__ import annotations

import os

import numpy as np

from lego_loam_tpu_torch.config import PipelineConfig
from lego_loam_tpu_torch.native import fast_io


def read_bin(path: str) -> np.ndarray:
    """(N, 4) float32 x, y, z, reflectance.  The native reader drops a
    partial last record; the NumPy path raises ValueError on one."""
    if fast_io.available():
        return fast_io.read_kitti_bin(path)
    return np.fromfile(path, dtype=np.float32).reshape(-1, 4)


def pad_scan(pts: np.ndarray, cfg: PipelineConfig, cap: int | None = None):
    """(N, >=3) -> fixed-shape (cap, 3) xyz + valid for the pipeline.

    The projection scatter accepts any input length, so the cap defaults to
    max(grid size, 2^17 = 131072) — above real HDL-64E scan sizes (~120-130k
    points), which exceed the 64x1800 grid itself.
    """
    P = cap or max(cfg.sensor.n_scan * cfg.sensor.horizon_scan, 1 << 17)
    xyz = pts[:, :3].astype(np.float32)
    finite = np.isfinite(xyz).all(axis=1)
    xyz = np.where(finite[:, None], xyz, 0.0)
    n = min(xyz.shape[0], P)
    out = np.zeros((P, 3), np.float32)
    valid = np.zeros((P,), bool)
    out[:n] = xyz[:n]
    valid[:n] = finite[:n]
    return out, valid


def read_calib(seq_dir: str) -> np.ndarray:
    """(4, 4) T_cam0_from_velo from calib.txt's Tr line."""
    with open(os.path.join(seq_dir, "calib.txt")) as f:
        for line in f:
            if line.startswith("Tr"):
                vals = np.array([float(x) for x in line.split()[1:]])
                T = np.eye(4)
                T[:3] = vals.reshape(3, 4)
                return T
    raise ValueError(f"no Tr line in {seq_dir}/calib.txt")


def read_poses(pose_file: str, T_cam_velo: np.ndarray | None = None) -> np.ndarray:
    """(N, 4, 4) ground-truth poses.  KITTI poses are T_w_cam0; with the
    calibration they become T_w_velo = T_w_cam0 @ T_cam_velo."""
    rows = np.loadtxt(pose_file).reshape(-1, 3, 4)
    n = rows.shape[0]
    T = np.tile(np.eye(4), (n, 1, 1))
    T[:, :3] = rows
    if T_cam_velo is not None:
        T = T @ T_cam_velo[None]
    return T


class KittiSequence:
    """Iterate (xyz, valid, timestamp) over a KITTI odometry sequence dir
    (velodyne/*.bin)."""

    def __init__(self, seq_dir: str, cfg: PipelineConfig,
                 max_frames: int | None = None):
        self.cfg = cfg
        self.velo_dir = os.path.join(seq_dir, "velodyne")
        self.files = sorted(
            f for f in os.listdir(self.velo_dir) if f.endswith(".bin"))
        if max_frames:
            self.files = self.files[:max_frames]

    def __len__(self):
        return len(self.files)

    def __iter__(self):
        for k, name in enumerate(self.files):
            pts = read_bin(os.path.join(self.velo_dir, name))
            xyz, valid = pad_scan(pts, self.cfg)
            yield xyz, valid, k * self.cfg.sensor.scan_period


def write_poses_kitti(path: str, Rs: np.ndarray, ts: np.ndarray) -> None:
    """Write (N,3,3)+(N,3) poses as KITTI 12-value rows (for evo/kitti-eval
    tooling)."""
    n = Rs.shape[0]
    rows = np.concatenate([Rs.reshape(n, 9).reshape(n, 3, 3),
                           ts.reshape(n, 3, 1)], axis=2).reshape(n, 12)
    np.savetxt(path, rows, fmt="%.9e")
