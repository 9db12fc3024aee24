"""Trajectory accuracy metrics (ATE / RPE) and per-frame pipeline metrics:
a jax-free copy of ``lego_loam_tpu.utils.metrics`` (the same names, the
same float64 results).

The reference publishes no numeric metrics at all (SURVEY.md §5); evaluation
is rviz + offline PCD inspection.  Here: standard KITTI/TUM-style absolute
trajectory error (with Umeyama alignment) and relative pose error, plus a
light per-frame metrics recorder for the pipeline.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


def umeyama_alignment(est: np.ndarray, gt: np.ndarray, with_scale: bool = False):
    """Least-squares similarity/rigid alignment est -> gt.  (N, 3) each.
    Returns (R, t, s)."""
    mu_e, mu_g = est.mean(0), gt.mean(0)
    E, G = est - mu_e, gt - mu_g
    C = G.T @ E / est.shape[0]
    U, D, Vt = np.linalg.svd(C)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    s = float((D * S.diagonal()).sum() / (E ** 2).sum() * est.shape[0]) if with_scale else 1.0
    t = mu_g - s * R @ mu_e
    return R, t, s


def ate_rmse(est: np.ndarray, gt: np.ndarray, align: bool = True) -> float:
    """Absolute trajectory error RMSE over (N, 3) positions."""
    est = np.asarray(est, np.float64)
    gt = np.asarray(gt, np.float64)
    if align:
        R, t, s = umeyama_alignment(est, gt)
        est = (s * est) @ R.T + t
    return float(np.sqrt(np.mean(np.sum((est - gt) ** 2, axis=1))))


def rpe(est_poses: np.ndarray, gt_poses: np.ndarray, delta: int = 1):
    """Relative pose error over (N, 4, 4) pose arrays.

    Returns (trans_rmse, rot_rmse_rad)."""
    et, er = [], []
    n = min(len(est_poses), len(gt_poses))
    for i in range(n - delta):
        de = np.linalg.inv(est_poses[i]) @ est_poses[i + delta]
        dg = np.linalg.inv(gt_poses[i]) @ gt_poses[i + delta]
        err = np.linalg.inv(dg) @ de
        et.append(np.linalg.norm(err[:3, 3]))
        c = np.clip((np.trace(err[:3, :3]) - 1) / 2, -1, 1)
        er.append(np.arccos(c))
    return float(np.sqrt(np.mean(np.square(et)))), float(np.sqrt(np.mean(np.square(er))))


def poses_to_mat(Rs: np.ndarray, ts: np.ndarray) -> np.ndarray:
    """(N,3,3),(N,3) -> (N,4,4)."""
    n = Rs.shape[0]
    T = np.tile(np.eye(4), (n, 1, 1))
    T[:, :3, :3] = Rs
    T[:, :3, 3] = ts
    return T


@dataclass
class MetricsRecorder:
    """Per-frame structured metrics (feature counts, timings, drift)."""

    frames: list = field(default_factory=list)

    def add(self, **kw):
        self.frames.append(dict(kw))

    def summary(self) -> dict:
        if not self.frames:
            return {}
        keys = self.frames[0].keys()
        out = {}
        for k in keys:
            vals = [f[k] for f in self.frames if isinstance(f.get(k), (int, float))]
            if vals:
                out[k] = {"mean": float(np.mean(vals)),
                          "p50": float(np.percentile(vals, 50)),
                          "p95": float(np.percentile(vals, 95))}
        return out
