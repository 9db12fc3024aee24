"""SO(3)/SE(3) utilities (counterpart of ``lego_loam_tpu.utils.math3d``).

One convention everywhere: lidar frame x forward / y left / z up, rotations
as 3x3 matrices, exp/log maps for interpolation and Gauss-Newton charts.
All functions batch over leading dimensions.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

_EPS = 1e-9


def _eye_like(M: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=M.dtype, device=M.device).expand(M.shape)


def _matvec(R: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) x (..., 3) -> (..., 3)."""
    return (R @ v.unsqueeze(-1)).squeeze(-1)


class Pose(NamedTuple):
    """Rigid transform: x_out = R @ x_in + t.  Batchable ((..., 3, 3)/(..., 3))."""

    R: torch.Tensor
    t: torch.Tensor

    @staticmethod
    def identity(batch: tuple = (), dtype=torch.float32, device=None) -> "Pose":
        R = torch.eye(3, dtype=dtype, device=device).expand(batch + (3, 3)).clone()
        t = torch.zeros(batch + (3,), dtype=dtype, device=device)
        return Pose(R, t)

    def apply(self, pts: torch.Tensor) -> torch.Tensor:
        """Transform points (..., N, 3) or (..., 3)."""
        if pts.dim() == self.R.dim():
            return pts @ self.R.transpose(-1, -2) + self.t.unsqueeze(-2)
        return _matvec(self.R, pts) + self.t

    def compose(self, other: "Pose") -> "Pose":
        """self o other: first apply `other`, then `self`."""
        return Pose(self.R @ other.R, _matvec(self.R, other.t) + self.t)

    def inverse(self) -> "Pose":
        Rt = self.R.transpose(-1, -2)
        return Pose(Rt, -_matvec(Rt, self.t))


def hat(w: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix of (..., 3)."""
    z = torch.zeros_like(w[..., 0])
    return torch.stack([
        torch.stack([z, -w[..., 2], w[..., 1]], -1),
        torch.stack([w[..., 2], z, -w[..., 0]], -1),
        torch.stack([-w[..., 1], w[..., 0], z], -1),
    ], -2)


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues: (..., 3) axis-angle -> (..., 3, 3) rotation.

    The (1 - cos)/theta^2 coefficient uses the half-angle identity
    0.5 * (sin(t/2)/(t/2))^2: the direct form cancels catastrophically in
    float32 for the small inter-scan rotations this code lives on."""
    theta2 = torch.sum(w * w, -1)
    theta = torch.sqrt(theta2 + _EPS)
    small = theta2 > _EPS
    a = torch.where(small, torch.sin(theta) / theta, 1.0 - theta2 / 6.0)
    half = 0.5 * theta
    sinc_h = torch.where(small, torch.sin(half) / half, 1.0 - theta2 / 24.0)
    b = 0.5 * sinc_h * sinc_h
    W = hat(w)
    return _eye_like(W) + a[..., None, None] * W + b[..., None, None] * (W @ W)


def project_so3(R: torch.Tensor) -> torch.Tensor:
    """One Newton step of the polar decomposition: R (3I - R^T R)/2."""
    RtR = R.transpose(-1, -2) @ R
    return R @ (1.5 * _eye_like(R) - 0.5 * RtR)


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Log map: (..., 3, 3) rotation -> (..., 3) axis-angle.

    sin(theta) comes from ||vee(R - R^T)||/2, not sin(arccos(trace)), which
    loses all precision near theta = pi in float32; near pi the axis comes
    from the diagonal of (R + I)/2 = a a^T with signs from the off-diagonal
    sums."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    vee = torch.stack([
        R[..., 2, 1] - R[..., 1, 2],
        R[..., 0, 2] - R[..., 2, 0],
        R[..., 1, 0] - R[..., 0, 1],
    ], -1)
    sin_t = 0.5 * torch.linalg.vector_norm(vee, dim=-1)
    theta = torch.atan2(sin_t, cos_t)
    scale = torch.where(sin_t > 1e-6, theta / (2.0 * sin_t + _EPS),
                        0.5 + theta * theta / 12.0)
    w_small = scale[..., None] * vee
    diag = torch.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], -1)
    axis_sq = torch.clamp((diag - cos_t[..., None])
                          / (1.0 - cos_t[..., None] + _EPS), min=0.0)
    axis = torch.sqrt(axis_sq)
    off = torch.stack([
        R[..., 1, 0] + R[..., 0, 1],
        R[..., 2, 1] + R[..., 1, 2],
        R[..., 0, 2] + R[..., 2, 0],
    ], -1)
    signs = torch.sign(torch.where(vee.abs() > 1e-7, vee, off))
    signs = torch.where(signs == 0, torch.ones_like(signs), signs)
    w_pi = theta[..., None] * axis * signs
    use_small = (sin_t > 1e-3) | (cos_t > 0.0)
    return torch.where(use_small[..., None], w_small, w_pi)


def pose_interp(p: Pose, s) -> Pose:
    """Geodesic interpolation from identity to p by fraction s (broadcastable)."""
    w = so3_log(p.R)
    s = torch.as_tensor(s, dtype=p.R.dtype, device=p.R.device)
    return Pose(so3_exp(s[..., None] * w), s[..., None] * p.t)



def _cso(a: torch.Tensor):
    c, s = torch.cos(a), torch.sin(a)
    return c, s, torch.ones_like(c), torch.zeros_like(c)


def _mat(rows) -> torch.Tensor:
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


def rot_x(a: torch.Tensor) -> torch.Tensor:
    c, s, o, z = _cso(a)
    return _mat([[o, z, z], [z, c, -s], [z, s, c]])


def rot_y(a: torch.Tensor) -> torch.Tensor:
    c, s, o, z = _cso(a)
    return _mat([[c, z, s], [z, o, z], [-s, z, c]])


def rot_z(a: torch.Tensor) -> torch.Tensor:
    c, s, o, z = _cso(a)
    return _mat([[c, -s, z], [s, c, z], [z, z, o]])


def euler_to_mat(roll, pitch, yaw) -> torch.Tensor:
    """R = Rz(yaw) @ Ry(pitch) @ Rx(roll) (ZYX / lidar convention)."""
    return rot_z(yaw) @ rot_y(pitch) @ rot_x(roll)


def mat_to_euler(R: torch.Tensor):
    """Inverse of euler_to_mat.  Returns (roll, pitch, yaw)."""
    pitch = -torch.asin(torch.clamp(R[..., 2, 0], -1.0, 1.0))
    roll = torch.atan2(R[..., 2, 1], R[..., 2, 2])
    yaw = torch.atan2(R[..., 1, 0], R[..., 0, 0])
    return roll, pitch, yaw
