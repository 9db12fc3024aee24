"""Closed-form batched 3x3 linear algebra (counterpart of
``lego_loam_tpu.ops.lin3``; ported as-is, the parity of the line and plane
fits depends on these exact formulas).

Smith's trigonometric method for symmetric 3x3 eigenvalues, adjugate /
Cramer for the solve, and the spectral projector for the top eigenvector.
"""

from __future__ import annotations

import math

import torch

_EPS = 1e-30


def solve3(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched 3x3 solve by adjugate: x = adj(A) b / det(A).  Singular
    matrices give non-finite outputs (callers guard with isfinite)."""
    a00, a01, a02 = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    a10, a11, a12 = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    a20, a21, a22 = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    c00 = a11 * a22 - a12 * a21
    c01 = a12 * a20 - a10 * a22
    c02 = a10 * a21 - a11 * a20
    det = a00 * c00 + a01 * c01 + a02 * c02
    c10 = a02 * a21 - a01 * a22
    c11 = a00 * a22 - a02 * a20
    c12 = a01 * a20 - a00 * a21
    c20 = a01 * a12 - a02 * a11
    c21 = a02 * a10 - a00 * a12
    c22 = a00 * a11 - a01 * a10
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    x0 = c00 * b0 + c10 * b1 + c20 * b2
    x1 = c01 * b0 + c11 * b1 + c21 * b2
    x2 = c02 * b0 + c12 * b1 + c22 * b2
    return torch.stack([x0, x1, x2], dim=-1) / det[..., None]


def eigvalsh3(A: torch.Tensor) -> torch.Tensor:
    """Batched eigenvalues of symmetric 3x3 matrices, ascending (..., 3)."""
    a00, a11, a22 = A[..., 0, 0], A[..., 1, 1], A[..., 2, 2]
    a01, a02, a12 = A[..., 0, 1], A[..., 0, 2], A[..., 1, 2]
    q = (a00 + a11 + a22) / 3.0
    d0, d1, d2 = a00 - q, a11 - q, a22 - q
    p2 = d0 * d0 + d1 * d1 + d2 * d2 + 2.0 * (a01 * a01 + a02 * a02 + a12 * a12)
    p = torch.sqrt(p2 / 6.0 + _EPS)
    detB = (d0 * (d1 * d2 - a12 * a12)
            - a01 * (a01 * d2 - a12 * a02)
            + a02 * (a01 * a12 - d1 * a02))
    r = torch.clamp(detB / (2.0 * p * p * p), -1.0, 1.0)
    phi = torch.acos(r) / 3.0
    e_hi = q + 2.0 * p * torch.cos(phi)
    e_lo = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    e_mid = 3.0 * q - e_hi - e_lo
    iso = p2 <= 1e-20          # A = qI: all eigenvalues q
    e_lo = torch.where(iso, q, e_lo)
    e_mid = torch.where(iso, q, e_mid)
    e_hi = torch.where(iso, q, e_hi)
    return torch.stack([e_lo, e_mid, e_hi], dim=-1)


def principal_axis3(A: torch.Tensor, lam: torch.Tensor) -> torch.Tensor:
    """Unit eigenvector for the LARGEST eigenvalue of symmetric 3x3 A, from
    the column of largest norm of (A - lam_mid I)(A - lam_lo I); finite
    fallback (1, 0, 0) when the projector collapses."""
    I = torch.eye(3, dtype=A.dtype, device=A.device).expand(A.shape)
    B = (A - lam[..., 1, None, None] * I) @ (A - lam[..., 0, None, None] * I)
    nrm2 = torch.sum(B * B, dim=-2)
    col = torch.argmax(nrm2, dim=-1)
    v = torch.take_along_dim(B, col[..., None, None], dim=-1)[..., 0]
    n = torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True))
    safe = n > 1e-12
    fallback = I[..., 0]                                   # (1, 0, 0)
    return torch.where(safe, v / torch.where(safe, n, torch.ones_like(n)), fallback)
