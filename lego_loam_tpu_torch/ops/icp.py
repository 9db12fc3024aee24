"""Batched point-to-point ICP (PCL IterativeClosestPoint replacement;
counterpart of ``lego_loam_tpu.ops.icp``; mapOptmization.cpp:892-904).

Fixed-iteration ICP: each iteration's 1-NN goes through ``ops/knn.knn``
(kernel K3 on a CUDA tensor) and a weighted rigid fit updates the pose;
fitness is PCL's score (mean squared NN distance of the matched source
points).

The rigid fit is Horn's quaternion form of the Kabsch problem: the best
rotation is the top eigenvector of a symmetric 4x4 matrix built from the
cross-covariance.  That eigenvector comes from repeated squaring of the
shifted matrix, a fixed run of 4x4 products, so no step reaches a
cuSOLVER call (an SVD or eigh on a CUDA tensor reads its info code back to
the host, 30 times a loop check).  The result is the same rotation as the
JAX package's SVD with its reflection fix: both maximise tr(R S) over
proper rotations.
"""

from __future__ import annotations

import functools

import torch

from lego_loam_tpu_torch.ops.knn import knn
from lego_loam_tpu_torch.ops.lin3 import eigvalsh3, principal_axis3
from lego_loam_tpu_torch.utils.math3d import Pose

# Horn's matrix N(S) and the rotation R(q q^T) are linear in the entries
# of S and of q q^T: N = (_N_OF_S @ S.reshape(9)).reshape(4, 4) and
# R = (_R_OF_QQ @ (q q^T).reshape(16)).reshape(3, 3), q = (w, x, y, z)
_N_TERMS = {   # N[r][c] = sum of sign * S[a][b], upper triangle
    (0, 0): ((1, 0, 0), (1, 1, 1), (1, 2, 2)),
    (0, 1): ((1, 1, 2), (-1, 2, 1)), (0, 2): ((1, 2, 0), (-1, 0, 2)),
    (0, 3): ((1, 0, 1), (-1, 1, 0)),
    (1, 1): ((1, 0, 0), (-1, 1, 1), (-1, 2, 2)),
    (1, 2): ((1, 0, 1), (1, 1, 0)), (1, 3): ((1, 2, 0), (1, 0, 2)),
    (2, 2): ((-1, 0, 0), (1, 1, 1), (-1, 2, 2)), (2, 3): ((1, 1, 2), (1, 2, 1)),
    (3, 3): ((-1, 0, 0), (-1, 1, 1), (1, 2, 2)),
}
_R_TERMS = {   # R[r][c] = sum of coefficient * (q q^T)[a][b]
    (0, 0): ((1, 0, 0), (1, 1, 1), (-1, 2, 2), (-1, 3, 3)),
    (0, 1): ((2, 1, 2), (-2, 0, 3)), (0, 2): ((2, 1, 3), (2, 0, 2)),
    (1, 0): ((2, 1, 2), (2, 0, 3)),
    (1, 1): ((1, 0, 0), (-1, 1, 1), (1, 2, 2), (-1, 3, 3)),
    (1, 2): ((2, 2, 3), (-2, 0, 1)),
    (2, 0): ((2, 1, 3), (-2, 0, 2)), (2, 1): ((2, 2, 3), (2, 0, 1)),
    (2, 2): ((1, 0, 0), (-1, 1, 1), (-1, 2, 2), (1, 3, 3)),
}
_SQUARINGS = 24     # the other eigenvalues' share falls as r^(2^24), r < 1


@functools.lru_cache(maxsize=None)
def _horn_maps(device: torch.device):
    n_of_s = torch.zeros(4, 4, 9, dtype=torch.float64)
    for (r, c), terms in _N_TERMS.items():
        for sign, a, b in terms:
            n_of_s[r, c, 3 * a + b] += sign
            if r != c:
                n_of_s[c, r, 3 * a + b] += sign
    r_of_qq = torch.zeros(3, 3, 16, dtype=torch.float64)
    for (r, c), terms in _R_TERMS.items():
        for coef, a, b in terms:
            r_of_qq[r, c, 4 * a + b] += coef
    return n_of_s.reshape(16, 9).to(device), r_of_qq.reshape(9, 16).to(device)


def _horn_rotation(S: torch.Tensor) -> torch.Tensor:
    """Proper rotation R maximising tr(R S) for a 3x3 cross-covariance
    S = sum w (src - mu_s)(dst - mu_d)^T, in float64.  The top eigenvector
    q of Horn's N(S) is the limit of repeated squaring of N + |N| I
    (positive semi-definite, top eigenvalue largest): the squared matrix,
    over its trace, tends to q q^T.  Its column with the largest diagonal
    entry, normalised, is q up to sign, and R(q q^T) is a proper rotation
    even where the top eigenvalue is (nearly) double, as for collinear
    matches, whose spin about their line is free.  A 1e-30 on the w-w
    entry breaks the tie of S = 0 (nothing matched) toward the identity."""
    n_of_s, r_of_qq = _horn_maps(S.device)
    N = (n_of_s @ S.to(torch.float64).reshape(9)).reshape(4, 4)
    shift = torch.linalg.matrix_norm(N) * torch.eye(4, dtype=torch.float64,
                                                    device=S.device)
    M = N + shift
    M[0, 0] += 1e-30
    M = M / torch.trace(M)
    for k in range(_SQUARINGS):
        M = M @ M
        if k % 4 == 3:          # eigenvalues in [0, 1] summing to 1: four
            M = M / torch.trace(M)      # squarings cannot underflow
    q = M.index_select(1, torch.argmax(torch.diagonal(M)).reshape(1))[:, 0]
    q = q / torch.linalg.vector_norm(q)
    return (r_of_qq @ torch.outer(q, q).reshape(16)).reshape(3, 3)


def _kabsch(src, dst, w):
    """Weighted rigid alignment src -> dst.  w: per-pair weights (N,)."""
    wsum = torch.clamp(torch.sum(w), min=1e-6)
    mu_s = torch.sum(src * w[:, None], 0) / wsum
    mu_d = torch.sum(dst * w[:, None], 0) / wsum
    S = ((src - mu_s) * w[:, None]).T @ (dst - mu_d)
    R = _horn_rotation(S).to(src.dtype)
    return Pose(R, mu_d - R @ mu_s)


def icp_align(src, src_valid, dst, dst_valid, T0: Pose, iters: int = 30,
              max_corr_dist: float = 100.0, query_tile: int = 0):
    """Align src onto dst starting from T0.

    Returns (T, fitness): T maps src into dst's frame; fitness is the mean
    squared NN distance of valid matched points at the final pose (PCL
    getFitnessScore semantics), 1e9 when fewer than 10 points match.
    """
    max_d2 = max_corr_dist * max_corr_dist
    T = T0
    for _ in range(iters):
        q = src @ T.R.T + T.t
        idx, d2 = knn(q, dst, dst_valid, 1, query_tile)
        w = (src_valid & (d2[:, 0] < max_d2)).to(src.dtype)
        T = _kabsch(q, dst.index_select(0, idx[:, 0].long()), w).compose(T)

    q = src @ T.R.T + T.t
    _, d2 = knn(q, dst, dst_valid, 1, query_tile)
    m = src_valid & (d2[:, 0] < max_d2)
    n_match = torch.sum(m)
    fitness = torch.sum(torch.where(m, d2[:, 0], 0.0)) / torch.clamp(n_match, min=1)
    # PCL returns +inf-like when nothing matches; a handful of matches is
    # equally meaningless and must not read as a perfect alignment
    return T, torch.where(n_match >= 10, fitness, 1.0e9)


def plane_information(q, match, dst, dst_valid, query_tile: int = 0):
    """Translational point-to-plane information matrix of an alignment.

    q: (N, 3) source points already placed at the converged pose; match:
    (N,) bool valid-correspondence mask.  For each matched point the local
    target surface normal is estimated from its 5-NN in dst (covariance
    smallest-eigvec), and the 3x3 matrix sum_k m_k n_k n_k^T is returned.
    A point-to-point fit is always translationally stiff at frozen
    correspondences; this form shows surface slip (a ~0 eigenvalue along a
    smooth corridor's axis), which the loop check's observability gate
    reads.
    """
    idx, _ = knn(q, dst, dst_valid, 5, query_tile)
    nbrs = dst.index_select(0, idx.reshape(-1).long()).reshape(idx.shape + (3,))
    c = nbrs.mean(dim=1)
    X = nbrs - c[:, None, :]
    cov = X.transpose(1, 2) @ X / nbrs.shape[1]
    lam = eigvalsh3(cov)                              # ascending
    # smallest-eigenvalue eigenvector of cov == largest of (tr(cov) I - cov)
    tr = (lam[:, 0] + lam[:, 1] + lam[:, 2])[:, None]
    B = tr[..., None] * torch.eye(3, dtype=cov.dtype, device=cov.device) - cov
    lamB = torch.stack([tr[:, 0] - lam[:, 2], tr[:, 0] - lam[:, 1],
                        tr[:, 0] - lam[:, 0]], dim=-1)
    n = principal_axis3(B, lamB)                      # (N, 3) unit normals
    # a 5-NN set that does not span a surface (isolated pole tip, padding)
    # has no meaningful normal: require the tangent spread lam[1] to
    # dominate the normal direction's lam[0]
    surf_ok = match & (lam[:, 1] > 4.0 * lam[:, 0] + 1e-8)
    w = surf_ok.to(q.dtype)
    return (n * w[:, None]).T @ n
