"""E1, the degeneracy projection P = V diag(lam >= thresh) V^T of a
symmetric 6x6 system (lego_loam_tpu_torch/ops/eig6.py), on the CPU.

  * the plain version (float32 eigh), what a CPU pipeline runs, against
    the JAX package's _degeneracy_projection on seeded spectra
    (tests/torch_courses.eig6_spectra: across the threshold, all kept, all
    dropped, repeated eigenvalues, rank one, the odometry's block system
    with one block masked to exact zeros, zero, Gram matrices), at both
    thresholds the pipeline uses: P within 1e-5 (a projector's entries lie
    in [-1, 1]), eigenvalues within 1e-5 of |H|;
  * the kernel's algorithm, mirrored in float64 NumPy (_jacobi6: the same
    cyclic sweeps, rotation formula, stopping rule and keep test as
    csrc/eig6.cu), against the same references: it converges on every
    spectrum, exact zeros and repeated eigenvalues included, in at most 8
    sweeps;
  * the near-threshold case: an eigenvalue closer to the threshold than
    float32 eigh's rounding gap (~1e-7 of |H|) can be kept by the float64
    solve and dropped by float32 eigh, or the other way; then P differs by
    the rank-one projector of that eigenvector.  This is why the card's
    tests (tests/test_torch_kernels_cuda.py, chip_smoke.py) hold the
    kernel to the plain version on spectra kept off the threshold.
"""

import numpy as np
import pytest
import torch

from lego_loam_tpu.models.odometry import _degeneracy_projection as jax_projection
from lego_loam_tpu_torch.ops import eig6 as e1

from tests.torch_courses import eig6_spectra

THRESHOLDS = (10.0, 100.0)   # odom_degen_eig_thresh, map_degen_eig_thresh
P_TOL, LAM_TOL = 1e-5, 1e-5


def _jacobi6(H: np.ndarray, thresh: float, max_sweeps: int = 32):
    """csrc/eig6.cu's arithmetic in float64 NumPy: (P float32, lam float32
    ascending, sweeps)."""
    a = 0.5 * (H.astype(np.float64) + H.astype(np.float64).T)
    v = np.eye(6)
    frob = float((a * a).sum())
    s = 0
    while s < max_sweeps:
        off = sum(a[p, q] ** 2 for p in range(6) for q in range(p + 1, 6))
        if off <= 1e-30 * frob:
            break
        for p in range(5):
            for q in range(p + 1, 6):
                apq = a[p, q]
                if apq == 0.0:
                    continue
                theta = (a[q, q] - a[p, p]) / (2.0 * apq)
                t = (0.5 / theta if abs(theta) > 1e100 else
                     np.copysign(1.0, theta) / (abs(theta) + np.sqrt(theta * theta + 1.0)))
                c = 1.0 / np.sqrt(t * t + 1.0)
                sn = t * c
                ap, aq = a[:, p].copy(), a[:, q].copy()
                a[:, p], a[:, q] = c * ap - sn * aq, sn * ap + c * aq
                ap, aq = a[p, :].copy(), a[q, :].copy()
                a[p, :], a[q, :] = c * ap - sn * aq, sn * ap + c * aq
                a[p, q] = a[q, p] = 0.0
                vp, vq = v[:, p].copy(), v[:, q].copy()
                v[:, p], v[:, q] = c * vp - sn * vq, sn * vp + c * vq
        s += 1
    d = np.diag(a).astype(np.float32)
    keep = (d >= np.float32(thresh)).astype(np.float64)
    P = (v * keep[None, :]) @ v.T
    return P.astype(np.float32), np.sort(d), s


@pytest.mark.parametrize("thresh", THRESHOLDS)
def test_plain_projection_matches_jax(thresh):
    for name, H in eig6_spectra(thresh):
        P, lam = e1.degeneracy_projection(torch.as_tensor(H), thresh)
        ref = np.asarray(jax_projection(H, thresh))
        scale = max(float(np.abs(H).max()), 1.0)
        np.testing.assert_allclose(P.numpy(), ref, atol=P_TOL, err_msg=name)
        np.testing.assert_allclose(lam.numpy() / scale,
                                   np.linalg.eigvalsh(H.astype(np.float64)) / scale,
                                   atol=LAM_TOL, err_msg=name)


@pytest.mark.parametrize("thresh", THRESHOLDS)
def test_kernel_algorithm_matches_jax_and_plain(thresh):
    batch = []
    for name, H in eig6_spectra(thresh, seed=1):
        P, lam, sweeps = _jacobi6(H, thresh)
        assert sweeps <= 8, (name, sweeps)
        scale = max(float(np.abs(H).max()), 1.0)
        np.testing.assert_allclose(P, np.asarray(jax_projection(H, thresh)),
                                   atol=P_TOL, err_msg=name)
        np.testing.assert_allclose(lam / scale,
                                   np.linalg.eigvalsh(H.astype(np.float64)) / scale,
                                   atol=LAM_TOL, err_msg=name)
        keep = np.linalg.eigvalsh(H.astype(np.float64)) >= thresh
        assert np.isclose(np.trace(P), keep.sum(), atol=1e-5), name
        batch.append((H, P))
    # the batched plain version (the wrapper takes (B, 6, 6) as the kernel
    # does) agrees with the mirror matrix by matrix
    Hs = torch.as_tensor(np.stack([h for h, _ in batch]))
    P_plain, _ = e1.degeneracy_projection(Hs, thresh)
    np.testing.assert_allclose(P_plain.numpy(), np.stack([p for _, p in batch]),
                               atol=P_TOL)


def test_exact_zero_rows_need_no_rotation():
    """The masked block rows stay exact zeros: only the live block is
    rotated, and the zero matrix takes no sweep at all."""
    spectra = dict(eig6_spectra(10.0))
    P, lam, sweeps = _jacobi6(spectra["zero"], 10.0)
    assert sweeps == 0 and not P.any() and not lam.any()
    P, lam, _ = _jacobi6(spectra["block_masked"], 10.0)
    dead = [2, 3, 4]
    assert not P[dead].any() and not P[:, dead].any()
    np.testing.assert_allclose(P[np.ix_([0, 1, 5], [0, 1, 5])], np.eye(3), atol=1e-6)


def test_near_threshold_eigenvalue_can_flip():
    """An eigenvalue within float32 rounding of the threshold: the float64
    solve (the kernel's) and float32 eigh (the plain version, JAX's) can
    take different keep masks; where they do, P differs by exactly the
    rank-one projector of that direction.  Documented, not hidden: the
    card's comparisons keep spectra off the threshold."""
    thresh = 10.0
    rng = np.random.default_rng(5)
    flips = 0
    for _ in range(40):
        q, r = np.linalg.qr(rng.normal(size=(6, 6)))
        Q = q * np.sign(np.diag(r))
        # |H| ~ 1e4, so float32 eigh's error (~1e-3) dwarfs the 1e-5 margin
        lam = np.array([0.5, thresh * (1 + rng.uniform(-1e-6, 1e-6)), 60.0,
                        500.0, 2e3, 1e4])
        H = (0.5 * (Q @ np.diag(lam) @ Q.T + (Q @ np.diag(lam) @ Q.T).T)).astype(np.float32)
        P64, _, _ = _jacobi6(H, thresh)
        P32, lam32 = e1.degeneracy_projection(torch.as_tensor(H), thresh)
        P32 = P32.numpy()
        if np.abs(P64 - P32).max() < 1e-3:
            continue
        flips += 1
        v = Q[:, 1:2]   # the near-threshold direction
        diff = P64 - P32
        np.testing.assert_allclose(np.abs(diff), np.abs(v @ v.T), atol=1e-3)
        assert abs(float(lam32[1]) - thresh) < 1e-2
    assert flips > 0
