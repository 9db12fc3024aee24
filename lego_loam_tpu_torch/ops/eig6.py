"""The degeneracy projection of a symmetric 6x6 or 3x3 system, P = V
diag(lam >= thresh) V^T (featureAssociation.cpp:1329-1356; counterpart of
``lego_loam_tpu.models.odometry._degeneracy_projection``).

On a CUDA tensor it is kernel E1 (``csrc/eig6.cu``): cyclic Jacobi in
float64 registers, one thread a matrix, P and the ascending eigenvalues
written back and V never.  torch.linalg.eigh on a CUDA tensor reads
cuSOLVER's info code back to the host, one host sync a call (5 a scan in
the block odometry, 10 in the two-step's 3x3 phases, 1 a mapping solve);
the kernel makes none.  On a CPU tensor it is
:func:`degeneracy_projection_plain`, float32 eigh.  Both go through the
custom op ``lego::eig6``, whose vmap rule folds a vmapped batch into the
same launch (kernels/build.py).

The two take the same keep mask wherever every eigenvalue lies further
from thresh than their rounding gap (float32 LAPACK against float64
Jacobi, ~1e-7 of |H|); an eigenvalue within that gap of thresh can keep a
direction in one and drop it in the other (tests/test_torch_eig6.py shows
such a case).
"""

from __future__ import annotations

import torch

from lego_loam_tpu_torch.kernels import build as kb


def degeneracy_projection_plain(H: torch.Tensor, thresh: float):
    """(..., n, n) float32 -> (P (..., n, n), lam (..., n) ascending) by
    float32 eigh of the symmetrised H (jnp's eigh symmetrises its input)."""
    lam, V = torch.linalg.eigh(0.5 * (H + H.mT))
    keep = (lam >= thresh).to(H.dtype)
    return (V * keep[..., None, :]) @ V.mT, lam


SIZES = (3, 6)      # the matrix sizes E1 takes


def eig6(H: torch.Tensor, thresh: float):
    """Kernel E1 on (B, n, n) float32 CUDA matrices, n = 3 or 6.  Returns
    (P (B, n, n), lam (B, n) ascending, sweeps (B,) int32: the Jacobi
    sweeps taken)."""
    B, n = H.shape[0], H.shape[-1]
    dev = H.device
    if n not in SIZES:
        raise ValueError(f"eig6 takes (B, n, n) matrices with n in {SIZES}, "
                         f"got {tuple(H.shape)}")
    kb.require(H, "H", torch.float32, (B, n, n), dev)
    if B < 1:
        raise ValueError("eig6 needs at least one matrix")
    P = torch.empty((B, n, n), dtype=torch.float32, device=dev)
    lam = torch.empty((B, n), dtype=torch.float32, device=dev)
    sweeps = torch.empty((B,), dtype=torch.int32, device=dev)
    kb.check(kb.library().lego_eig6(
        H.data_ptr(), float(thresh), P.data_ptr(), lam.data_ptr(),
        sweeps.data_ptr(), B, n, kb.stream_of(H)), "eig6")
    eig6.launches += 1
    if n == 3:
        eig6.launches_3x3 += 1
    return P, lam, sweeps


eig6.launches = 0
eig6.launches_3x3 = 0       # of which on 3x3 matrices


@torch.library.custom_op("lego::eig6", mutates_args=())
def _eig6_op(H: torch.Tensor, thresh: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., n, n) float32, n = 3 or 6 -> (P (..., n, n), lam (..., n)):
    one E1 launch for every matrix on a CUDA tensor, the plain version on a
    CPU tensor (once a matrix of a vmapped batch)."""
    if not H.is_cuda:
        return kb.per_element(degeneracy_projection_plain, H.dim() - 2, H, thresh)
    n = H.shape[-1]
    P, lam, _ = eig6(H.reshape(-1, n, n).contiguous(), thresh)
    return P.reshape(H.shape), lam.reshape(H.shape[:-1])


@_eig6_op.register_vmap
def _eig6_vmap(info, in_dims, H, thresh):
    return _eig6_op(*kb.batch_front(info, in_dims, H, thresh)), (0, 0)


def degeneracy_projection(H: torch.Tensor, thresh: float):
    """(n, n) or (B, n, n) float32, n = 3 or 6 -> (P, lam ascending) of the
    same batch shape: E1 on a CUDA tensor (no host sync), the plain version
    on a CPU tensor.  Under torch.func.vmap the batch joins the same
    launch."""
    return _eig6_op(H, float(thresh))
