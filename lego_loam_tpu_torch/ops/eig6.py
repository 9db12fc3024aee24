"""The degeneracy projection of a symmetric 6x6 system, P = V diag(lam >=
thresh) V^T (featureAssociation.cpp:1329-1356; counterpart of
``lego_loam_tpu.models.odometry._degeneracy_projection``).

On a CUDA tensor it is kernel E1 (``csrc/eig6.cu``): cyclic Jacobi in
float64 registers, one thread a matrix, P and the ascending eigenvalues
written back and V never.  torch.linalg.eigh on a CUDA tensor reads
cuSOLVER's info code back to the host, one host sync a call (5 a scan in
the odometry, 1 a mapping solve); the kernel makes none.  On a CPU tensor
it is :func:`degeneracy_projection_plain`, float32 eigh.  Both go through
the custom op ``lego::eig6``, whose vmap rule folds a vmapped batch into
the same launch (kernels/build.py).

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
    """(..., 6, 6) float32 -> (P (..., 6, 6), lam (..., 6) ascending) by
    float32 eigh of the symmetrised H (jnp's eigh symmetrises its input)."""
    lam, V = torch.linalg.eigh(0.5 * (H + H.mT))
    keep = (lam >= thresh).to(H.dtype)
    return (V * keep[..., None, :]) @ V.mT, lam


def eig6(H: torch.Tensor, thresh: float):
    """Kernel E1 on (B, 6, 6) float32 CUDA matrices.  Returns (P (B, 6, 6),
    lam (B, 6) ascending, sweeps (B,) int32: the Jacobi sweeps taken)."""
    B = H.shape[0]
    dev = H.device
    kb.require(H, "H", torch.float32, (B, 6, 6), dev)
    if B < 1:
        raise ValueError("eig6 needs at least one matrix")
    P = torch.empty((B, 6, 6), dtype=torch.float32, device=dev)
    lam = torch.empty((B, 6), dtype=torch.float32, device=dev)
    sweeps = torch.empty((B,), dtype=torch.int32, device=dev)
    kb.check(kb.library().lego_eig6(
        H.data_ptr(), float(thresh), P.data_ptr(), lam.data_ptr(),
        sweeps.data_ptr(), B, kb.stream_of(H)), "eig6")
    eig6.launches += 1
    return P, lam, sweeps


eig6.launches = 0


@torch.library.custom_op("lego::eig6", mutates_args=())
def _eig6_op(H: torch.Tensor, thresh: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., 6, 6) float32 -> (P (..., 6, 6), lam (..., 6)): one E1 launch
    for every matrix on a CUDA tensor, the plain version on a CPU tensor
    (once a matrix of a vmapped batch)."""
    if not H.is_cuda:
        return kb.per_element(degeneracy_projection_plain, H.dim() - 2, H, thresh)
    P, lam, _ = eig6(H.reshape(-1, 6, 6).contiguous(), thresh)
    return P.reshape(H.shape), lam.reshape(H.shape[:-1])


@_eig6_op.register_vmap
def _eig6_vmap(info, in_dims, H, thresh):
    return _eig6_op(*kb.batch_front(info, in_dims, H, thresh)), (0, 0)


def degeneracy_projection(H: torch.Tensor, thresh: float):
    """(6, 6) or (B, 6, 6) float32 -> (P, lam ascending) of the same batch
    shape: E1 on a CUDA tensor (no host sync), the plain version on a CPU
    tensor.  Under torch.func.vmap the batch joins the same launch."""
    return _eig6_op(H, float(thresh))
