"""Voxel-grid downsampling (PCL VoxelGrid replacement; counterpart of
``lego_loam_tpu.ops.voxel``).

Centroid per occupied leaf, fixed-shape: sort by quantized voxel key,
segment-sum, keep the first out_cap groups.  The primary key is a
murmur-mixed hash of the voxel id, so the out_cap truncation drops a
pseudo-random subset of voxels; two secondary keys pack the exact quantized
coordinates (20 bits per axis), so voxel identity is exact.

The hash works in uint32 in the JAX package; torch's uint32 support is
thin, so here it runs in int64 masked to 32 bits after every multiply (a
wrapped int64 product keeps the correct low 32 bits).  The 3-key sort is a
stable sort by k2 followed by a stable sort by the int64 key (h << 31) | k1,
so voxel identity and drop order match the JAX package bit for bit.
Centroid sums use index_add_: on a CUDA tensor its atomics add in another
order than the JAX package's sorted segment_sum, so centroids agree to
float32 rounding, not bitwise.
"""

from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    return (a * c) & _M32


def _fmix32(h: torch.Tensor) -> torch.Tensor:
    """Murmur3 finalizer on uint32 values held in int64."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def _voxel_keys(xyz: torch.Tensor, valid: torch.Tensor, leaf: float,
                cls: torch.Tensor | None = None):
    """Sort keys for floor(xyz / leaf): (hash, exact-id lo, exact-id hi),
    each in [0, 2^30]; invalid rows get 2^30 in all three (sort last).
    `cls` (bool) offsets the quantized z by 2^18 so points of different
    class never share a voxel."""
    big = 2 ** 30
    q = torch.floor(xyz / leaf).to(torch.int32).to(torch.int64)
    if cls is not None:
        q = q.clone()
        q[..., 2] += torch.where(cls, 1 << 18, 0)
    qu = q & _M32                                 # two's complement as uint32
    q0, q1, q2 = qu[..., 0], qu[..., 1], qu[..., 2]
    mixed = (_mul32((_mul32(q0, 0x9E3779B1) + q1) & _M32, 0x85EBCA77) + q2) & _M32
    h = _fmix32(mixed) & ((1 << 30) - 1)
    m20, m10 = (1 << 20) - 1, (1 << 10) - 1
    k1 = ((q0 & m20) << 10) | (q1 & m10)
    k2 = (((q1 >> 10) & m10) << 20) | (q2 & m20)
    h = torch.where(valid, h, big)
    k1 = torch.where(valid, k1, big)
    k2 = torch.where(valid, k2, big)
    return h, k1, k2


def voxel_downsample(xyz: torch.Tensor, valid: torch.Tensor, leaf: float,
                     out_cap: int, aux: torch.Tensor | None = None,
                     cls: torch.Tensor | None = None):
    """Centroid-per-voxel downsample of a padded point set.

    xyz (..., N, 3), valid (..., N) bool; leading dims are independent
    batches (the per-ring downsample runs all rings at once).  aux
    (..., N, K) extra per-point features are averaged per voxel; cls
    (..., N) bool keeps classes apart.  Returns (xyz_out (..., out_cap, 3),
    valid_out (..., out_cap)) or (xyz_out, aux_out, valid_out) with aux."""
    batch = xyz.shape[:-2]
    n = xyz.shape[-2]
    xyz2 = xyz.reshape(-1, n, 3)
    B = xyz2.shape[0]
    dev = xyz.device
    h, k1, k2 = _voxel_keys(xyz2, valid.reshape(B, n), leaf,
                            None if cls is None else cls.reshape(B, n))
    # lexicographic (h, k1, k2): stable by k2, then stable by (h << 31) | k1
    o1 = torch.sort(k2, dim=1, stable=True).indices
    o2 = torch.sort(torch.gather((h << 31) | k1, 1, o1), dim=1, stable=True).indices
    order = torch.gather(o1, 1, o2)
    s1 = torch.gather(k1, 1, order)
    s2 = torch.gather(k2, 1, order)
    sv = torch.gather(valid.reshape(B, n), 1, order)
    sxyz = torch.take_along_dim(xyz2, order[..., None], dim=1)

    new_group = torch.ones_like(sv)
    new_group[:, 1:] = (s1[:, 1:] != s1[:, :-1]) | (s2[:, 1:] != s2[:, :-1])
    gid = torch.cumsum(new_group.to(torch.int64), dim=1) - 1     # (B, n)
    flat_gid = (gid + torch.arange(B, device=dev)[:, None] * n).reshape(-1)

    svf = sv.to(torch.float32).reshape(-1)
    counts = torch.zeros(B * n, dtype=torch.float32, device=dev)
    counts.index_add_(0, flat_gid, svf)
    sums = torch.zeros(B * n, 3, dtype=torch.float32, device=dev)
    sums.index_add_(0, flat_gid, sxyz.reshape(-1, 3) * svf[:, None])
    denom = torch.clamp(counts, min=1.0)[:, None]
    centroids = (sums / denom).reshape(B, n, 3)

    n_groups = torch.where(sv, gid + 1, 0).amax(dim=1)            # (B,)
    slot = torch.arange(out_cap, device=dev)
    valid_out = slot[None, :] < torch.clamp(n_groups, max=out_cap)[:, None]
    pick = slot.clamp(max=n - 1)
    xyz_out = torch.where(valid_out[..., None], centroids[:, pick], 0.0)
    xyz_out = xyz_out.reshape(batch + (out_cap, 3))
    valid_out = valid_out.reshape(batch + (out_cap,))
    if aux is None:
        return xyz_out, valid_out
    K = aux.shape[-1]
    saux = torch.take_along_dim(aux.reshape(B, n, K), order[..., None], dim=1)
    aux_sums = torch.zeros(B * n, K, dtype=torch.float32, device=dev)
    aux_sums.index_add_(0, flat_gid, saux.reshape(-1, K) * svf[:, None])
    aux_out = (aux_sums / denom).reshape(B, n, K)[:, pick]
    aux_out = torch.where(valid_out.reshape(B, out_cap)[..., None], aux_out, 0.0)
    return xyz_out, aux_out.reshape(batch + (out_cap, K)), valid_out
