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
Centroid sums are exact integer sums in fixed point (:data:`FIX_SCALE`): the
sorted points' coordinates as int64 multiples of 2^-24 m, one cumsum along
the sorted order, differenced at the group ends.  Integer addition does not
depend on the order the card adds in, so a run repeats itself bit for bit
and the card's centroids equal the CPU's (a float atomic sum would do
neither).  The JAX package's float32 segment_sum adds in order; centroids
agree with it to float32 rounding, not bitwise.
"""

from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF
# fixed-point unit of the centroid sums: 2^-24 (6e-8 m).  A sum of n
# points of magnitude below X stays under 2^63 while n X < 2^39, e.g. a
# million points within 500 km of the origin.
FIX_SCALE = float(2 ** 24)


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

    # group g holds the sorted points [start_g, end_g): exclusive prefix
    # sums of (count, fixed-point coordinates, aux) differenced there.  Out
    # of place, so it batches under torch.func.vmap.
    K = 0 if aux is None else aux.shape[-1]
    vals = sxyz
    if aux is not None:
        saux = torch.take_along_dim(aux.reshape(B, n, K), order[..., None], dim=1)
        vals = torch.cat([sxyz, saux], -1)
    fixed = torch.round(torch.where(sv[..., None], vals, 0.0).to(torch.float64)
                        * FIX_SCALE).to(torch.int64)
    cs = torch.cumsum(torch.cat([sv[..., None].to(torch.int64), fixed], -1), dim=1)
    cs = torch.cat([torch.zeros_like(cs[:, :1]), cs], 1)           # (B, n + 1, C)
    slot = torch.arange(out_cap, device=dev)
    # the slots as a (B, out_cap) tensor of gid's batch (under vmap too,
    # where an unbatched one would be expanded and copied)
    end = torch.searchsorted(gid, torch.zeros_like(gid[:, :1]) + slot, right=True)
    start = torch.cat([torch.zeros_like(end[:, :1]), end[:, :-1]], 1)
    C = cs.shape[-1]
    sums = (torch.gather(cs, 1, end[..., None].expand(B, out_cap, C))
            - torch.gather(cs, 1, start[..., None].expand(B, out_cap, C)))
    denom = torch.clamp(sums[..., :1], min=1).to(torch.float64) * FIX_SCALE
    means = (sums[..., 1:].to(torch.float64) / denom).to(torch.float32)

    n_groups = torch.where(sv, gid + 1, 0).amax(dim=1)            # (B,)
    valid_out = slot[None, :] < torch.clamp(n_groups, max=out_cap)[:, None]
    means = torch.where(valid_out[..., None], means, 0.0)
    xyz_out = means[..., :3].reshape(batch + (out_cap, 3))
    valid_out = valid_out.reshape(batch + (out_cap,))
    if aux is None:
        return xyz_out, valid_out
    return xyz_out, means[..., 3:].reshape(batch + (out_cap, K)), valid_out
