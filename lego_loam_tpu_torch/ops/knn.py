"""Batched nearest-neighbour search (PCL KdTreeFLANN replacement;
counterpart of ``lego_loam_tpu.ops.knn``).

Dense brute force: ||q - r||^2 = |q|^2 + |r|^2 - 2 q.r, then a masked
argmin (odometry associations) or an exact k-NN (map 5-NN).  The exact
k-NN is kernel K3 (``csrc/knn.cu``) on a CUDA tensor; on a CPU tensor it is
the distance matrix plus the first k columns of a stable sort, which break
ties to the lowest index like ``lax.top_k``.

K3 splits the reference set across blocks and merges the per-split top-k
lists in a second pass; :func:`knn_splits` picks the split count.
"""

from __future__ import annotations

import torch

from lego_loam_tpu_torch.kernels import build as kb

_INF = 1.0e30
MAX_K = 8
QUERY_TILE = 128        # queries a block of K3's first pass (knn.cu kThreads)
MIN_SPLIT = 256         # fewest references a split
TARGET_BLOCKS = 4 * 132     # up to 4 blocks on each of an H100's 132 SMs


def sq_dist_matrix(query: torch.Tensor, ref: torch.Tensor,
                   ref_valid: torch.Tensor) -> torch.Tensor:
    """(Q, 3) x (N, 3) -> (Q, N) squared distances; invalid refs get 1e30."""
    qq = torch.sum(query * query, dim=1, keepdim=True)
    rr = torch.sum(ref * ref, dim=1)
    d2 = torch.clamp(qq + rr[None, :] - (2.0 * query) @ ref.T, min=0.0)
    return torch.where(ref_valid[None, :], d2, _INF)


def masked_argmin(d2: torch.Tensor, mask: torch.Tensor | None = None):
    """Row-wise argmin (first index on ties) with an optional (Q, N) mask.
    Returns (idx int64, val)."""
    if mask is not None:
        d2 = torch.where(mask, d2, _INF)
    idx = torch.argmin(d2, dim=1)
    return idx, torch.gather(d2, 1, idx[:, None])[:, 0]


def knn_plain(query, ref, ref_valid, k: int, query_tile: int = 0):
    """Exact k-NN from the distance matrix, in query tiles of `query_tile`
    rows (0 = one tile).  Returns (idx (Q, k) int32, d2 (Q, k)) ascending,
    ties to the lowest index (a stable sort's first k columns).  Needs
    1 <= k <= N, as ``lax.top_k`` does."""
    if not 1 <= k <= ref.shape[0]:
        raise ValueError(f"knn needs 1 <= k <= N = {ref.shape[0]}, got {k}")
    Q = query.shape[0]
    step = query_tile if query_tile and Q > query_tile else max(Q, 1)
    idx, d2 = [], []
    for q0 in range(0, Q, step):
        d = sq_dist_matrix(query[q0: q0 + step], ref, ref_valid)
        # the first k columns of a stable sort, as k passes of "take the
        # first minimum, then rule it out" (several times cheaper)
        cols = []
        for _ in range(k):
            i, v = masked_argmin(d)
            d.scatter_(1, i[:, None], float("inf"))
            cols.append((i, v))
        idx.append(torch.stack([i for i, _ in cols], 1).to(torch.int32))
        d2.append(torch.stack([v for _, v in cols], 1))
    return torch.cat(idx), torch.cat(d2)


def knn_splits(Q: int, N: int) -> int:
    """Reference splits S of K3's grid for Q queries and N references: the
    most that keep (query tiles x S) <= TARGET_BLOCKS, one wave of blocks
    that all run at once, with at least MIN_SPLIT references a split (so
    S = 1 for N < 2 * MIN_SPLIT) and none empty.  Fewer splits mean fewer
    per-split lists to fill and merge.  The kernel's splits are
    ceil(N / S) references long."""
    tiles = -(-Q // QUERY_TILE)
    s = max(1, min(TARGET_BLOCKS // tiles, N // MIN_SPLIT))
    return -(-N // -(-N // s))


def knn(query, ref, ref_valid, k: int, query_tile: int = 0):
    """k nearest neighbours per query point (K3 on CUDA tensors).

    query (Q, 3) f32, ref (N, 3) f32, ref_valid (N,) bool, 1 <= k <= 8.
    Returns (idx (Q, k) int32, d2 (Q, k) f32), ascending; invalid refs rank
    last with d2 ~ 1e30.  CPU tensors run :func:`knn_plain` (query_tile
    bounds its memory; the kernel needs no tiling)."""
    if not query.is_cuda:
        return knn_plain(query, ref, ref_valid, k, query_tile)
    if not 1 <= k <= MAX_K:
        raise ValueError(f"knn kernel supports 1 <= k <= {MAX_K}, got {k}")
    Q, N = query.shape[0], ref.shape[0]
    dev = query.device
    if Q == 0 or N == 0:
        raise ValueError(f"knn kernel needs Q, N >= 1, got {Q}, {N}")
    kb.require(query, "query", torch.float32, (Q, 3), dev)
    kb.require(ref, "ref", torch.float32, (N, 3), dev)
    kb.require(ref_valid, "ref_valid", torch.bool, (N,), dev)
    S = knn_splits(Q, N)
    # per-split (rank, index) lists of the first pass, merged by the second
    scratch = (torch.empty((2, S, k, Q), dtype=torch.float32, device=dev)
               if S > 1 else None)
    idx = torch.empty((Q, k), dtype=torch.int32, device=dev)
    d2 = torch.empty((Q, k), dtype=torch.float32, device=dev)
    kb.check(kb.library().lego_knn(
        query.data_ptr(), ref.data_ptr(), ref_valid.data_ptr(), Q, N, k, S,
        None if scratch is None else scratch.data_ptr(), idx.data_ptr(),
        d2.data_ptr(), kb.stream_of(query)), "knn")
    knn.launches += 1
    return idx, d2


knn.launches = 0
