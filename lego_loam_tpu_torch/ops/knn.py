"""Batched nearest-neighbour search (PCL KdTreeFLANN replacement;
counterpart of ``lego_loam_tpu.ops.knn``).

Dense brute force: ||q - r||^2 = |q|^2 + |r|^2 - 2 q.r, then a masked
argmin (odometry associations) or an exact k-NN (map 5-NN).  The exact
k-NN is kernel K3 (``csrc/knn.cu``) on a CUDA tensor; on a CPU tensor it is
the distance matrix plus the first k columns of a stable sort, which break
ties to the lowest index like ``lax.top_k`` (over the valid references and
distinct queries alone, :func:`knn_plain_valid`).

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
    rr = torch.sum(ref * ref, dim=1)
    idx, d2 = [], []
    for q0 in range(0, Q, step):
        # sq_dist_matrix's values, computed in place (two (Q, N) buffers)
        q = query[q0: q0 + step]
        d = torch.sum(q * q, dim=1, keepdim=True) + rr[None, :]
        d.sub_((2.0 * q) @ ref.T).clamp_(min=0.0)
        d.masked_fill_(~ref_valid[None, :], _INF)
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


def distinct_rows(x: torch.Tensor):
    """(rows, inverse) of a (Q, 3) tensor: its distinct rows (in
    lexicographic order) and, for each row of x, its index among them; -0.0
    equals 0.0 and a row with a NaN stands alone."""
    order = torch.arange(x.shape[0], device=x.device)
    for c in (2, 1, 0):                     # a stable sort a column: lexsort
        order = order[torch.sort(x[order, c], stable=True).indices]
    xs = x[order]
    first = torch.ones(x.shape[0], dtype=torch.bool, device=x.device)
    first[1:] = (xs[1:] != xs[:-1]).any(1)
    inv = torch.empty_like(order)
    inv[order] = torch.cumsum(first, 0) - 1
    return xs[first], inv


def knn_plain_valid(query, ref, ref_valid, k: int, query_tile: int = 0):
    """knn_plain's answer from the valid references and the distinct query
    rows alone (a CPU tensor's path: dynamic shapes, no device to keep in
    step): the same neighbours in the same order, ties to the lowest index,
    and, past the valid references, the lowest invalid indices at 1e30.
    The distance matrix shrinks to (distinct queries) x (valid references):
    a loop check's ICP asks 4352 x 16384 and needs ~2100 x ~5700.  Each
    distance is the same formula; MKL's sgemm rounds the 3-term dot alike at
    both shapes (a test holds the two bit-equal at the pipelines' shapes;
    with a handful of valid references its small-matrix path may round the
    last bit otherwise)."""
    if not 1 <= k <= ref.shape[0]:
        raise ValueError(f"knn needs 1 <= k <= N = {ref.shape[0]}, got {k}")
    Q = query.shape[0]
    vi = torch.nonzero(ref_valid).flatten()
    kk = min(k, vi.numel())
    idx = torch.empty((Q, 0), dtype=torch.int32, device=query.device)
    d2 = torch.empty((Q, 0), dtype=query.dtype, device=query.device)
    if kk and Q:
        rows, inv = distinct_rows(query)
        i, d = knn_plain(rows, ref.index_select(0, vi),
                         torch.ones_like(vi, dtype=torch.bool), kk, query_tile)
        idx, d2 = vi[i.long()].to(torch.int32)[inv], d[inv]
    if kk < k:
        pad = torch.nonzero(~ref_valid).flatten()[: k - kk].to(torch.int32)
        idx = torch.cat([idx, pad.expand(Q, -1)], 1)
        d2 = torch.cat([d2, torch.full((Q, k - kk), _INF, dtype=d2.dtype,
                                       device=d2.device)], 1)
    return idx, d2


def knn_splits(Q: int, N: int, B: int = 1) -> int:
    """Reference splits S of K3's grid for a batch of B searches of Q
    queries and N references: the most that keep (query tiles x S x B) <=
    TARGET_BLOCKS, one wave of blocks that all run at once, with at least
    MIN_SPLIT references a split (so S = 1 for N < 2 * MIN_SPLIT) and none
    empty.  Fewer splits mean fewer per-split lists to fill and merge.  The
    kernel's splits are ceil(N / S) references long."""
    tiles = -(-Q // QUERY_TILE) * B
    s = max(1, min(TARGET_BLOCKS // tiles, N // MIN_SPLIT))
    return -(-N // -(-N // s))


def knn(query, ref, ref_valid, k: int, query_tile: int = 0):
    """k nearest neighbours per query point (K3 on CUDA tensors).

    query (..., Q, 3) f32, ref (..., N, 3) f32, ref_valid (..., N) bool,
    1 <= k <= 8; leading dimensions are independent searches.  Returns
    (idx (..., Q, k) int32, d2 (..., Q, k) f32), ascending; invalid refs
    rank last with d2 ~ 1e30.  CPU tensors run :func:`knn_plain_valid` a
    search at a time (query_tile bounds its memory; the kernel needs no
    tiling).
    Under torch.func.vmap the batch goes into the same launch."""
    return _knn_op(query, ref, ref_valid, int(k), int(query_tile))


@torch.library.custom_op("lego::knn", mutates_args=())
def _knn_op(query: torch.Tensor, ref: torch.Tensor, ref_valid: torch.Tensor,
            k: int, query_tile: int) -> tuple[torch.Tensor, torch.Tensor]:
    if query.is_cuda:
        return _launch_knn(query, ref, ref_valid, k)
    return kb.per_element(knn_plain_valid, query.dim() - 2, query, ref, ref_valid,
                          k, query_tile)


@_knn_op.register_vmap
def _knn_vmap(info, in_dims, *args):
    args = [a.contiguous() if isinstance(a, torch.Tensor) else a
            for a in kb.batch_front(info, in_dims, *args)]
    return _knn_op(*args), (0, 0)


def _launch_knn(query, ref, ref_valid, k: int):
    """K3 on a (..., Q, 3) x (..., N, 3) batch: one launch of its split pass
    (and one of its merge pass) for every search of the batch."""
    if not 1 <= k <= MAX_K:
        raise ValueError(f"knn kernel supports 1 <= k <= {MAX_K}, got {k}")
    Q, N = query.shape[-2], ref.shape[-2]
    lead = tuple(query.shape[:-2])
    dev = query.device
    if Q == 0 or N == 0:
        raise ValueError(f"knn kernel needs Q, N >= 1, got {Q}, {N}")
    kb.require(query, "query", torch.float32, lead + (Q, 3), dev)
    kb.require(ref, "ref", torch.float32, lead + (N, 3), dev)
    kb.require(ref_valid, "ref_valid", torch.bool, lead + (N,), dev)
    B = query.numel() // (3 * Q)
    S = knn_splits(Q, N, B)
    # per-split (rank, index) lists of the first pass, merged by the second
    scratch = (torch.empty((2, B, S, k, Q), dtype=torch.float32, device=dev)
               if S > 1 else None)
    idx = torch.empty(lead + (Q, k), dtype=torch.int32, device=dev)
    d2 = torch.empty(lead + (Q, k), dtype=torch.float32, device=dev)
    kb.check(kb.library().lego_knn(
        query.data_ptr(), ref.data_ptr(), ref_valid.data_ptr(), B, Q, N, k, S,
        None if scratch is None else scratch.data_ptr(), idx.data_ptr(),
        d2.data_ptr(), kb.stream_of(query)), "knn")
    knn.launches += 1
    return idx, d2


knn.launches = 0
