"""The odometry's scan-to-scan correspondence search
(featureAssociation.cpp:1052-1104 and 1163-1226; the searches of
``lego_loam_tpu.models.odometry._assoc_corner``, ``_assoc_surf`` and
``_assoc_surf_knn``).

One call answers one association: for each query the picks of fixed slots,
    0. the nearest reference;
    1, 2. the two nearest in the same ring as slot 0's reference, slot 0's
       reference excluded;
    3, 4. the two nearest in an adjacent ring (0 < |dr| <= 2 from slot 0's
       ring);
each as `masked_argmin` over `sq_dist_matrix`'s row takes it: ties to the
lower index, a NaN distance first, an invalid reference or one outside the
category at 1e30, so a slot without a candidate holds (0, 1e30).  Ground
labels for both sides turn on the class gate, which every slot obeys.

The kind says which slots the caller reads, and only those are searched:
"corner" 0 and 3, "tri" 0, 1 and 3, "knn" all five; the others hold
(0, 1e30).

On a CUDA tensor the search is kernel K4 (``csrc/assoc.cu``), one launch
for the whole batch and no (Q, N) matrix; on a CPU tensor it is
:func:`assoc_plain`, the distance matrix and a chain of `masked_argmin`
calls.  Both go through the custom op ``lego::odom_assoc``, whose vmap rule
folds a vmapped batch into the same launch (kernels/build.py).
"""

from __future__ import annotations

import torch

from lego_loam_tpu_torch.kernels import build as kb
from lego_loam_tpu_torch.ops.knn import masked_argmin, sq_dist_matrix

_INF = 1.0e30
SLOTS = 5
# (same-ring picks, adjacent-ring picks) each kind searches
KINDS = {"corner": (0, 1), "tri": (1, 1), "knn": (2, 2)}
BLOCK_THREADS = 128     # a block of K4 (assoc.cu kThreads)
MIN_BLOCKS = 2 * 132    # more lanes a query below two blocks an H100 SM


def assoc_plain(query, ref, ref_valid, ref_ring, query_ground, ref_ground,
                kind: str):
    """The search from the (Q, N) distance matrix: (idx (Q, 5) int32,
    d2 (Q, 5)).  Each slot is one `masked_argmin` over the gated matrix,
    in the order the odometry took them."""
    n_same, n_adj = KINDS[kind]
    d2 = sq_dist_matrix(query, ref, ref_valid)
    if query_ground is not None:
        d2 = torch.where(ref_ground[None, :] == query_ground[:, None], d2, _INF)
    Q, N = d2.shape
    none = (torch.zeros(Q, dtype=torch.int64, device=d2.device),
            torch.full((Q,), _INF, dtype=d2.dtype, device=d2.device))
    slots = [masked_argmin(d2)] + [none] * (SLOTS - 1)
    i1 = slots[0][0]
    cols = torch.arange(N, device=d2.device)[None, :]
    dr = ref_ring[None, :] - ref_ring[i1][:, None]
    if n_same:
        same = (dr == 0) & (cols != i1[:, None])
        slots[1] = masked_argmin(d2, same)
        if n_same > 1:
            slots[2] = masked_argmin(d2, same & (cols != slots[1][0][:, None]))
    adj = (dr != 0) & (dr.abs() <= 2)
    slots[3] = masked_argmin(d2, adj)
    if n_adj > 1:
        slots[4] = masked_argmin(d2, adj & (cols != slots[3][0][:, None]))
    return (torch.stack([i for i, _ in slots], 1).to(torch.int32),
            torch.stack([v for _, v in slots], 1))


def assoc(query, ref, ref_valid, ref_ring, kind: str, query_ground=None,
          ref_ground=None):
    """The picks of one association (K4 on CUDA tensors).

    query (..., Q, 3) f32, ref (..., N, 3) f32, ref_valid (..., N) bool,
    ref_ring (..., N) int32, kind "corner", "tri" or "knn"; query_ground
    (..., Q) and ref_ground (..., N) bool, both or neither (the class
    gate); leading dimensions are independent searches.  Returns (idx
    (..., Q, 5) int32, d2 (..., Q, 5) f32) in the slots of the module's
    docstring.  Under torch.func.vmap the batch goes into the same
    launch."""
    if kind not in KINDS:
        raise ValueError(f"assoc kind must be one of {tuple(KINDS)}, got {kind!r}")
    if (query_ground is None) != (ref_ground is None):
        raise ValueError("assoc's class gate needs both ground labels or neither")
    return _assoc_op(query, ref, ref_valid, ref_ring, query_ground, ref_ground, kind)


@torch.library.custom_op("lego::odom_assoc", mutates_args=())
def _assoc_op(query: torch.Tensor, ref: torch.Tensor, ref_valid: torch.Tensor,
              ref_ring: torch.Tensor, query_ground: torch.Tensor | None,
              ref_ground: torch.Tensor | None,
              kind: str) -> tuple[torch.Tensor, torch.Tensor]:
    if query.is_cuda:
        return _launch_assoc(query, ref, ref_valid, ref_ring, query_ground,
                             ref_ground, kind)
    return kb.per_element(assoc_plain, query.dim() - 2, query, ref, ref_valid,
                          ref_ring, query_ground, ref_ground, kind)


@_assoc_op.register_vmap
def _assoc_vmap(info, in_dims, *args):
    args = [a.contiguous() if isinstance(a, torch.Tensor) else a
            for a in kb.batch_front(info, in_dims, *args)]
    return _assoc_op(*args), (0, 0)


def query_split(Q: int, B: int) -> int:
    """Lanes (threads) a query of K4 for B searches of Q queries: 1, or the
    fewest of 2, 4, ..., 32 that give the grid MIN_BLOCKS blocks (one
    sequence's search, as LegoLoamPipeline makes it, then spreads over the
    SMs: lane s of a query takes references s, s + S, ..., and the lanes
    merge their picks, the same picks at every S)."""
    s = 1
    while s < 32 and -(-Q * s // BLOCK_THREADS) * B < MIN_BLOCKS:
        s *= 2
    return s


def _launch_assoc(query, ref, ref_valid, ref_ring, query_ground, ref_ground,
                  kind: str, split: int | None = None):
    """K4 on a (..., Q, 3) x (..., N, 3) batch: one launch for every search
    of the batch, `split` lanes a query (query_split's by default)."""
    n_same, n_adj = KINDS[kind]
    Q, N = query.shape[-2], ref.shape[-2]
    lead = tuple(query.shape[:-2])
    dev = query.device
    if Q == 0 or N == 0:
        raise ValueError(f"assoc kernel needs Q, N >= 1, got {Q}, {N}")
    kb.require(query, "query", torch.float32, lead + (Q, 3), dev)
    kb.require(ref, "ref", torch.float32, lead + (N, 3), dev)
    kb.require(ref_valid, "ref_valid", torch.bool, lead + (N,), dev)
    kb.require(ref_ring, "ref_ring", torch.int32, lead + (N,), dev)
    if query_ground is not None:
        kb.require(query_ground, "query_ground", torch.bool, lead + (Q,), dev)
        kb.require(ref_ground, "ref_ground", torch.bool, lead + (N,), dev)
    B = query.numel() // (3 * Q)
    idx = torch.empty(lead + (Q, SLOTS), dtype=torch.int32, device=dev)
    d2 = torch.empty(lead + (Q, SLOTS), dtype=torch.float32, device=dev)
    kb.check(kb.library().lego_odom_assoc(
        query.data_ptr(), ref.data_ptr(), ref_valid.data_ptr(), ref_ring.data_ptr(),
        None if query_ground is None else query_ground.data_ptr(),
        None if ref_ground is None else ref_ground.data_ptr(),
        B, Q, N, n_same, n_adj, split or query_split(Q, B), idx.data_ptr(), d2.data_ptr(),
        kb.stream_of(query)), "odom_assoc")
    assoc.launches += 1
    return idx, d2


assoc.launches = 0
