"""Map-sharded nearest-neighbour search (counterpart of
``lego_loam_tpu.parallel.map_sharded``).

The reference set (the local map of scan-to-map association) is split into
equal shards, one a rank; the queries are the same on every rank.  Each
rank runs the exact k-NN -- kernel K3 on a CUDA tensor -- against its own
shard, the ranks all-gather their k candidates a query, and a merge keeps
the global k, so the distance matrix never forms on one device.
"""

from __future__ import annotations

import torch

from lego_loam_tpu_torch.ops.knn import knn
from lego_loam_tpu_torch.parallel.comm import Comm


def merge_candidates(d2: torch.Tensor, payload: torch.Tensor, k: int):
    """The k smallest of every rank's candidates: d2 (W, Q, k'), payload
    (W, Q, k', C) -> (d2 (Q, k), payload (Q, k, C)).  Ties go to the lowest
    flat index of the (Q, W k') layout, ranks major, as lax.top_k breaks
    them (a stable sort; torch.topk does not promise an order).  One rank's
    candidates come back as they are."""
    W, Q = d2.shape[:2]
    if W == 1:
        return d2[0, :, :k], payload[0, :, :k]
    d2 = d2.transpose(0, 1).reshape(Q, -1)
    payload = payload.transpose(0, 1).reshape(Q, d2.shape[1], -1)
    sel = torch.sort(d2, dim=1, stable=True).indices[:, :k]
    return (torch.gather(d2, 1, sel),
            torch.gather(payload, 1, sel[..., None].expand(-1, -1, payload.shape[-1])))


def knn_sharded(query, shard_pts, shard_valid, k: int, comm: Comm,
                query_tile: int = 0):
    """Global k-NN with the reference set sharded over the ranks.

    query (Q, 3), the same on every rank; shard_pts (M / W, 3) and
    shard_valid this rank's rows [rank M / W, (rank + 1) M / W) of the
    (M, 3) map.  Returns (idx (Q, k) int32 into the whole map, d2 (Q, k)),
    the same on every rank; one all-gather, of the indices and the
    distances' bits packed together."""
    li, ld2 = knn(query, shard_pts, shard_valid, k, query_tile)
    gi = li + comm.rank * shard_pts.shape[0]
    both = comm.all_gather(torch.stack([gi, ld2.view(torch.int32)], -1))
    d2, idx = merge_candidates(both[..., 1].view(torch.float32), both[..., :1], k)
    return idx[..., 0], d2
