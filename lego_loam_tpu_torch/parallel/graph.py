"""Edge-sharded pose-graph optimisation (counterpart of
``lego_loam_tpu.parallel.graph``).

The graph's factors -- the odometry chain, the loop edges and the prior on
pose 0 -- form one padded edge list, sharded by rows across the ranks.
Each rank linearises its edges into 6x6 Jacobian blocks and accumulates
its partial normal-equation blocks (tridiagonal chain blocks, loop blocks,
gradient); one all-reduce combines them, and the exact block cyclic
reduction + Woodbury solve of models/posegraph.py then runs replicated on
every rank.  The poses (K x 6 dof) are small next to the edge work, so
replicating the solve costs little while the per-edge work, which grows
with the trajectory, spreads over the ranks.

The accumulation uses no float atomics, so a rank's partial blocks do not
depend on the order a card adds in: every chain edge has its own src and
its own dst pose, the loop edges their own slot, and rows with nothing to
add there (inactive, padding, loop rows for the chain blocks) write to a
dummy row past the end.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from lego_loam_tpu_torch.config import PipelineConfig
from lego_loam_tpu_torch.models.mapping import MappingState
from lego_loam_tpu_torch.models.posegraph import (
    _apply_delta,
    _mv,
    _vee_chordal,
    direct_gn_delta,
    edge_blocks,
)
from lego_loam_tpu_torch.parallel.comm import Comm


class EdgeList(NamedTuple):
    """Unified padded factor list.  E rows; kind 0 = inactive, 1 = between,
    2 = prior.  `tri` marks chain edges (their src-dst coupling block lands
    in the tridiagonal part of the normal matrix); `lslot` is the loop-edge
    slot of a loop row (its coupling is the Woodbury low-rank correction),
    -1 otherwise."""

    src: torch.Tensor       # (E,) int64 pose index i
    dst: torch.Tensor       # (E,) int64 pose index j
    Z_R: torch.Tensor       # (E, 3, 3) measured relative rotation
    Z_t: torch.Tensor       # (E, 3)
    w_rot: torch.Tensor     # (E,)
    w_trans: torch.Tensor   # (E,)
    kind: torch.Tensor      # (E,) int32
    tri: torch.Tensor       # (E,) bool
    lslot: torch.Tensor     # (E,) int64


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def build_edge_list(state: MappingState, cfg: PipelineConfig,
                    pad_to: int | None = None) -> EdgeList:
    """Chain + loop + prior factors as one padded list: rows [0, K) the
    chain (row k the edge k-1 -> k, row 0 inactive), [K, K + L) the loop
    slots, row K + L the prior, then padding to `pad_to` (default: K + L + 1
    rounded up to 8)."""
    K, L = cfg.max_keyframes, cfg.max_loop_edges
    E = pad_to or _round_up(K + L + 1, 8)
    dev = state.kf_t.device
    f32 = dict(dtype=torch.float32, device=dev)

    idx = torch.arange(K, device=dev)
    chain_active = (idx >= 1) & (idx < state.n_kf)
    loop_active = torch.arange(L, device=dev) < state.n_loops
    lw = torch.sqrt(torch.clamp(state.loop_w, min=0.0))
    w_prior = torch.full((1,), 1.0 / cfg.pg_prior_sigma, **f32)

    def pad(a, fill=0):
        tail = torch.full((E - a.shape[0],) + a.shape[1:], fill, dtype=a.dtype,
                          device=dev)
        return torch.cat([a, tail])

    return EdgeList(
        src=pad(torch.cat([torch.clamp(idx - 1, min=0), state.loop_i.long(),
                           torch.zeros(1, dtype=torch.int64, device=dev)])),
        dst=pad(torch.cat([idx, state.loop_j.long(),
                           torch.zeros(1, dtype=torch.int64, device=dev)])),
        Z_R=pad(torch.cat([state.kf_meas_R, state.loop_R, torch.eye(3, **f32)[None]])),
        Z_t=pad(torch.cat([state.kf_meas_t, state.loop_t, torch.zeros((1, 3), **f32)])),
        w_rot=pad(torch.cat([torch.where(chain_active, 1.0 / cfg.pg_rot_sigma, 0.0),
                             torch.where(loop_active, lw, 0.0), w_prior])),
        w_trans=pad(torch.cat([torch.where(chain_active, 1.0 / cfg.pg_trans_sigma, 0.0),
                               torch.where(loop_active, lw, 0.0), w_prior])),
        kind=pad(torch.cat([chain_active.to(torch.int32), loop_active.to(torch.int32),
                            torch.full((1,), 2, dtype=torch.int32, device=dev)])),
        tri=pad(torch.cat([chain_active, torch.zeros(L + 1, dtype=torch.bool,
                                                     device=dev)])),
        lslot=pad(torch.cat([torch.full((K,), -1, dtype=torch.int64, device=dev),
                             torch.arange(L, device=dev),
                             torch.full((1,), -1, dtype=torch.int64, device=dev)]),
                  fill=-1),
    )


def shard_edges(edges: EdgeList, rank: int, size: int) -> EdgeList:
    """Rank `rank`'s rows [rank E / size, (rank + 1) E / size)."""
    n = edges.src.shape[0] // size
    return EdgeList(*(f[rank * n:(rank + 1) * n] for f in edges))


def edge_residuals(edges: EdgeList, R, t):
    """(E, 6) weighted residual rows from replicated poses."""
    Ri, ti = R[edges.src], t[edges.src]
    Rj, tj = R[edges.dst], t[edges.dst]
    Ri_T, ZR_T = Ri.transpose(-1, -2), edges.Z_R.transpose(-1, -2)
    E_R = ZR_T @ (Ri_T @ Rj)
    E_t = _mv(ZR_T, _mv(Ri_T, tj - ti) - edges.Z_t)
    w_r, w_t = edges.w_rot[:, None], edges.w_trans[:, None]
    r_between = torch.cat([_vee_chordal(E_R) * w_r, E_t * w_t], -1)
    # prior: pins the dst pose at its chart origin
    r_prior = torch.cat([_vee_chordal(Rj) * w_r, tj * w_t], -1)
    r = torch.where((edges.kind == 2)[:, None], r_prior, r_between)
    return r * (edges.kind > 0)[:, None]


def _place(rows: torch.Tensor, to: torch.Tensor, n: int) -> torch.Tensor:
    """(n, ...) zeros with rows[e] at row to[e]; every target below n is
    written by one row at most, and index n (dropped) takes the rest."""
    out = torch.zeros((n + 1,) + rows.shape[1:], dtype=rows.dtype, device=rows.device)
    return out.index_put_((to,), rows)[:n]


def _accumulate_blocks(edges: EdgeList, R, t, K: int, L: int):
    """Partial normal blocks of these edges: (D, U, b, A, B, r_loop), all
    additive, so a sum over the ranks gives the whole graph's.  The loop
    rows' gradient is left out of b (direct_gn_delta folds it from A, B and
    r_loop)."""
    is_prior = edges.kind == 2
    is_loop = edges.lslot >= 0
    r, Ji, Jj = edge_blocks(R[edges.src], t[edges.src], R[edges.dst], t[edges.dst],
                            edges.Z_R, edges.Z_t, edges.w_rot, edges.w_trans,
                            is_prior)
    JiT, JjT = Ji.transpose(-1, -2), Jj.transpose(-1, -2)
    # the rows with a block to add: an active chain edge at both poses (its
    # src and dst are its own), the prior at pose 0 (its Ji is zero), a loop
    # edge in its slot; inactive rows have zero weights and add nothing
    at_src = torch.where(edges.tri, edges.src, K)
    at_dst = torch.where(edges.tri | is_prior, edges.dst, K)
    at_slot = torch.where(is_loop, edges.lslot, L)
    D = _place(JiT @ Ji, at_src, K) + _place(JjT @ Jj, at_dst, K)
    U = _place(JiT @ Jj, at_src, K)
    b = _place(-_mv(JiT, r), at_src, K) + _place(-_mv(JjT, r), at_dst, K)
    return (D, U, b, _place(Ji, at_slot, L), _place(Jj, at_slot, L),
            _place(r, at_slot, L))


def _gn_step_from_shard(edges: EdgeList, R, t, li, lj, pose_active,
                        cfg: PipelineConfig, comm: Comm):
    """One exact GN step from an edge shard: the block reductions summed
    over the ranks by one all-reduce, then the direct solve (replicated)
    and the cost guard, whose two partial costs take a second one."""
    K, L = R.shape[0], li.shape[0]
    D, U, b, A, B_loop, r_loop = comm.all_reduce_sum(
        *_accumulate_blocks(edges, R, t, K, L))
    # inactive poses get an identity block so the factorization stays SPD
    D = D + torch.where(pose_active, 0.0, 1.0)[:, None, None] * torch.eye(
        6, dtype=D.dtype, device=D.device)
    x = direct_gn_delta(D, U, A, B_loop, li, lj, r_loop, b, cfg.pg_damping)
    R2, t2 = _apply_delta(R, t, x)

    # cost guard (models/posegraph.solve_pose_graph's): take the float32
    # step only if it lowers the true graph cost
    def cost(R_, t_):
        r = edge_residuals(edges, R_, t_)
        return torch.sum(r * r)

    c2, c = comm.all_reduce_sum(torch.stack([cost(R2, t2), cost(R, t)]))[0]
    ok = c2 < c
    return torch.where(ok, R2, R), torch.where(ok, t2, t)


def solve_pose_graph_sharded(state: MappingState, cfg: PipelineConfig, comm: Comm):
    """Edge-sharded solve: the poses replicate, the edges (padded to a
    multiple of 8 x the world size) shard by rows, and each of the
    pg_gn_iters GN steps makes two all-reduces.  Returns the keyframe poses
    (R (K, 3, 3), t (K, 3)), the same on every rank."""
    K = cfg.max_keyframes
    E = _round_up(K + cfg.max_loop_edges + 1, 8 * comm.size)
    edges = shard_edges(build_edge_list(state, cfg, pad_to=E), comm.rank, comm.size)
    pose_active = torch.arange(K, device=state.kf_t.device) < state.n_kf
    R, t = state.kf_R, state.kf_t
    for _ in range(cfg.pg_gn_iters):
        R, t = _gn_step_from_shard(edges, R, t, state.loop_i, state.loop_j,
                                   pose_active, cfg, comm)
    return R, t


def solve_pose_graph_single(state: MappingState, cfg: PipelineConfig):
    """The edge-list solve on one device: the sharded solve in a world of
    one."""
    return solve_pose_graph_sharded(state, cfg, Comm.solo())
