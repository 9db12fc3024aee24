"""SE(3) pose-graph optimization (gtsam/iSAM2 replacement; counterpart of
``lego_loam_tpu.models.posegraph``; mapOptmization.cpp:229-232, 1376-1398,
939-941).

The graph is a prior on pose 0, the odometry chain edges of the keyframe
pool and the padded loop edges.  Each Gauss-Newton step is solved directly:
the chain + prior normal matrix is block-tridiagonal (6x6 blocks) and is
factorized by block cyclic reduction, log2(K) levels of batched 6x6 work;
the loop edges are a low-rank correction folded in by the Woodbury
identity.  Every step is accepted only if it lowers the true graph cost.
That guard is a ``torch.where`` on the device, so a solve never waits on
the card.

Rotation residuals use the chordal form 0.5 * vee(E - E^T).  The per-edge
6x6 Jacobians are written out in closed form: the JAX package takes them
with ``jax.jacfwd``; at the zero tangent both are the same derivative
(``_edge_residual_chart`` is the function they differentiate).

The 6x6 inverses and the Woodbury solve use ``inv_ex`` / ``solve_ex``
without error checks: the checked forms read an info code back to the host
on every call on a CUDA tensor.  A non-finite step is zeroed instead.
"""

from __future__ import annotations

import torch

from lego_loam_tpu_torch.config import PipelineConfig
from lego_loam_tpu_torch.models.mapping import MappingState
from lego_loam_tpu_torch.utils.math3d import Pose, hat, so3_exp


def _vee_chordal(E: torch.Tensor) -> torch.Tensor:
    """0.5 * vee(E - E^T): smooth rotation residual, ~ axis*sin(angle)."""
    return 0.5 * torch.stack([
        E[..., 2, 1] - E[..., 1, 2],
        E[..., 0, 2] - E[..., 2, 0],
        E[..., 1, 0] - E[..., 0, 1],
    ], -1)


def _mv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return (M @ v[..., None])[..., 0]


def _apply_delta(R, t, x):
    """Left-multiplicative tangent update on stacked poses: x is (K, 6)."""
    return so3_exp(x[..., :3]) @ R, t + x[..., 3:]


def _select(i: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """a[i] for a device index tensor i of any shape, without a host read."""
    return a.index_select(0, i.reshape(-1).long()).reshape(i.shape + a.shape[1:])


def graph_residuals(R, t, state: MappingState, cfg: PipelineConfig):
    """All weighted residual rows as one (K + L + 1, 6) tensor.

    Rows: chain edges (slot i holds edge i-1 -> i; slot 0 inactive),
    then loop edges, then the prior on pose 0.
    """
    K = R.shape[0]
    idx = torch.arange(K, device=R.device)
    active_chain = (idx >= 1) & (idx < state.n_kf)

    # chain: E = Z^-1 T_{i-1}^-1 T_i
    Rp_T = torch.roll(R, 1, 0).transpose(-1, -2)
    rel_R = Rp_T @ R
    rel_t = _mv(Rp_T, t - torch.roll(t, 1, 0))
    mR_T = state.kf_meas_R.transpose(-1, -2)
    E_R = mR_T @ rel_R
    E_t = _mv(mR_T, rel_t - state.kf_meas_t)
    r_chain = torch.cat([_vee_chordal(E_R) * (1.0 / cfg.pg_rot_sigma),
                         E_t * (1.0 / cfg.pg_trans_sigma)], -1)
    r_chain = r_chain * active_chain[:, None]

    # loops: E = Z_ij^-1 T_i^-1 T_j
    li, lj = state.loop_i, state.loop_j
    L = li.shape[0]
    active_loop = torch.arange(L, device=R.device) < state.n_loops
    Ri_T = _select(li, R).transpose(-1, -2)
    rel_R = Ri_T @ _select(lj, R)
    rel_t = _mv(Ri_T, _select(lj, t) - _select(li, t))
    lR_T = state.loop_R.transpose(-1, -2)
    E_R = lR_T @ rel_R
    E_t = _mv(lR_T, rel_t - state.loop_t)
    lw = torch.sqrt(torch.clamp(state.loop_w, min=0.0))
    r_loop = torch.cat([_vee_chordal(E_R), E_t], -1) * lw[:, None]
    r_loop = r_loop * active_loop[:, None]

    # prior pins pose 0 at its current estimate's origin chart
    w_prior = 1.0 / cfg.pg_prior_sigma
    r_prior = torch.cat([_vee_chordal(R[0]) * w_prior, t[0] * w_prior])[None]
    return torch.cat([r_chain, r_loop, r_prior], 0)


# ---------------------------------------------------------------------------
# Per-edge linearization: 6x6 Jacobian blocks of one weighted between/prior
# residual with respect to the left-multiplicative tangents of its two
# endpoint poses.
# ---------------------------------------------------------------------------

def _edge_residual_chart(xi, xj, Ri, ti, Rj, tj, ZR, Zt, wr, wt, is_prior):
    """Weighted residual of one edge at tangents (xi, xj) around (Ri..tj).

    is_prior selects the prior form (depends on the dst pose only).  This
    is the function whose Jacobians at xi = xj = 0 edge_blocks writes out.
    """
    Ri2 = so3_exp(xi[:3]) @ Ri
    Rj2 = so3_exp(xj[:3]) @ Rj
    ti2 = ti + xi[3:]
    tj2 = tj + xj[3:]
    rel_R = Ri2.T @ Rj2
    rel_t = Ri2.T @ (tj2 - ti2)
    E_R = ZR.T @ rel_R
    E_t = ZR.T @ (rel_t - Zt)
    r_between = torch.cat([_vee_chordal(E_R) * wr, E_t * wt])
    r_prior = torch.cat([_vee_chordal(Rj2) * wr, tj2 * wt])
    return torch.where(is_prior, r_prior, r_between)


def _chordal_columns(P, Q):
    """(..., 3, 3) whose column k is vee_chordal(P hat(e_k) Q): the
    derivative of vee_chordal(P exp(w) Q) in w at w = 0."""
    G = hat(torch.eye(3, dtype=P.dtype, device=P.device))      # (3, 3, 3)
    return _vee_chordal(P[..., None, :, :] @ G @ Q[..., None, :, :]).transpose(-1, -2)


def edge_blocks(Ri, ti, Rj, tj, ZR, Zt, wr, wt, is_prior):
    """Batched (r, Ji, Jj) for edges: r (E, 6), Ji / Jj (E, 6, 6).

    With P = ZR^T Ri^T and d = tj - ti, the between residual
    r = [wr vee_c(P Rj), wt (P d - ZR^T Zt)] moves with the tangents as
      d r_rot / d w_j = wr C,  d r_rot / d w_i = -wr C  (C: _chordal_columns(P, Rj)),
      d r_t / d w_i = wt P hat(d),  d r_t / d v_i = -wt P,  d r_t / d v_j = wt P;
    the prior r = [wr vee_c(Rj), wt tj] depends on pose j only.
    """
    wr = wr[:, None, None]
    wt = wt[:, None, None]
    ZR_T, Ri_T = ZR.transpose(-1, -2), Ri.transpose(-1, -2)
    P = ZR_T @ Ri_T
    d = tj - ti
    r_between = torch.cat([_vee_chordal(ZR_T @ (Ri_T @ Rj)) * wr[..., 0],
                           _mv(ZR_T, _mv(Ri_T, d) - Zt) * wt[..., 0]], -1)
    r_prior = torch.cat([_vee_chordal(Rj) * wr[..., 0], tj * wt[..., 0]], -1)
    z = torch.zeros_like(P)
    C = _chordal_columns(P, Rj) * wr
    Ji = torch.cat([torch.cat([-C, z], -1),
                    torch.cat([(P @ hat(d)) * wt, -P * wt], -1)], -2)
    Jj = torch.cat([torch.cat([C, z], -1),
                    torch.cat([z, P * wt], -1)], -2)
    eye = torch.eye(3, dtype=P.dtype, device=P.device).expand_as(P)
    Jp = torch.cat([torch.cat([_chordal_columns(eye, Rj) * wr, z], -1),
                    torch.cat([z, eye * wt], -1)], -2)
    ip = is_prior[:, None]
    r = torch.where(ip, r_prior, r_between)
    Ji = torch.where(ip[..., None], 0.0, Ji)
    Jj = torch.where(ip[..., None], Jp, Jj)
    return r, Ji, Jj


# ---------------------------------------------------------------------------
# Block-tridiagonal direct solver via BLOCK CYCLIC REDUCTION.  M has 6x6
# diagonal blocks D_k and super-diagonal blocks U_k (coupling pose k to
# k+1); M is SPD.  Each level eliminates the odd-indexed blocks with
# batched 6x6 ops, halving the system: log2(K) levels of parallel work,
# and float32 rounding accumulates over that depth only (a K-step
# block-Thomas recursion gave noise at K = 4096 in the JAX package).
# K must be a power of two (config.max_keyframes always is).
# ---------------------------------------------------------------------------

def _shift_add(X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    """X with Y[:-1] added to rows 1: (the JAX package's X.at[1:].add)."""
    return torch.cat([X[:1], X[1:] + Y[:-1]], 0)


def tridiag_factor(D, U):
    """Cyclic-reduction factorization.  Returns (levels, Dfinv): one
    (Dinv_odd, U_left, U_right) triple per level plus the inverse of the
    final 1-block system."""
    K = D.shape[0]
    assert K & (K - 1) == 0, "max_keyframes must be a power of two"
    levels = []
    while D.shape[0] > 1:
        Dinv = torch.linalg.inv_ex(D[1::2]).inverse     # odd-block inverses
        Ul = U[0::2]                                     # even 2r <-> odd 2r+1
        Ur = U[1::2]                                     # odd 2r+1 <-> even 2r+2
        levels.append((Dinv, Ul, Ur))
        Dn = D[0::2] - Ul @ Dinv @ Ul.transpose(-1, -2)
        D = _shift_add(Dn, -(Ur.transpose(-1, -2) @ Dinv @ Ur))
        U = -(Ul @ Dinv @ Ur)
    return levels, torch.linalg.inv_ex(D[0]).inverse


def tridiag_solve(factorization, B):
    """Solve M X = B for B (K, 6, m) given the factorization of M."""
    levels, Dfinv = factorization
    stack = []
    for Dinv, Ul, Ur in levels:
        Bo = B[1::2]
        z = Dinv @ Bo
        B = _shift_add(B[0::2] - Ul @ z, -(Ur.transpose(-1, -2) @ z))
        stack.append(Bo)
    X = Dfinv @ B
    for (Dinv, Ul, Ur), Bo in zip(reversed(levels), reversed(stack)):
        xe_next = torch.cat([X[1:], torch.zeros_like(X[:1])], 0)
        xo = Dinv @ (Bo - Ul.transpose(-1, -2) @ X - Ur @ xe_next)
        X = torch.stack([X, xo], 1).reshape((2 * X.shape[0],) + X.shape[1:])
    return X


def direct_gn_delta(D, U, A, B_loop, li, lj, r_loop, b, damping):
    """Exact Gauss-Newton step x solving (M + U_L^T U_L) x = b.

    M = tridiag(D, U) is the chain+prior normal matrix (damping added to
    the diagonal here); U_L stacks the loop-edge Jacobian rows (6 per
    loop edge, blocks A at pose li and B_loop at pose lj -- zero rows for
    inactive slots).  Woodbury:
        x = M^-1 b - M^-1 U_L^T (I + U_L M^-1 U_L^T)^-1 U_L M^-1 b
    computed with ONE batched tridiagonal solve over [b | U_L^T].
    r_loop (L, 6) are the loop residuals; their gradient contribution
    -A^T r - B^T r is folded into b here so callers pass the chain+prior
    gradient only.
    """
    K = D.shape[0]
    L = A.shape[0]
    dev = D.device
    D = D + damping * torch.eye(6, dtype=D.dtype, device=dev)
    li, lj = li.long(), lj.long()

    # dense U_L^T as (K, 6, 6L): column block l holds A_l^T at row li[l]
    # and B_l^T at row lj[l]
    ks = torch.arange(K, device=dev)
    onehot_i = (li[:, None] == ks[None, :]).to(D.dtype)
    onehot_j = (lj[:, None] == ks[None, :]).to(D.dtype)

    # fold the loop-edge gradient into b through the same one-hot rows: a
    # contraction adds in a fixed order (a float atomic scatter would not)
    At, Bt = A.transpose(-1, -2), B_loop.transpose(-1, -2)
    b = b - onehot_i.T @ _mv(At, r_loop) - onehot_j.T @ _mv(Bt, r_loop)
    Ut = (torch.einsum("lk,lba->kalb", onehot_i, A)
          + torch.einsum("lk,lba->kalb", onehot_j, B_loop)).reshape(K, 6, 6 * L)

    fact = tridiag_factor(D, U)
    X = tridiag_solve(fact, torch.cat([b[..., None], Ut], -1))   # (K, 6, 1+6L)
    xb, XU = X[..., 0], X[..., 1:]

    def apply_UL(Y):
        # U_L @ Y for Y (K, 6, m) -> (6L, m)
        return (A @ Y.index_select(0, li) + B_loop @ Y.index_select(0, lj)).reshape(6 * L, -1)

    S = torch.eye(6 * L, dtype=D.dtype, device=dev) + apply_UL(XU)
    c = torch.linalg.solve_ex(S, apply_UL(xb[..., None])).result[:, 0]
    x = xb - XU @ c
    return torch.where(torch.isfinite(x), x, 0.0)


def _assemble_blocks(R, t, state: MappingState, cfg: PipelineConfig):
    """Chain+prior tridiagonal blocks, gradient, and loop blocks at the
    current linearization point (R, t).

    Returns (D, U, b, A, B, r_loop, li, lj): D/U (K,6,6) tridiagonal normal
    blocks incl. prior and inactive-pose regularization, b (K,6) the
    chain+prior gradient -J^T r, A/B (L,6,6) loop Jacobian blocks and
    r_loop (L,6) loop residuals (for direct_gn_delta).
    """
    K = R.shape[0]
    dev = R.device
    idx = torch.arange(K, device=dev)
    active = (idx >= 1) & (idx < state.n_kf)
    wr = torch.where(active, 1.0 / cfg.pg_rot_sigma, 0.0)
    wt = torch.where(active, 1.0 / cfg.pg_trans_sigma, 0.0)
    Rp, tp = torch.roll(R, 1, 0), torch.roll(t, 1, 0)
    no = torch.zeros(K, dtype=torch.bool, device=dev)
    r_c, Ji, Jj = edge_blocks(Rp, tp, R, t, state.kf_meas_R, state.kf_meas_t,
                              wr, wt, no)

    # chain edge k couples poses (k-1, k): D_{k-1} += Ji^T Ji,
    # D_k += Jj^T Jj, U_{k-1} += Ji^T Jj; the roll(-1) re-indexes the
    # "k-1" contributions onto their pose row (row K-1 receives edge 0,
    # which is inactive and therefore zero).
    JiT, JjT = Ji.transpose(-1, -2), Jj.transpose(-1, -2)
    D = JjT @ Jj + torch.roll(JiT @ Ji, -1, 0)
    U = torch.roll(JiT @ Jj, -1, 0)
    b = -_mv(JjT, r_c) - torch.roll(_mv(JiT, r_c), -1, 0)

    # prior on pose 0
    wp = torch.full((1,), 1.0 / cfg.pg_prior_sigma, dtype=torch.float32, device=dev)
    eye1 = torch.eye(3, dtype=torch.float32, device=dev)[None]
    r_p, _, Jp = edge_blocks(R[:1], t[:1], R[:1], t[:1], eye1,
                             torch.zeros((1, 3), dtype=torch.float32, device=dev),
                             wp, wp, torch.ones(1, dtype=torch.bool, device=dev))
    D = torch.cat([D[:1] + Jp.transpose(-1, -2) @ Jp, D[1:]], 0)
    b = torch.cat([b[:1] - _mv(Jp.transpose(-1, -2), r_p), b[1:]], 0)

    # inactive poses get an identity block so the factorization stays SPD
    pose_active = idx < state.n_kf
    D = D + torch.where(pose_active, 0.0, 1.0)[:, None, None] * torch.eye(
        6, dtype=torch.float32, device=dev)

    # loop edges
    li, lj = state.loop_i, state.loop_j
    L = li.shape[0]
    lw = torch.sqrt(torch.clamp(state.loop_w, min=0.0))
    lw = torch.where(torch.arange(L, device=dev) < state.n_loops, lw, 0.0)
    r_l, A, B_loop = edge_blocks(_select(li, R), _select(li, t), _select(lj, R),
                                 _select(lj, t), state.loop_R, state.loop_t,
                                 lw, lw, torch.zeros(L, dtype=torch.bool, device=dev))
    return D, U, b, A, B_loop, r_l, li, lj


def solve_pose_graph(state: MappingState, cfg: PipelineConfig) -> MappingState:
    """Batch GN over the full graph; returns the state with corrected
    keyframe poses (the aft_mapped latch is corrected by the same delta as
    the newest keyframe -- the reference's correctPoses + transformAftMapped
    update, mapOptmization.cpp:1429-1440, 1456-1478)."""
    K = cfg.max_keyframes
    dev = state.kf_t.device
    last = torch.clamp(state.n_kf.to(torch.int64) - 1, min=0).reshape(1)
    T_last_old = Pose(state.kf_R.index_select(0, last)[0],
                      state.kf_t.index_select(0, last)[0])

    def cost(R, t):
        r = graph_residuals(R, t, state, cfg)
        return torch.sum(r * r)

    R, t = state.kf_R, state.kf_t
    c = cost(R, t)
    for _ in range(cfg.pg_gn_iters):
        D, U, b, A, B_loop, r_l, li, lj = _assemble_blocks(R, t, state, cfg)
        x = direct_gn_delta(D, U, A, B_loop, li, lj, r_l, b, cfg.pg_damping)
        R2, t2 = _apply_delta(R, t, x)
        # cost guard: the float32 inner solve is a few-percent-accurate
        # Newton step; accept it only if it lowers the true graph cost
        # (decided on the device: a rejected step leaves the poses as
        # they were, and the next iteration rejects the same step again)
        c2 = cost(R2, t2)
        ok = c2 < c
        R, t, c = torch.where(ok, R2, R), torch.where(ok, t2, t), torch.where(ok, c2, c)

    # keep untouched (beyond-n_kf) slots exactly as they were
    alive = torch.arange(K, device=dev) < state.n_kf
    R = torch.where(alive[:, None, None], R, state.kf_R)
    t = torch.where(alive[:, None], t, state.kf_t)

    T_last_new = Pose(R.index_select(0, last)[0], t.index_select(0, last)[0])
    delta = T_last_new.compose(T_last_old.inverse())
    return state._replace(kf_R=R, kf_t=t, aft_mapped=delta.compose(state.aft_mapped))


def distribute_loop_error(state: MappingState, i, j, Z: Pose,
                          cfg: PipelineConfig) -> MappingState:
    """Warm start after adding loop edge i -> j with measurement Z: spread
    the loop discrepancy linearly over keyframes j..i (a better
    linearization point for the first GN iteration).  i, j: 0-dim device
    integer tensors."""
    i1, j1 = i.reshape(1).long(), j.reshape(1).long()
    Ti = Pose(state.kf_R.index_select(0, i1)[0], state.kf_t.index_select(0, i1)[0])
    Tj = Pose(state.kf_R.index_select(0, j1)[0], state.kf_t.index_select(0, j1)[0])
    # pose i implied by the loop measurement: Ti' = Tj Z^-1
    err_t = Tj.compose(Z.inverse()).t - Ti.t

    K = state.kf_R.shape[0]
    dev = state.kf_t.device
    idx = torch.arange(K, dtype=torch.float32, device=dev)
    fi, fj = i.to(torch.float32), j.to(torch.float32)
    frac = torch.clamp((idx - fj) / torch.clamp(fi - fj, min=1.0), 0.0, 1.0)
    alive = torch.arange(K, device=dev) < state.n_kf
    t = state.kf_t + torch.where(alive, frac, 0.0)[:, None] * err_t
    aft = state.aft_mapped._replace(t=state.aft_mapped.t + err_t)
    return state._replace(kf_t=t, aft_mapped=aft)
