"""Scan-to-map back-end: keyframe pool + 6-DoF map registration
(counterpart of ``lego_loam_tpu.models.mapping``;
mapOptmization.cpp:956-1350, 1353-1454).

The keyframe pool is a fixed-capacity set of padded device tensors; the
local map is the top-k nearest in-radius keyframes, transformed and
voxel-downsampled; each solve re-associates the 5-NN (kernel K3 on the
card) for the first map_assoc_iters GN steps, then refines on frozen
correspondences.

Where the JAX package branches on device values under jit, the port keeps
the decision on the host without a sync:
  * the early-exit while_loop is a fixed loop of masked steps (once done,
    a step leaves the pose unchanged, so the result is identical);
  * the map-refresh cond reads map_age / map_stale, host values in
    MappingState: map_age changes only by host-known rules, and map_stale
    is set by compaction and, after an accepted loop, by the pipeline,
    which reads the loop flag at the latest when the next solve comes
    (models/pipeline.py; the JAX package sets it on the device);
  * the pool-compaction cond moves to the pipeline, which keeps a host
    upper bound on n_kf (at most one insert per solve) and reads the device
    count only when that bound reaches max_keyframes - 1.
mapping_step updates the keyframe pool in place (the JAX package donates
the state for the same reason: the pool is hundreds of MB).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from lego_loam_tpu_torch.config import PipelineConfig
from lego_loam_tpu_torch.models.imu import blend_attitude
from lego_loam_tpu_torch.models.odometry import (
    _chart_rows,
    _corner_distance,
    _degeneracy_projection,
    _safe_norm,
    select_pose,
    solve6,
)
from lego_loam_tpu_torch.ops.knn import knn
from lego_loam_tpu_torch.ops.lin3 import eigvalsh3, principal_axis3, solve3
from lego_loam_tpu_torch.ops.voxel import voxel_downsample
from lego_loam_tpu_torch.types import ScanFeatures
from lego_loam_tpu_torch.utils.math3d import Pose, project_so3, so3_exp


class MappingState(NamedTuple):
    # keyframe pool
    kf_R: torch.Tensor          # (K, 3, 3) optimized keyframe rotations
    kf_t: torch.Tensor          # (K, 3)
    kf_corner: torch.Tensor     # (K, Ckc, 3) keyframe corner block (sensor frame)
    kf_corner_valid: torch.Tensor
    kf_surf: torch.Tensor       # (K, Cks, 3)
    kf_surf_valid: torch.Tensor
    kf_outlier: torch.Tensor    # (K, Cko, 3)
    kf_outlier_valid: torch.Tensor
    kf_time: torch.Tensor       # (K,)
    n_kf: torch.Tensor          # int32 (device)
    # pose-graph bookkeeping: chain measurement from the previous keyframe
    # plus padded loop edges (models/loop.py, models/posegraph.py)
    kf_meas_R: torch.Tensor     # (K, 3, 3)
    kf_meas_t: torch.Tensor     # (K, 3)
    loop_i: torch.Tensor        # (L,) int32
    loop_j: torch.Tensor        # (L,) int32
    loop_R: torch.Tensor        # (L, 3, 3)
    loop_t: torch.Tensor        # (L, 3)
    loop_w: torch.Tensor        # (L,)
    n_loops: torch.Tensor       # int32
    # latched poses for the odometry-delta prediction
    bef_mapped: Pose
    aft_mapped: Pose
    # cached assembled local map (map frame)
    map_corner: torch.Tensor        # (max_map_corner, 3)
    map_corner_valid: torch.Tensor
    map_surf: torch.Tensor          # (max_map_surf, 3)
    map_surf_valid: torch.Tensor
    map_age: int                    # host: solves since the last refresh
    map_stale: bool                 # host: force a refresh at the next solve
                                    # (set by compaction and, from
                                    # LoopResult.closed read on the host, by
                                    # the pipeline after an accepted loop)


def init_state(cfg: PipelineConfig, device) -> MappingState:
    K, L = cfg.max_keyframes, cfg.max_loop_edges

    def z(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)

    def eyes(n):
        return torch.eye(3, dtype=torch.float32, device=device).expand(n, 3, 3).clone()

    return MappingState(
        kf_R=eyes(K), kf_t=z(K, 3),
        kf_corner=z(K, cfg.kf_corner_cap, 3),
        kf_corner_valid=z(K, cfg.kf_corner_cap, dtype=torch.bool),
        kf_surf=z(K, cfg.kf_surf_cap, 3),
        kf_surf_valid=z(K, cfg.kf_surf_cap, dtype=torch.bool),
        kf_outlier=z(K, cfg.kf_outlier_cap, 3),
        kf_outlier_valid=z(K, cfg.kf_outlier_cap, dtype=torch.bool),
        kf_time=z(K), n_kf=z(dtype=torch.int32),
        kf_meas_R=eyes(K), kf_meas_t=z(K, 3),
        loop_i=z(L, dtype=torch.int32), loop_j=z(L, dtype=torch.int32),
        loop_R=eyes(L), loop_t=z(L, 3), loop_w=z(L),
        n_loops=z(dtype=torch.int32),
        bef_mapped=Pose.identity(device=device),
        aft_mapped=Pose.identity(device=device),
        map_corner=z(cfg.max_map_corner, 3),
        map_corner_valid=z(cfg.max_map_corner, dtype=torch.bool),
        map_surf=z(cfg.max_map_surf, 3),
        map_surf_valid=z(cfg.max_map_surf, dtype=torch.bool),
        map_age=0, map_stale=True,
    )


def predict_pose(state: MappingState, odom_pose: Pose) -> Pose:
    """Odometry increment since the last solve applied on top of the last
    mapped pose (mapOptmization.cpp:376-461)."""
    return state.aft_mapped.compose(state.bef_mapped.inverse().compose(odom_pose))


def _gather_local_map(state: MappingState, center: torch.Tensor, cfg: PipelineConfig):
    """Nearest in-radius keyframes (at most surrounding_keyframe_search_num,
    ties to the lowest index like lax.top_k) -> transformed, downsampled
    map clouds.  Returns (corner_map, corner_valid, surf_map, surf_valid)."""
    K = cfg.max_keyframes
    S = min(cfg.surrounding_keyframe_search_num, K)
    alive = torch.arange(K, device=center.device) < state.n_kf
    d2 = torch.sum((state.kf_t - center) ** 2, dim=1)
    usable = alive & (d2 <= cfg.surrounding_keyframe_search_radius ** 2)
    d2 = torch.where(usable, d2, 1e30)
    sel = torch.sort(d2, stable=True).indices[:S]
    sel_ok = usable[sel]

    def transform_blocks(blocks, valids):
        pts = (blocks[sel] @ state.kf_R[sel].transpose(1, 2)
               + state.kf_t[sel][:, None, :])
        return pts.reshape(-1, 3), (valids[sel] & sel_ok[:, None]).reshape(-1)

    c_pts, c_val = transform_blocks(state.kf_corner, state.kf_corner_valid)
    s_pts, s_val = transform_blocks(state.kf_surf, state.kf_surf_valid)
    o_pts, o_val = transform_blocks(state.kf_outlier, state.kf_outlier_valid)
    corner_map, corner_valid = voxel_downsample(
        c_pts, c_val, cfg.leaf_map_corner, cfg.max_map_corner)
    surf_map, surf_valid = voxel_downsample(
        torch.cat([s_pts, o_pts]), torch.cat([s_val, o_val]),
        cfg.leaf_map_surf, cfg.max_map_surf)
    return corner_map, corner_valid, surf_map, surf_valid


# The 5-point fits below run in FIT_DTYPE, float64, and return float32.  In
# float32 the plane fit's normal equations (points metres from the origin,
# a patch a few decimetres wide) lose most of their digits, and so do the
# small eigenvalues of a near-collinear set; then any change of rounding
# order -- cuBLAS against the CPU, or XLA's FMAs -- moves normals by
# percent and flips the validity gates of some fits, and a mapping solve
# lands up to ~0.1 deg away (an NVIDIA H100 against the CPU,
# chip_smoke.py's card-against-CPU phase).  In float64 the card and the CPU
# take the same gate decisions.  The JAX package fits in float32: this is
# a by-design divergence from it (tests/test_torch_loop_pipeline.py, and
# tests/loop_parity_gaps.py, which runs the port with either precision).
FIT_DTYPE = torch.float64


def _fit_lines(nn_pts, nn_ok, cfg):
    """Line fit on 5-NN sets: line-like iff the largest covariance
    eigenvalue > 3x the second (mapOptmization.cpp:1101-1138).
    Returns (a, b, ok): two virtual line points and validity."""
    P = nn_pts.to(FIT_DTYPE)
    c = P.mean(dim=1)
    X = P - c[:, None, :]
    cov = X.transpose(1, 2) @ X / P.shape[1]
    lam = eigvalsh3(cov)
    ok = nn_ok & (lam[:, 2] > cfg.map_line_eig_ratio * lam[:, 1])
    v = principal_axis3(cov, lam)
    f = nn_pts.dtype
    return (c + 0.1 * v).to(f), (c - 0.1 * v).to(f), ok


def _fit_planes(nn_pts, nn_ok, cfg):
    """Plane fit A n = -1 with residual and spread validation
    (mapOptmization.cpp:1183-1207).  Returns (n_unit, d, ok)."""
    A = nn_pts.to(FIT_DTYPE)
    AtA = A.transpose(1, 2) @ A
    tr = torch.diagonal(AtA, dim1=-2, dim2=-1).sum(-1)[:, None, None]
    reg = (1e-6 * tr + 1e-6) * torch.eye(3, dtype=A.dtype, device=A.device)
    n = solve3(AtA + reg, -A.sum(dim=1))
    finite = torch.isfinite(n).all(dim=1)
    n = torch.where(finite[:, None], n, 0.0)
    norm = _safe_norm(n, keepdim=True)
    n_unit = n / norm
    d = 1.0 / norm[:, 0]
    resid = ((A @ n_unit[:, :, None])[..., 0] + d[:, None]).abs()
    c = A.mean(dim=1)
    X = A - c[:, None, :]
    lam = eigvalsh3(X.transpose(1, 2) @ X / A.shape[1])
    spread_ok = lam[:, 1] > cfg.map_plane_min_spread ** 2
    ok = nn_ok & finite & spread_ok & (resid <= cfg.map_plane_max_resid).all(dim=1)
    f = nn_pts.dtype
    return n_unit.to(f), torch.where(ok, d, 0.0).to(f), ok


def _map_residuals(T: Pose, corner_pts, corner_ok, surf_pts, surf_ok,
                   corner_map, corner_map_valid, surf_map, surf_map_valid,
                   cfg: PipelineConfig):
    """One association round: 5-NN + fits; returns the constraint pack."""
    qc = corner_pts @ T.R.T + T.t
    qs = surf_pts @ T.R.T + T.t
    ci, cd2 = knn(qc, corner_map, corner_map_valid, 5, cfg.nn_query_tile)
    si, sd2 = knn(qs, surf_map, surf_map_valid, 5, cfg.nn_query_tile)
    c_ok = corner_ok & (cd2[:, 4] < cfg.map_nn_radius_sq)
    s_ok = surf_ok & (sd2[:, 4] < cfg.map_nn_radius_sq)
    la, lb, c_ok = _fit_lines(corner_map[ci.long()], c_ok, cfg)
    pn, pd, s_ok = _fit_planes(surf_map[si.long()], s_ok, cfg)
    return (la, lb, c_ok), (pn, pd, s_ok)


def scan_to_map(T0: Pose, corner_pts, corner_ok, surf_pts, surf_ok,
                corner_map, corner_map_valid, surf_map, surf_map_valid,
                cfg: PipelineConfig):
    """6-DoF GN registration of the downsampled scan against the local map
    (mapOptmization.cpp:1229-1350).  Returns (T, n_constraints_last)."""
    dev = corner_pts.device
    map_gate = (corner_map_valid.sum() > 10) & (surf_map_valid.sum() > 100)
    Cn = corner_pts.shape[0]

    def gn_step(T, P, done, assoc, compute_proj: bool):
        (la, lb, c_ok), (pn, pd, s_ok) = assoc
        qc = corner_pts @ T.R.T + T.t
        qs = surf_pts @ T.R.T + T.t
        dc, gc = _corner_distance(qc, la, lb)
        ds = torch.sum(pn * qs, dim=-1) + pd
        d0 = torch.cat([dc, ds])
        J = torch.cat([_chart_rows(qc, gc), _chart_rows(qs, pn)])
        wc = 1.0 - 0.9 * dc.abs()
        ws = 1.0 - 0.9 * ds.abs() / torch.sqrt(torch.sqrt(_safe_norm(qs)))
        w = torch.cat([wc, ws])
        keep = torch.cat([c_ok, s_ok]) & (w > 0.1) & torch.isfinite(d0)
        wk = torch.where(keep, w, 0.0)
        A = J * wk[:, None]
        H = A.T @ A
        x = solve6(H, A.T @ (-wk * d0))
        if compute_proj:
            # latched on the first GN iteration (mapOptmization.cpp:1272-1305)
            P = _degeneracy_projection(H, cfg.map_degen_eig_thresh)
        x = P @ x
        n_keep = keep.sum()
        apply = ~done & map_gate & (n_keep >= cfg.map_min_constraints)
        T = select_pose(apply, Pose(so3_exp(x[:3]) @ T.R, T.t + x[3:]), T)
        d_rot = torch.rad2deg(_safe_norm(x[:3]))
        d_trans = 100.0 * _safe_norm(x[3:])
        done = done | (apply & (d_rot < cfg.map_delta_rot_deg)
                       & (d_trans < cfg.map_delta_trans_cm))
        return T, P, done, n_keep

    T = T0
    P = torch.eye(6, dtype=torch.float32, device=dev)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    n_last = torch.zeros((), dtype=torch.int64, device=dev)
    n_assoc = min(cfg.map_assoc_iters, cfg.map_iters)
    assoc = None
    for a in range(n_assoc):
        assoc = _map_residuals(T, corner_pts, corner_ok, surf_pts, surf_ok,
                               corner_map, corner_map_valid, surf_map,
                               surf_map_valid, cfg)
        was_done = done
        T, P, done, n_keep = gn_step(T, P, done, assoc, compute_proj=(a == 0))
        n_last = torch.where(map_gate & ~was_done, n_keep, n_last)
    # frozen-correspondence refinement: the JAX early-exit while_loop as a
    # fixed loop of masked steps (a step taken once done changes nothing)
    for _ in range(n_assoc, cfg.map_iters):
        live = map_gate & ~done
        T, _, done, n_keep = gn_step(T, P, done, assoc, compute_proj=False)
        n_last = torch.where(live, n_keep, n_last)
    return T, n_last


def _fit_block(x: torch.Tensor, cap: int) -> torch.Tensor:
    """First `cap` rows of x, zero-padded when x is shorter (the JAX
    package slices and so fails when a block is shorter than its slot)."""
    if x.shape[0] >= cap:
        return x[:cap]
    pad = torch.zeros((cap - x.shape[0],) + x.shape[1:], dtype=x.dtype,
                      device=x.device)
    return torch.cat([x, pad])


def refresh_due(map_age: int, map_stale: bool, cfg: PipelineConfig) -> bool:
    """Whether the next solve re-gathers the local map (the JAX package's
    refresh cond, on host values)."""
    return map_age >= cfg.map_refresh_every - 1 or map_stale


def mapping_step(state: MappingState, feats: ScanFeatures, odom_pose: Pose,
                 time, cfg: PipelineConfig, imu_buf=None, refresh=None):
    """One mapping solve on the odometry's reference clouds for this sweep
    (less-sharp / less-flat at the sweep end, plus outliers).  Returns
    (new_state, mapped_pose).  With an IMU buffer (models/imu.ImuBuffer),
    the solved pose takes a share of the IMU's roll and pitch before it is
    latched and stored.  The keyframe pool tensors of `state` are updated
    in place; rebind to the returned state.

    `refresh` says whether the solve re-gathers the local map: None
    decides it from the state's map_age / map_stale (:func:`refresh_due`),
    a bool forces it, and a bool tensor -- one a sequence under
    torch.func.vmap, where the sequences of a batch may disagree --
    gathers and keeps the new map where it is True and the cached one
    elsewhere (the JAX package's cond under vmap).  With a tensor the
    returned map_age / map_stale are the state's: the caller keeps them
    per sequence."""
    dev = odom_pose.t.device
    time = torch.full((), float(time), dtype=torch.float32, device=dev)
    T_pred = predict_pose(state, odom_pose)
    corner_pts, corner_ok = voxel_downsample(
        feats.less_sharp.xyz, feats.less_sharp.valid, cfg.leaf_scan_corner,
        cfg.max_scan_corner_ds)
    surf_pts, surf_ok = voxel_downsample(
        torch.cat([feats.less_flat.xyz, feats.outlier.xyz]),
        torch.cat([feats.less_flat.valid, feats.outlier.valid]),
        cfg.leaf_scan_surf, cfg.max_scan_surf_ds)

    # local-map refresh cadence, decided from host values
    if refresh is None:
        refresh = refresh_due(state.map_age, state.map_stale, cfg)
    cached = (state.map_corner, state.map_corner_valid, state.map_surf,
              state.map_surf_valid)
    if isinstance(refresh, torch.Tensor):
        maps = tuple(torch.where(refresh, new, old) for new, old in
                     zip(_gather_local_map(state, T_pred.t, cfg), cached))
    else:
        maps = _gather_local_map(state, T_pred.t, cfg) if refresh else cached
    T, _ = scan_to_map(T_pred, corner_pts, corner_ok, surf_pts, surf_ok,
                       *maps, cfg)
    if imu_buf is not None:
        T = blend_attitude(T, imu_buf, time, cfg)
    T = Pose(project_so3(T.R), T.t)

    # keyframe insertion (mapOptmization.cpp:1353-1454)
    K = cfg.max_keyframes
    n_kf = state.n_kf.to(torch.int64)
    prev = torch.clamp(n_kf - 1, min=0).reshape(1)   # 1-element index: no host copy
    last_t = state.kf_t.index_select(0, prev)[0]
    moved = _safe_norm(T.t - last_t) >= cfg.keyframe_min_translation
    insert = ((n_kf <= 0) | moved) & (n_kf < K)
    slot = torch.clamp(n_kf, max=K - 1).reshape(1)
    ko_ds, ko_ok = voxel_downsample(feats.outlier.xyz, feats.outlier.valid,
                                    cfg.leaf_outlier, cfg.kf_outlier_cap)
    T_prev = Pose(state.kf_R.index_select(0, prev)[0], last_t)
    Z = T_prev.inverse().compose(T)

    def ins(arr, val):
        # predicated single-row update, in place (index_put_ batches under
        # torch.func.vmap; index_copy_ would fall back to a per-sequence loop)
        row = torch.where(insert, val, arr.index_select(0, slot)[0])
        arr.index_put_((slot,), row[None])
        return arr

    new_state = state._replace(
        kf_meas_R=ins(state.kf_meas_R, Z.R),
        kf_meas_t=ins(state.kf_meas_t, Z.t),
        kf_R=ins(state.kf_R, T.R),
        kf_t=ins(state.kf_t, T.t),
        kf_corner=ins(state.kf_corner, _fit_block(corner_pts, cfg.kf_corner_cap)),
        kf_corner_valid=ins(state.kf_corner_valid,
                            _fit_block(corner_ok, cfg.kf_corner_cap)),
        kf_surf=ins(state.kf_surf, _fit_block(surf_pts, cfg.kf_surf_cap)),
        kf_surf_valid=ins(state.kf_surf_valid, _fit_block(surf_ok, cfg.kf_surf_cap)),
        kf_outlier=ins(state.kf_outlier, ko_ds),
        kf_outlier_valid=ins(state.kf_outlier_valid, ko_ok),
        kf_time=ins(state.kf_time, time),
        n_kf=torch.where(insert, state.n_kf + 1, state.n_kf),
        bef_mapped=odom_pose,
        aft_mapped=T,
        map_corner=maps[0], map_corner_valid=maps[1],
        map_surf=maps[2], map_surf_valid=maps[3],
    )
    if not isinstance(refresh, torch.Tensor):
        new_state = new_state._replace(
            map_age=0 if refresh else state.map_age + 1, map_stale=False)
    return new_state, T


def compact_keyframes(state: MappingState, cfg: PipelineConfig) -> MappingState:
    """Thin the pool when it approaches capacity: keep every 2nd keyframe of
    the older half [0, n_kf/2) and all of the newer half.  Chain
    measurements are recomputed from the retained poses; loop edges are
    remapped and edges that lost an endpoint are dropped."""
    K, L = cfg.max_keyframes, cfg.max_loop_edges
    dev = state.kf_t.device
    idx = torch.arange(K, device=dev)
    n_kf = state.n_kf.to(torch.int64)
    keep = (idx < n_kf) & ((idx >= torch.div(n_kf, 2, rounding_mode="floor"))
                           | (idx % 2 == 0))
    new_pos = (torch.cumsum(keep.to(torch.int32), 0) - 1).to(torch.int32)
    order = torch.argsort(torch.where(keep, idx, K + idx))

    def g(a):
        return a[order]

    kf_R, kf_t = g(state.kf_R), g(state.kf_t)
    Rp_T = torch.roll(kf_R, 1, 0).transpose(1, 2)
    meas_R = Rp_T @ kf_R
    meas_t = (Rp_T @ (kf_t - torch.roll(kf_t, 1, 0))[:, :, None])[:, :, 0]
    meas_R[0] = torch.eye(3, dtype=torch.float32, device=dev)
    meas_t[0] = 0.0

    le = torch.arange(L, device=dev)
    li, lj = state.loop_i.long(), state.loop_j.long()
    ok_edge = (le < state.n_loops) & keep[li] & keep[lj]
    lorder = torch.argsort(torch.where(ok_edge, le, L + le))
    return state._replace(
        kf_R=kf_R, kf_t=kf_t,
        kf_corner=g(state.kf_corner), kf_corner_valid=g(state.kf_corner_valid),
        kf_surf=g(state.kf_surf), kf_surf_valid=g(state.kf_surf_valid),
        kf_outlier=g(state.kf_outlier), kf_outlier_valid=g(state.kf_outlier_valid),
        kf_time=g(state.kf_time), kf_meas_R=meas_R, kf_meas_t=meas_t,
        n_kf=keep.sum().to(torch.int32),
        loop_i=new_pos[li][lorder], loop_j=new_pos[lj][lorder],
        loop_R=state.loop_R[lorder], loop_t=state.loop_t[lorder],
        loop_w=torch.where(ok_edge, state.loop_w, 0.0)[lorder],
        n_loops=ok_edge.sum().to(torch.int32),
        map_stale=True,
    )
