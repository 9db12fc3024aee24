"""Loop-closure detection and correction (counterpart of
``lego_loam_tpu.models.loop``; the reference's 1 Hz loop-closure thread,
mapOptmization.cpp:802-954).

Find a keyframe within the search radius whose stamp is older than the
loop time gap, ICP-align the newest keyframe's cloud against a
+-history_keyframe_search_num keyframe history submap, and on success add
a loop edge and re-optimize the pose graph.

As in the JAX package, detection, ICP, the acceptance gates and the
pose-graph solve run on every check, and the outcome is applied with
``torch.where`` on the device-side ``accept``: the host never waits on
``found`` or ``accept``.  The one field the JAX package also updates on the
device, ``map_stale``, is a host value in the port (models/mapping.py): the
caller sets it from ``LoopResult.closed`` once that is on the host
(models/pipeline.py reads it in the host copy of a scan, or, where no copy
came between the check and the next solve, just before that solve).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from lego_loam_tpu_torch.config import PipelineConfig
from lego_loam_tpu_torch.models.mapping import MappingState
from lego_loam_tpu_torch.models.posegraph import (
    distribute_loop_error,
    solve_pose_graph,
)
from lego_loam_tpu_torch.ops.icp import icp_align, plane_information
from lego_loam_tpu_torch.ops.lin3 import eigvalsh3
from lego_loam_tpu_torch.ops.voxel import voxel_downsample
from lego_loam_tpu_torch.utils.math3d import Pose


class LoopResult(NamedTuple):
    closed: torch.Tensor     # bool
    candidate: torch.Tensor  # int64 history keyframe index
    fitness: torch.Tensor    # float32 ICP fitness
    drift: torch.Tensor      # float32 translation discrepancy vs chain (m)
    obs_ratio: torch.Tensor  # float32 lambda_min/lambda_max of the ICP
                             # point-to-plane information (1 = isotropic,
                             # ~0 = unobservable direction)


def _row(a: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """a[i] for a 0-dim device index i, without a host read."""
    return a.index_select(0, i.reshape(1))[0]


def _keyframe_cloud(state: MappingState, idx, cfg: PipelineConfig,
                    transformed: bool = True, offset: int = 0):
    """Corner+surf block of keyframe(s) idx (a device index tensor, 0-dim
    or (n,)), optionally in the map frame: (..., Ckc + Cks, 3) and the
    validity mask.  The pool blocks may be one rank's slice, rows [offset,
    offset + Ks) (parallel/backend_sharded.py): a keyframe outside it comes
    back as zeros with no valid point."""
    i = idx.reshape(-1)
    Ks = state.kf_corner.shape[0]
    own = (i >= offset) & (i < offset + Ks)
    li = torch.clamp(i - offset, 0, Ks - 1)
    pts = torch.cat([state.kf_corner.index_select(0, li),
                     state.kf_surf.index_select(0, li)], 1)
    val = torch.cat([state.kf_corner_valid.index_select(0, li),
                     state.kf_surf_valid.index_select(0, li)], 1)
    if transformed:
        pts = (pts @ state.kf_R.index_select(0, i).transpose(1, 2)
               + state.kf_t.index_select(0, i)[:, None, :])
    pts = torch.where(own[:, None, None], pts, 0.0)
    val = val & own[:, None]
    return (pts.reshape(idx.shape + pts.shape[1:]),
            val.reshape(idx.shape + val.shape[1:]))


def _detect(state: MappingState, time: torch.Tensor, cfg: PipelineConfig):
    """Loop-candidate detection from the pose-level arrays: nearest alive
    keyframe within the search radius whose stamp is older than the loop
    time gap (mapOptmization.cpp:815-843).  Returns (latest, cand, found),
    0-dim device tensors; ties go to the first index."""
    dev = state.kf_t.device
    latest = torch.clamp(state.n_kf.to(torch.int64) - 1, min=0)
    cur_pos = _row(state.kf_t, latest)
    alive = torch.arange(cfg.max_keyframes, device=dev) < state.n_kf
    d2 = torch.sum((state.kf_t - cur_pos) ** 2, dim=1)
    old_enough = torch.abs(state.kf_time - time) > cfg.loop_min_time_gap
    qualify = alive & old_enough & (d2 < cfg.history_keyframe_search_radius ** 2)
    cand = torch.argmin(torch.where(qualify, d2, 1e30))
    found = (torch.any(qualify) & (state.n_loops < cfg.max_loop_edges)
             & (state.n_kf > 2))
    return latest, cand, found


def _history_selection(state: MappingState, cand, time, cfg: PipelineConfig):
    """Indices + inclusion mask of the candidate's +-H keyframe history
    submap.  Keyframes from the current visit (within half the loop time
    gap of now) must not enter it, or ICP would match the source cloud
    against itself on a short trajectory."""
    H = cfg.history_keyframe_search_num
    offs = cand + torch.arange(-H, H + 1, device=cand.device)
    sel = torch.clamp(offs, 0, cfg.max_keyframes - 1)
    sel_ok = (offs >= 0) & (offs < state.n_kf)
    sel_ok = sel_ok & (torch.abs(state.kf_time.index_select(0, sel) - time)
                       > 0.5 * cfg.loop_min_time_gap)
    return sel, sel_ok


def loop_closure_step(state: MappingState, time, cfg: PipelineConfig):
    """Detect + ICP + graph update.  Returns (state, LoopResult).  `time`
    is the scan stamp in seconds (stored as float32, as mapping_step
    stores keyframe stamps)."""
    dev = state.kf_t.device
    time = torch.full((), float(time), dtype=torch.float32, device=dev)
    latest, cand, found = _detect(state, time, cfg)

    # current keyframe cloud at its (possibly wrong) map pose
    src, src_val = _keyframe_cloud(state, latest, cfg)

    # history submap: candidate +- history_keyframe_search_num keyframes
    sel, sel_ok = _history_selection(state, cand, time, cfg)
    hist_pts, hist_val = _keyframe_cloud(state, sel, cfg)
    hist_pts, hist_val = voxel_downsample(
        hist_pts.reshape(-1, 3), (hist_val & sel_ok[:, None]).reshape(-1),
        cfg.leaf_history, cfg.max_map_surf)
    return _loop_core(state, src, src_val, hist_pts, hist_val,
                      latest, cand, found, time, cfg)


def _loop_core(state: MappingState, src, src_val, hist_pts, hist_val,
               latest, cand, found, time, cfg: PipelineConfig):
    """ICP + acceptance gates + edge insert + pose-graph solve, given the
    already-gathered source cloud (map frame) and voxel-downsampled history
    submap."""
    K = cfg.max_keyframes
    dev = state.kf_t.device
    idx = torch.arange(K, device=dev)
    alive = idx < state.n_kf

    T_icp, fitness = icp_align(
        src, src_val, hist_pts, hist_val, Pose.identity(device=dev),
        iters=cfg.loop_icp_iters, max_corr_dist=cfg.loop_icp_max_corr_dist,
        query_tile=cfg.nn_query_tile)
    accept = found & (fitness < cfg.history_keyframe_fitness_score)

    # corrected latest pose and loop measurement Z = T_i'^-1 T_j
    T_latest = Pose(_row(state.kf_R, latest), _row(state.kf_t, latest))
    T_corr = T_icp.compose(T_latest)
    T_cand = Pose(_row(state.kf_R, cand), _row(state.kf_t, cand))
    Z = T_corr.inverse().compose(T_cand)
    # loop-edge information 1/sigma^2 with sigma = max(floor,
    # scale*sqrt(fitness)) (see config.loop_sigma_floor)
    sigma = torch.clamp(cfg.loop_sigma_scale * torch.sqrt(fitness),
                        min=cfg.loop_sigma_floor)
    w = 1.0 / (sigma * sigma)

    # ---- false-positive gates (new vs reference; see config knobs) ----
    # (a) drift consistency: the measurement may disagree with the chain
    # estimate only by what odometry drift can plausibly accumulate over
    # the chain path between the endpoints
    Z_est = T_latest.inverse().compose(T_cand)
    drift = torch.linalg.vector_norm(Z.t - Z_est.t)
    # the chain's length between the endpoints, a masked sum (the JAX
    # package differences a cumsum, whose float scan on a CUDA tensor does
    # not add in a fixed order)
    lo, hi = torch.minimum(latest, cand), torch.maximum(latest, cand)
    path = torch.sum(torch.where(alive & (idx > lo) & (idx <= hi),
                                 torch.linalg.vector_norm(state.kf_meas_t, dim=-1), 0.0))
    drift_ok = drift <= cfg.loop_drift_frac * path + cfg.loop_drift_abs
    cosang = 0.5 * (torch.trace(Z_est.R.T @ Z.R) - 1.0)
    d_rot = torch.arccos(torch.clamp(cosang, -1.0, 1.0))
    rot_ok = d_rot <= math.radians(cfg.loop_max_rot_correction_deg)
    # (b) observability: in self-similar geometry (smooth corridor) the
    # point-to-plane information of the converged alignment has a ~zero
    # eigenvalue along the slip direction
    q_fit = src @ T_icp.R.T + T_icp.t
    H_tt = plane_information(q_fit, src_val, hist_pts, hist_val,
                             query_tile=cfg.nn_query_tile)
    lam = eigvalsh3(H_tt[None])[0]
    obs_ratio = lam[0] / torch.clamp(lam[2], min=1e-9)
    obs_ok = (obs_ratio >= cfg.loop_degen_eig_frac) | (cfg.loop_degen_eig_frac <= 0.0)
    accept = accept & drift_ok & rot_ok & obs_ok

    slot = torch.clamp(state.n_loops.to(torch.int64), max=cfg.max_loop_edges - 1).reshape(1)

    def ins(arr, val):
        row = torch.where(accept, val.to(arr.dtype), arr.index_select(0, slot)[0])
        return arr.index_copy(0, slot, row[None])

    with_edge = state._replace(
        loop_i=ins(state.loop_i, latest), loop_j=ins(state.loop_j, cand),
        loop_R=ins(state.loop_R, Z.R), loop_t=ins(state.loop_t, Z.t),
        loop_w=ins(state.loop_w, w),
        n_loops=torch.where(accept, state.n_loops + 1, state.n_loops),
    )
    warm = distribute_loop_error(with_edge, latest, cand, Z, cfg)
    solved = solve_pose_graph(warm, cfg)

    # the solve moves only the keyframe poses and the aft_mapped latch
    new_state = with_edge._replace(
        kf_R=torch.where(accept, solved.kf_R, with_edge.kf_R),
        kf_t=torch.where(accept, solved.kf_t, with_edge.kf_t),
        aft_mapped=Pose(torch.where(accept, solved.aft_mapped.R, with_edge.aft_mapped.R),
                        torch.where(accept, solved.aft_mapped.t, with_edge.aft_mapped.t)))
    return new_state, LoopResult(closed=accept, candidate=cand, fitness=fitness,
                                 drift=drift, obs_ratio=obs_ratio)
