"""The sharded scan-to-map back end (counterpart of
``lego_loam_tpu.parallel.backend_sharded``): the map-sharded 5-NN and the
edge-sharded pose graph composed into one mapping solve, the loop check on
a sharded pool, and its host loop (ShardedBackend).

Layout:
  * the keyframe pool's six block fields (the large tensors) shard along
    the keyframe axis, rows [rank Ks, (rank + 1) Ks) with Ks = K / W;
    the pose-level fields (poses, chain measurements, loop edges, latches)
    are whole on every rank, so collectives move (Q, 5) candidate sets and
    6-dof reductions, never map points in bulk;
  * each rank assembles a local map from the keyframes it owns among the
    global top-S in-radius selection (exact: the pose arrays are whole),
    with full-size caps on every shard;
  * each association runs the 5-NN on every shard (kernel K3 on the card),
    all-gathers the candidates' points and distances, and merges them to
    the global 5 nearest;
  * the line / plane fits and the GN steps run replicated, through
    models/mapping.register: the same GN step as the single-device solve,
    with its float64 fits and E1's projection;
  * a loop check gathers its two clouds out of the sharded pool (each row
    comes from the one rank that owns it) and then runs the single-device
    check (models/loop._loop_core) replicated.

A world of one calls no collective: its solve is the single-device
mapping_step's, and its loop check the single-device loop_closure_step's.

Reference equivalents: mapOptmization.cpp:956-1065 (local map), 1093-1327
(association + GN), 1353-1454 (keyframe insertion), 802-954 (loop
closure).
"""

from __future__ import annotations

import torch

from lego_loam_tpu_torch.config import PipelineConfig
from lego_loam_tpu_torch.models import loop as lc
from lego_loam_tpu_torch.models import mapping as mp
from lego_loam_tpu_torch.models.mapping import MappingState
from lego_loam_tpu_torch.ops.knn import knn
from lego_loam_tpu_torch.ops.voxel import voxel_downsample
from lego_loam_tpu_torch.parallel.comm import Comm
from lego_loam_tpu_torch.parallel.map_sharded import merge_candidates
from lego_loam_tpu_torch.utils.convert import POOL_FIELDS, shard_pool
from lego_loam_tpu_torch.utils.math3d import Pose, project_so3


def _offset(state: MappingState, comm: Comm) -> int:
    """First pool row of this rank's slice."""
    return comm.rank * state.kf_corner.shape[0]


def _shard_local_map(state: MappingState, center, cfg: PipelineConfig, comm: Comm):
    """This rank's part of the local map: the keyframes it owns among the
    global top-S in-radius selection, transformed and voxel-downsampled at
    the full map caps.  Returns (corner_map, corner_valid, surf_map,
    surf_valid)."""
    return mp._gather_local_map(state, center, cfg, _offset(state, comm))


def _knn5_global(q, pts, val, cfg: PipelineConfig, comm: Comm):
    """5-NN of q in this rank's map shard, gathered and merged: the 5
    global nearest map points (Q, 5, 3) and their d2 (Q, 5), the same on
    every rank.  One all-gather, of points and distances packed."""
    li, ld2 = knn(q, pts, val, 5, cfg.nn_query_tile)
    both = comm.all_gather(torch.cat([ld2[..., None], pts[li.long()]], -1))
    d2, nn = merge_candidates(both[..., 0], both[..., 1:], 5)
    return nn, d2


def solve_sharded(maps, corner_pts, corner_ok, surf_pts, surf_ok, T_pred: Pose,
                  cfg: PipelineConfig, comm: Comm):
    """One sharded mapping solve against the ranks' local-map shards
    `maps`: the map gate on the all-reduced counts of valid map points,
    then models/mapping.register with the merged 5-NN.  Returns (T,
    n_keep): n_keep is the last GN step's constraint count, as the JAX
    package's sharded solve returns it."""
    cm, cmv, sm, smv = maps
    (n_c, n_s), = comm.all_reduce_sum(torch.stack([cmv.sum(), smv.sum()]))
    map_gate = (n_c > 10) & (n_s > 100)

    def nearest(qc, qs):
        return _knn5_global(qc, cm, cmv, cfg, comm), _knn5_global(qs, sm, smv, cfg, comm)

    T, _, n_keep = mp.register(T_pred, corner_pts, corner_ok, surf_pts, surf_ok,
                               nearest, map_gate, cfg)
    return T, n_keep


def _empty_outliers(cfg: PipelineConfig, dev):
    return (torch.zeros((cfg.kf_outlier_cap, 3), dtype=torch.float32, device=dev),
            torch.zeros(cfg.kf_outlier_cap, dtype=torch.bool, device=dev))


def backend_step_sharded(state: MappingState, corner_pts, corner_ok, surf_pts,
                         surf_ok, odom_pose: Pose, time, cfg: PipelineConfig,
                         comm: Comm, map_cache=None, outlier=None):
    """One full sharded mapping solve.  corner / surf are the current
    scan's downsampled clouds (models/mapping.scan_clouds); `outlier` its
    downsampled outlier cloud for the keyframe's outlier block, which stays
    empty without it (the JAX package's sharded step never writes that
    block).  Returns (new_state, mapped_pose, n_constraints, map_cache)
    with mapping_step's insertion and latch semantics; the mapped rotation
    is projected onto SO(3), as mapping_step does.

    map_cache: this rank's local-map shard from a previous call, to skip
    the re-gather; None gathers it.  The refresh policy is the caller's
    (ShardedBackend)."""
    dev = odom_pose.t.device
    time = torch.full((), float(time), dtype=torch.float32, device=dev)
    T_pred = mp.predict_pose(state, odom_pose)
    if map_cache is None:
        map_cache = _shard_local_map(state, T_pred.t, cfg, comm)
    T, n_keep = solve_sharded(map_cache, corner_pts, corner_ok, surf_pts, surf_ok,
                              T_pred, cfg, comm)
    T = Pose(project_so3(T.R), T.t)
    clouds = ((corner_pts, corner_ok), (surf_pts, surf_ok),
              outlier if outlier is not None else _empty_outliers(cfg, dev))
    new_state = mp.insert_keyframe(state, T, odom_pose, time, clouds, cfg,
                                   _offset(state, comm))
    return new_state, T, n_keep, map_cache


def _owned_clouds(state: MappingState, idx, ok, cfg: PipelineConfig, comm: Comm):
    """Keyframe clouds of idx (models/loop._keyframe_cloud, map frame):
    zeros where this rank does not own the keyframe, so a sum over the
    ranks takes each from its owner exactly; points of a keyframe that `ok`
    rules out are not valid."""
    pts, val = lc._keyframe_cloud(state, idx, cfg, offset=_offset(state, comm))
    return pts, val & ok[..., None]


def loop_closure_step_sharded(state: MappingState, time, cfg: PipelineConfig,
                              comm: Comm):
    """A loop check on the sharded pool; the contract of
    models/loop.loop_closure_step.  Detection, the history selection, ICP,
    the gates and the pose-graph solve run on the whole pose-level arrays,
    the same on every rank; the newest keyframe's cloud and the history
    submap come out of the pool by one all-reduce.  Returns (new_state,
    LoopResult)."""
    dev = state.kf_t.device
    time = torch.full((), float(time), dtype=torch.float32, device=dev)
    latest, cand, found = lc._detect(state, time, cfg)
    sel, sel_ok = lc._history_selection(state, cand, time, cfg)
    src, src_val = _owned_clouds(state, latest, torch.ones((), dtype=torch.bool,
                                                           device=dev), cfg, comm)
    hist, hist_val = _owned_clouds(state, sel, sel_ok, cfg, comm)
    src, src_val, hist, hist_val = comm.all_reduce_sum(
        src, src_val.to(torch.float32), hist, hist_val.to(torch.float32))
    hist, hist_val = voxel_downsample(hist.reshape(-1, 3), hist_val.reshape(-1) > 0.5,
                                      cfg.leaf_history, cfg.max_map_surf)
    return lc._loop_core(state, src, src_val > 0.5, hist, hist_val,
                         latest, cand, found, time, cfg)


def _all_gather_pool(state: MappingState, comm: Comm) -> MappingState:
    """The whole pool on every rank: each block field gathered once."""
    def whole(a):
        g = comm.all_gather(a.to(torch.uint8) if a.dtype == torch.bool else a)
        return g.reshape((-1,) + a.shape[1:]).to(a.dtype)
    return state._replace(**{f: whole(getattr(state, f)) for f in POOL_FIELDS})


class ShardedBackend:
    """The sharded back end's host loop: the mapping state (its pool
    sharded to this rank), this rank's cached local-map shard and the
    compaction cadence -- mapping_step's policies, on the host:

      * the cached map shards refresh every cfg.map_refresh_every solves,
        after mark_stale() and after an accepted loop closure;
      * every `compact_check_every` solves the host reads n_kf (one sync),
        and at max_keyframes - 1 the pool is compacted: gathered whole,
        thinned by models/mapping.compact_keyframes, and cut to its slices
        again;
      * loop_step reads its accept flag (one sync a check).

    Those are the only host syncs.  `state` may hold the whole pool (it is
    cut to this rank's slice) or the slice."""

    def __init__(self, state: MappingState, cfg: PipelineConfig, comm: Comm | None = None,
                 compact_check_every: int = 32):
        self.cfg = cfg
        self.comm = comm if comm is not None else Comm()
        if cfg.max_keyframes % self.comm.size:
            raise ValueError(f"max_keyframes {cfg.max_keyframes} must divide by the "
                             f"world size {self.comm.size}")
        if state.kf_corner.shape[0] == cfg.max_keyframes:
            state = shard_pool(state, self.comm.rank, self.comm.size)
        self.state = state
        self.compact_check_every = compact_check_every
        self.map_cache = None
        self._age = 0
        self._steps = 0

    def mark_stale(self) -> None:
        """Invalidate the cached local map (keyframe poses rewritten)."""
        self.map_cache = None

    def loop_step(self, time):
        """One loop check on the sharded pool; the cadence is the caller's.
        Reads the accept flag (one host sync a check): an accepted closure
        rewrites keyframe poses, so the map shards must be re-gathered."""
        self.state, res = loop_closure_step_sharded(self.state, time, self.cfg, self.comm)
        if bool(res.closed):
            self.map_cache = None
        return res

    def _compact(self) -> None:
        whole = mp.compact_keyframes(_all_gather_pool(self.state, self.comm), self.cfg)
        self.state = shard_pool(whole, self.comm.rank, self.comm.size)
        self.map_cache = None

    def step(self, corner_pts, corner_ok, surf_pts, surf_ok, odom_pose: Pose, time,
             outlier=None):
        """One mapping solve (backend_step_sharded); returns (mapped_pose,
        n_constraints)."""
        cfg = self.cfg
        if self._steps % self.compact_check_every == 0:
            if int(self.state.n_kf) >= cfg.max_keyframes - 1:
                self._compact()
        if self._age >= cfg.map_refresh_every - 1:
            self.map_cache = None
        self._age = 0 if self.map_cache is None else self._age + 1
        self._steps += 1
        self.state, T, n_keep, self.map_cache = backend_step_sharded(
            self.state, corner_pts, corner_ok, surf_pts, surf_ok, odom_pose, time,
            cfg, self.comm, self.map_cache, outlier)
        return T, n_keep
