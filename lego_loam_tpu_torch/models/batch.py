"""Batched multi-sequence SLAM: B aligned sequences on one card
(counterpart of ``lego_loam_tpu.models.batch``).

B sequences from the same sensor on the same scan clock -- a fleet's
drives replayed offline -- advance exactly as B independent lidar-only
chunked pipelines would, but every step runs for all B at once: the
per-scan step (models/pipeline.scan_step) goes through torch.func.vmap,
so each PyTorch op of the step is one call on B sequences and each of the
kernels K1, K2, K3 and E1 is one launch a call site for the whole batch
(their custom ops' vmap rules; K1 splits into more launches only where a
batch's blocks cannot all be co-resident).  The host's launch work, which
bounds a single sequence on the card, then carries B scans.  This is the
throughput configuration for offline replay, not a latency mode.

The mapping and loop-check cadences stay unbatched: every sequence shares
the frame counter, so each step's branches are host decisions, as in the
JAX package.  Host values that differ by sequence stay on the host, one
a sequence: map_age and map_stale (a refresh that the sequences disagree
on becomes a per-sequence select, the JAX package's cond under vmap), and
the pending loop flags, read once before a solve that follows a loop
check.  Pool thinning follows the JAX package's batch policy: when the
worst sequence comes within a chunk's inserts (and a margin) of
capacity, every sequence is compacted; a host upper bound on the
keyframe counts means the counts are read only near that point.
"""

from __future__ import annotations

import time as _time

import numpy as np
import torch
from torch.func import vmap
from torch.utils._pytree import tree_map_only

from lego_loam_tpu_torch.config import PipelineConfig
from lego_loam_tpu_torch.models import mapping as mp
from lego_loam_tpu_torch.models import odometry as odo
from lego_loam_tpu_torch.models.pipeline import ChunkResult, _to_device, scan_step
from lego_loam_tpu_torch.ops.features import check_k2_fits
from lego_loam_tpu_torch.utils.math3d import Pose
from lego_loam_tpu_torch.utils.precision import apply_f32_policy

# the vmapped dimension of each leaf of a stacked state: 0, except the
# MappingState fields that live on the host (one a sequence, outside vmap)
_M_DIMS = mp.MappingState(*[0] * len(mp.MappingState._fields))._replace(
    map_age=None, map_stale=None)


def _device_part(mstate: mp.MappingState) -> mp.MappingState:
    """A stacked MappingState with placeholders for its host fields, as the
    vmapped functions take it."""
    return mstate._replace(map_age=0, map_stale=False)


def batch_chunk_steps(pipe, xyz, valid, ring, times):
    """C scans of B sequences on device tensors (xyz (B, C, N, 3), valid
    (B, C, N), ring (B, C, N) or None, a host stamp each in `times`, shared
    by the batch): a host loop over the vmapped per-scan step, the mapping
    and loop cadences from the batch's shared frame counter.  Advances
    `pipe` (a BatchPipeline) and returns the outputs stacked (B, C, ...) on
    the device: (odometry poses, fused poses, the aft_mapped latch after
    each scan's mapping step, did_map (C,) bool, loop flags (B, C) bool,
    stats (B, C, 5))."""
    cfg = pipe.cfg
    outs, did = [], []
    for j, t in enumerate(times):
        did_map = pipe.frame % cfg.mapping_process_every == 0
        loop_ran = (cfg.loop_closure_enabled
                    and pipe.frame % pipe.loop_check_every == 0)
        refresh = None
        if did_map:
            pipe.sync_map_stale()
            due = [mp.refresh_due(a, s, cfg)
                   for a, s in zip(pipe.mstate.map_age, pipe.mstate.map_stale)]
            # sequences that agree keep the single branch; a disagreement
            # gathers for all and selects per sequence
            refresh = (due[0] if len(set(due)) == 1 else
                       _to_device(due, torch.bool, pipe.device))

        def step(o, m, x, v, r, rf):
            return scan_step(o, m, x, v, r, t, cfg, did_map, loop_ran,
                             refresh=rf)

        r_dim = None if ring is None else 0
        rf_dim = 0 if isinstance(refresh, torch.Tensor) else None
        o, m, out = vmap(step, in_dims=(0, _M_DIMS, 0, 0, r_dim, rf_dim),
                         out_dims=(0, _M_DIMS, 0))(
            pipe.ostate, _device_part(pipe.mstate), xyz[:, j], valid[:, j],
            None if ring is None else ring[:, j], refresh)
        ages, stale = pipe.mstate.map_age, pipe.mstate.map_stale
        if did_map:
            ages = tuple(0 if d else a + 1 for a, d in zip(ages, due))
            stale = (False,) * pipe.batch
            pipe.n_kf_bound += 1
        pipe.ostate = o
        pipe.mstate = m._replace(map_age=ages, map_stale=stale)
        if loop_ran:
            closed = out[3]
            pipe._loop_flag = (closed if pipe._loop_flag is None
                               else pipe._loop_flag | closed)
        pipe.frame += 1
        outs.append(out)
        did.append(did_map)
    opose, fused, latch, closed, stats = zip(*outs)

    def stack(poses):
        return Pose(torch.stack([p.R for p in poses], 1),
                    torch.stack([p.t for p in poses], 1))

    did_map = _to_device(did, torch.bool, pipe.device)
    return (stack(opose), stack(fused), stack(latch), did_map,
            torch.stack(closed, 1), torch.stack(stats, 1))


def _stack_states(cfg: PipelineConfig, batch: int, device):
    """B copies of the initial odometry and mapping states, stacked on a
    leading axis (the host fields one a sequence)."""
    def rep(state):
        return tree_map_only(
            torch.Tensor, lambda v: v.expand((batch,) + v.shape).contiguous(),
            state)

    m1 = mp.init_state(cfg, device)
    mstate = rep(m1)._replace(map_age=(m1.map_age,) * batch,
                              map_stale=(m1.map_stale,) * batch)
    return rep(odo.init_state(cfg, device)), mstate


def compact_keyframes(mstate: mp.MappingState, cfg: PipelineConfig
                      ) -> mp.MappingState:
    """models/mapping.compact_keyframes on every sequence of a stacked
    state (the JAX package's jax.vmap of it); every sequence's map turns
    stale."""
    out = vmap(lambda m: mp.compact_keyframes(m, cfg), in_dims=(_M_DIMS,),
               out_dims=_M_DIMS)(_device_part(mstate))
    B = mstate.kf_t.shape[0]
    return out._replace(map_age=mstate.map_age, map_stale=(True,) * B)


class BatchPipeline:
    """Host loop for B aligned sequences (same scan clock, same sensor).

    Feed chunks with process_chunk(xyz (B, C, N, 3), ...); per-sequence
    states advance exactly as B independent LegoLoamPipeline instances
    would (lidar-only, chunked mode), away from the pool's capacity, where
    the batch thins every sequence at once (module docstring).  `ostate`
    and `mstate` carry a leading B axis: ``mstate.kf_t[b]`` is sequence
    b's pool, ``mstate.map_age[b]`` its host refresh age.  The batch runs
    where its state lives, on `device`: the card by default; pass
    ``device="cpu"`` for the kernels' plain versions.  Nothing is copied
    to the host a chunk: results and `trajectory` ((B, C, 3) blocks) stay
    on the device."""

    def __init__(self, cfg: PipelineConfig, batch: int,
                 loop_check_every: int = 10, device="cuda"):
        self.cfg = cfg
        self.batch = batch
        self.loop_check_every = loop_check_every
        self.device = torch.device(device)
        if self.device.type == "cuda":
            check_k2_fits(cfg)
        apply_f32_policy()
        self.ostate, self.mstate = _stack_states(cfg, batch, self.device)
        self.frame = 0
        # host upper bound on the largest n_kf of the batch (one insert a
        # sequence a solve at most)
        self.n_kf_bound = 0
        # (B,) OR of the loop flags the host has not read yet
        self._loop_flag: torch.Tensor | None = None
        self.trajectory: list = []   # (B, C, 3) device blocks per chunk

    def sync_map_stale(self) -> None:
        """Read the pending (B,) loop flags, if a loop check ran since the
        host last read them (one host sync), into map_stale."""
        if self._loop_flag is not None:
            flags = self._loop_flag.tolist()
            self.mstate = self.mstate._replace(map_stale=tuple(
                s or f for s, f in zip(self.mstate.map_stale, flags)))
            self._loop_flag = None

    def _maybe_compact(self, C: int) -> None:
        """The JAX package's batch policy: when the worst sequence is within
        `reserve` of capacity, compact every sequence."""
        cfg = self.cfg
        limit = cfg.max_keyframes - max(40, -(-C // cfg.mapping_process_every) + 1)
        if self.n_kf_bound < limit:
            return
        self.n_kf_bound = int(self.mstate.n_kf.max())
        if self.n_kf_bound >= limit:
            self.mstate = compact_keyframes(self.mstate, cfg)
            self.n_kf_bound = int(self.mstate.n_kf.max())

    def process_chunk(self, xyz, valid, ring=None, t0: float | None = None
                      ) -> ChunkResult:
        """C scans of each sequence: xyz (B, C, N, 3), valid (B, C, N), ring
        (B, C, N) for a ring sensor; scan j of every sequence is stamped
        t0 + j * scan_period (t0 defaults to frame * scan_period).  Returns
        a ChunkResult whose poses, loop flags and stats are (B, C, ...) and
        whose did_map is (C,), shared by the batch."""
        cfg = self.cfg
        dev = self.device
        w0 = _time.perf_counter()
        t0 = float(t0) if t0 is not None else self.frame * cfg.sensor.scan_period
        if len(getattr(xyz, "shape", ())) != 4 or xyz.shape[0] != self.batch:
            raise ValueError(f"expected xyz (B={self.batch}, C, N, 3), got "
                             f"{tuple(getattr(xyz, 'shape', ()))}")
        if cfg.sensor.use_ring and ring is None:
            raise ValueError(
                f"sensor {cfg.sensor.name} expects a ring channel; pass "
                "ring= or use an elevation-math preset (use_ring=False)")
        xyz = _to_device(xyz, torch.float32, dev)
        valid = _to_device(valid, torch.bool, dev)
        ring = (_to_device(ring, torch.int32, dev)
                if ring is not None and cfg.sensor.use_ring else None)
        C = xyz.shape[1]
        times = [t0 + j * cfg.sensor.scan_period for j in range(C)]
        self._maybe_compact(C)
        opose, fused, latch, did_map, closed, stats = batch_chunk_steps(
            self, xyz, valid, ring, times)
        self.trajectory.append(fused.t)
        return ChunkResult(
            odom_poses=opose, fused_poses=fused, mapped_poses=latch,
            did_map=did_map, loop_closed=closed, stats=stats,
            wall_ms=(_time.perf_counter() - w0) * 1e3)

    def keyframe_counts(self) -> np.ndarray:
        return self.mstate.n_kf.cpu().numpy()
