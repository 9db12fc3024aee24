"""Full SLAM pipeline: the reference's four ROS processes as two device
stages driven by a thin host loop (counterpart of
``lego_loam_tpu.models.pipeline``).

  * front-end, every scan: projection + segmentation + features +
    scan-to-scan odometry + the pose fuse;
  * back-end, every cfg.mapping_process_every scans: scan-to-map +
    keyframe update;
  * loop closure (cfg.loop_closure_enabled), every loop_check_every scans:
    loop detection, ICP against the history submap and the pose-graph
    solve (models/loop.py), applied on the device only when accepted.

With an IMU stream (push_imu), the front end seeds the odometry from the
integrated gyro, de-skews the features per point (cfg.deskew) and folds
the AHRS attitude into the odometry pose, and each mapping solve blends in
the IMU's roll and pitch (models/imu.py), in the JAX package's order.

The host loop never waits on the card inside a scan except for one copy of
the fused translation, the packed stats and the loop flag at the end of
process_scan; the IMU buffer goes up once a scan without a wait.  With
collect_stats=False even that copy goes: poses, stats and loop flags stay
on the card until the caller reads them.

Chunked replay (process_chunk through chunk_steps, as in the JAX package)
is a host loop over the same per-scan step: the C scans and the IMU buffer go up
once a chunk without a wait, the mapping and loop cadences come from host
frame counters, and the outputs are stacked on the card; with
collect_stats one host copy of the fused translations ends the chunk.
Capturing the step in a CUDA graph is later work.

The one decision that waits on the card is the local-map refresh after a
loop check: MappingState.map_stale is a host value (models/mapping.py),
and an accepted loop must make the next solve re-gather the map (the JAX
package sets ``map_stale | accept`` on the device).  A loop check's flag
is ORed into a pending device flag; the host copy of a scan reads it for
free, and a solve that finds it still pending reads it first (one host
sync a loop check that precedes a solve without a host copy in between,
none with loop closure off).  The result is the JAX package's exactly.
"""

from __future__ import annotations

import time as _time
from dataclasses import dataclass

import numpy as np
import torch

from lego_loam_tpu_torch.config import PipelineConfig
from lego_loam_tpu_torch.models import imu as imu_mod
from lego_loam_tpu_torch.models import loop as lc
from lego_loam_tpu_torch.models import mapping as mp
from lego_loam_tpu_torch.models import odometry as odo
from lego_loam_tpu_torch.models.fusion import fuse_pose
from lego_loam_tpu_torch.ops.compaction import segment_scan
from lego_loam_tpu_torch.ops.features import check_k2_fits, extract_features
from lego_loam_tpu_torch.ops.projection import project_scan
from lego_loam_tpu_torch.utils.math3d import Pose
from lego_loam_tpu_torch.utils.precision import apply_f32_policy

STAT_NAMES = ("n_valid_px", "n_ground", "n_segmented", "n_sharp", "n_flat")


def frontend_step(ostate, xyz, valid, ring, bef_mapped: Pose, aft_mapped: Pose,
                  t, cfg: PipelineConfig, use_ring: bool, imu_buf=None):
    """scan -> features -> odometry pose -> fused pose.  Returns
    (ostate, feats, opose, rel, fused, stats (5,) int32).

    With imu_buf (models/imu.ImuBuffer) the IMU path runs in the
    reference's order (featureAssociation.cpp): the odometry seed from the
    integrated gyro and velocity change (:1639-1664), the per-point de-skew
    of the feature clouds when cfg.deskew (:317-390, 560-607), and the AHRS
    attitude fold into the odometry pose (:955-1042, 1697-1725).  t is the
    scan's float32 start stamp, a 0-d tensor."""
    if imu_buf is not None:
        si = imu_mod.scan_imu(imu_buf, t, cfg)
        ostate = ostate._replace(
            rel=imu_mod.odometry_seed(ostate.rel, si, cfg.sensor.scan_period))
    img = project_scan(xyz, valid, cfg, ring if use_ring else None)
    packed, o_rel, ground, _ = segment_scan(img, cfg)
    feats = extract_features(packed, o_rel, cfg)
    if imu_buf is not None and cfg.deskew:
        feats = imu_mod.deskew_features(feats, imu_buf, t, cfg)
    ostate, opose, rel = odo.odometry_step(ostate, feats, cfg)
    if imu_buf is not None:
        ostate = imu_mod.fold_attitude(ostate, imu_buf, t, cfg)
        opose = ostate.pose
    fused = aft_mapped.compose(bef_mapped.inverse().compose(opose))
    stats = torch.stack([
        img.valid.sum(), ground.sum(), packed.count.sum(),
        feats.sharp.valid.sum(), feats.flat.valid.sum(),
    ]).to(torch.int32)
    return ostate, feats, opose, rel, fused, stats


def scan_step(ostate, mstate, xyz, valid, ring, t: float, cfg: PipelineConfig,
              did_map: bool, loop_ran: bool, refresh=None, imu_buf=None):
    """One scan on device tensors, a pure function of the states and the
    step's host decisions: the front end, the mapping solve if `did_map`
    (`refresh` as models/mapping.mapping_step takes it), the loop check if
    `loop_ran`, the re-fuse.  Returns (ostate, mstate, (odom pose, fused
    pose, the aft_mapped latch after mapping, loop flag, stats)).

    LegoLoamPipeline runs it on one sequence; models/batch.py runs it under
    torch.func.vmap on B, so it returns tensors only: the host fields of
    the state (map_age, map_stale, the pending loop flag, the keyframe
    bound) are the caller's."""
    t_dev = (torch.full((), t, dtype=torch.float32, device=xyz.device)
             if imu_buf is not None else None)
    ostate, feats, opose, rel, fused, stats = frontend_step(
        ostate, xyz, valid, ring, mstate.bef_mapped, mstate.aft_mapped, t_dev,
        cfg, cfg.sensor.use_ring, imu_buf=imu_buf)
    if did_map:
        mfeats = feats._replace(less_sharp=ostate.ref_corner,
                                less_flat=ostate.ref_surf)
        mstate, _ = mp.mapping_step(mstate, mfeats, opose, t, cfg,
                                    imu_buf=imu_buf, refresh=refresh)
    latch = mstate.aft_mapped
    closed = torch.zeros((), dtype=torch.bool, device=xyz.device)
    if loop_ran:
        mstate, res = lc.loop_closure_step(mstate, t, cfg)
        closed = res.closed
    if did_map or loop_ran:
        fused = fuse_pose(mstate, opose)
    return ostate, mstate, (opose, fused, latch, closed, stats)


@dataclass
class FrameResult:
    odom_pose: Pose
    fused_pose: Pose
    mapped_pose: Pose | None
    loop_closed: bool | torch.Tensor   # a device bool with collect_stats=False
    stats: dict
    wall_ms: float


@dataclass
class ChunkResult:
    odom_poses: Pose        # stacked (C, ...) sweep-end odometry poses
    fused_poses: Pose       # stacked (C, ...) map-accurate poses at scan rate
    mapped_poses: Pose      # stacked; rows where did_map is False repeat the latch
    did_map: torch.Tensor   # (C,) bool
    loop_closed: torch.Tensor  # (C,) bool
    stats: torch.Tensor     # (C, 5) int32 packed per-scan stats
    wall_ms: float


def chunk_steps(pipe: "LegoLoamPipeline", xyz, valid, ring, times, imu_buf=None):
    """C scans on device tensors (xyz (C, N, 3), valid (C, N), ring (C, N)
    or None, a host stamp each in `times`): a host loop over the pipeline's
    per-scan step, the mapping and loop cadences from its host frame
    counter, so nothing waits on the card between scans.  Returns the
    outputs stacked on the device, as the JAX package's chunk_steps does:
    (odometry poses, fused poses, the aft_mapped latch after each scan's
    mapping step, did_map (C,) bool, loop flags (C,) bool, stats (C, 5))."""
    dev = pipe.device
    outs = [pipe._step(xyz[j], valid[j], None if ring is None else ring[j],
                       times[j], imu_buf) for j in range(len(times))]
    opose, fused, latch, did_map, closed, stats = zip(*outs)

    def stack(poses):
        return Pose(torch.stack([p.R for p in poses]),
                    torch.stack([p.t for p in poses]))

    did_map = torch.stack([torch.full((), d, dtype=torch.bool, device=dev)
                           for d in did_map])
    return (stack(opose), stack(fused), stack(latch), did_map,
            torch.stack(closed), torch.stack(stats))


def _to_device(a, dtype, dev) -> torch.Tensor:
    """`a` as a `dtype` tensor on `dev`; host data goes up to the card
    through pinned memory without a wait (a plain copy from pageable memory
    would make the host wait for it)."""
    if isinstance(a, torch.Tensor) and a.device == dev and a.dtype == dtype:
        return a
    t = torch.as_tensor(a, dtype=dtype)
    if dev.type != "cuda" or t.is_cuda:
        return t.to(dev)
    return t.pin_memory().to(dev, non_blocking=True)


class LegoLoamPipeline:
    """Host loop.  Feed scans with process_scan() or chunks of scans with
    process_chunk(); poses come back in the map frame of the first scan.
    The pipeline runs where its state lives, on `device`: the card by
    default, where the kernels run; pass ``device="cpu"`` for their plain
    versions.  On the card a config that kernel K2 cannot take raises
    ValueError here, before any scan.  With collect_stats=False no scan
    copies anything to the host: FrameResult.loop_closed is a device bool,
    `trajectory` holds device tensors, stats are {}."""

    def __init__(self, cfg: PipelineConfig, device="cuda",
                 loop_check_every: int = 10, collect_stats: bool = True):
        self.cfg = cfg
        self.device = torch.device(device)
        self.loop_check_every = loop_check_every
        self.collect_stats = collect_stats
        if self.device.type == "cuda":
            check_k2_fits(cfg)
        apply_f32_policy()
        self.ostate = odo.init_state(cfg, self.device)
        self.mstate = mp.init_state(cfg, self.device)
        self.imu_host = imu_mod.HostImuBuffer(cfg)
        self.imu_used = False
        self.frame = 0
        # host upper bound on mstate.n_kf: at most one insert per solve, so
        # the device count is read only when this reaches capacity
        self.n_kf_bound = 0
        self.compactions = 0    # pool thinnings so far (a host count)
        # OR of the loop flags the host has not read yet (a device bool)
        self._loop_flag: torch.Tensor | None = None
        self.trajectory: list = []

    def _maybe_compact(self) -> None:
        cfg = self.cfg
        if self.n_kf_bound < cfg.max_keyframes - 1:
            return
        self.n_kf_bound = int(self.mstate.n_kf)
        if self.n_kf_bound >= cfg.max_keyframes - 1:
            self.mstate = mp.compact_keyframes(self.mstate, cfg)
            self.n_kf_bound = int(self.mstate.n_kf)
            self.compactions += 1

    def sync_map_stale(self) -> None:
        """Read the pending loop flag, if a loop check ran since the host
        last saw one (one host sync), and set mstate.map_stale from it."""
        if self._loop_flag is not None:
            if bool(self._loop_flag):
                self.mstate = self.mstate._replace(map_stale=True)
            self._loop_flag = None

    def _copy_to_host(self, *parts: torch.Tensor) -> list:
        """The one host copy: `parts` as floats, flattened in order, with
        the pending loop flag riding along to settle map_stale."""
        pend = self._loop_flag
        flat = [p.reshape(-1).to(torch.float32) for p in parts]
        if pend is not None:
            flat.append(pend.reshape(1).to(torch.float32))
        vals = torch.cat(flat).tolist()
        if pend is not None:
            if vals.pop():
                self.mstate = self.mstate._replace(map_stale=True)
            self._loop_flag = None
        return vals

    def push_imu(self, t, att_R, acc_body, gyro) -> None:
        """Ingest a 9-DOF IMU sample (world attitude matrix, body specific
        force, body angular rate), the reference's imuHandler
        (featureAssociation.cpp:431-459).  On the host; the buffer goes to
        the device once a scan (once a chunk in process_chunk)."""
        self.imu_host.push(t, att_R, acc_body, gyro)
        self.imu_used = True

    def _check_ring(self, ring) -> None:
        if self.cfg.sensor.use_ring and ring is None:
            raise ValueError(
                f"sensor {self.cfg.sensor.name} expects a ring channel; pass "
                "ring= or use an elevation-math preset (use_ring=False)")

    def _step(self, xyz, valid, ring, t: float, imu_buf):
        """One scan on device tensors: :func:`scan_step` with the mapping
        and loop cadences from the host frame counter.  Returns (odom
        pose, fused pose, the aft_mapped latch after mapping, did_map, loop
        flag, stats)."""
        cfg = self.cfg
        did_map = self.frame % cfg.mapping_process_every == 0
        if did_map:
            self._maybe_compact()
            self.sync_map_stale()
        # the loop-check cadence is independent of the mapping cadence (the
        # reference's 1 Hz thread made deterministic)
        loop_ran = (cfg.loop_closure_enabled
                    and self.frame % self.loop_check_every == 0)
        self.ostate, self.mstate, (opose, fused, latch, closed, stats) = scan_step(
            self.ostate, self.mstate, xyz, valid, ring, t, cfg, did_map,
            loop_ran, imu_buf=imu_buf)
        if did_map:
            self.n_kf_bound += 1
        if loop_ran:
            self._loop_flag = (closed if self._loop_flag is None
                               else self._loop_flag | closed)
        self.frame += 1
        return opose, fused, latch, did_map, closed, stats

    def process_scan(self, xyz, valid, ring=None, t: float | None = None
                     ) -> FrameResult:
        cfg = self.cfg
        dev = self.device
        t = float(t) if t is not None else self.frame * cfg.sensor.scan_period
        t0 = _time.perf_counter()
        self._check_ring(ring)
        xyz = _to_device(xyz, torch.float32, dev)
        valid = _to_device(valid, torch.bool, dev)
        ring = (_to_device(ring, torch.int32, dev)
                if ring is not None and cfg.sensor.use_ring else None)
        imu_buf = self.imu_host.to_device(dev) if self.imu_used else None
        opose, fused, latch, did_map, closed, stats = self._step(
            xyz, valid, ring, t, imu_buf)

        if self.collect_stats:
            # the one host copy per scan: fused translation, packed stats,
            # the loop flag (and any pending one)
            host = self._copy_to_host(fused.t, stats, closed)
            self.trajectory.append(np.asarray(host[:3], np.float32))
            loop_closed = bool(host[-1])
            stats_d = dict(zip(STAT_NAMES, (int(v) for v in host[3:-1])))
        else:
            self.trajectory.append(fused.t)
            loop_closed = closed
            stats_d = {}
        return FrameResult(
            odom_pose=opose, fused_pose=fused,
            mapped_pose=latch if did_map else None, loop_closed=loop_closed,
            stats=stats_d, wall_ms=(_time.perf_counter() - t0) * 1e3)

    def process_chunk(self, xyz, valid, ring=None, t0: float | None = None
                      ) -> ChunkResult:
        """Process a chunk of C scans: xyz (C, N, 3), valid (C, N), ring
        (C, N) for a ring sensor; scan j is stamped t0 + j * scan_period
        (t0 defaults to frame * scan_period, as process_scan's stamps).
        The state advances exactly as C process_scan calls would.  If IMU
        samples were pushed, push ALL samples covering the chunk's time
        span before the call: the buffer goes up once a chunk."""
        cfg = self.cfg
        dev = self.device
        w0 = _time.perf_counter()
        self._check_ring(ring)
        xyz = _to_device(xyz, torch.float32, dev)
        valid = _to_device(valid, torch.bool, dev)
        ring = (_to_device(ring, torch.int32, dev)
                if ring is not None and cfg.sensor.use_ring else None)
        C = xyz.shape[0]
        period = cfg.sensor.scan_period
        times = ([(self.frame + j) * period for j in range(C)] if t0 is None
                 else [float(t0) + j * period for j in range(C)])
        imu_buf = self.imu_host.to_device(dev) if self.imu_used else None
        opose, fused, latch, did_map, closed, stats = chunk_steps(
            self, xyz, valid, ring, times, imu_buf)
        if self.collect_stats:
            host = np.asarray(self._copy_to_host(fused.t), np.float32)
            self.trajectory.extend(host.reshape(C, 3))
        else:
            self.trajectory.append(fused.t)   # (C, 3) on the device
        return ChunkResult(
            odom_poses=opose, fused_poses=fused, mapped_poses=latch,
            did_map=did_map, loop_closed=closed, stats=stats,
            wall_ms=(_time.perf_counter() - w0) * 1e3)

    def trajectory_numpy(self) -> np.ndarray:
        """(N, 3) fused translations, the device entries of
        collect_stats=False fetched now."""
        rows = [np.asarray(t.cpu() if isinstance(t, torch.Tensor) else t,
                           np.float32).reshape(-1, 3) for t in self.trajectory]
        return np.concatenate(rows) if rows else np.zeros((0, 3), np.float32)

    # ---- exports (mapOptmization.cpp:724-800) ----

    def keyframe_poses(self) -> np.ndarray:
        n = int(self.mstate.n_kf)
        return self.mstate.kf_t[:n].cpu().numpy()

    def global_map(self, what: str = "surf", radius: float | None = None,
                   center: np.ndarray | None = None) -> np.ndarray:
        """Keyframe blocks in the map frame (on the host, for export): one
        host copy of the pool's first n_kf blocks, then the JAX package's
        NumPy transform, so the same state exports the same bytes.

        With `radius`, only keyframes within that distance of `center`
        (default: the latest mapped pose) contribute -- the reference's
        global-map visualization filter (globalMapVisualizationSearchRadius,
        mapOptmization.cpp:724-800)."""
        st = self.mstate
        n = int(st.n_kf)
        blocks = {"surf": (st.kf_surf, st.kf_surf_valid),
                  "corner": (st.kf_corner, st.kf_corner_valid),
                  "outlier": (st.kf_outlier, st.kf_outlier_valid)}[what]
        pts, val = blocks[0][:n].cpu().numpy(), blocks[1][:n].cpu().numpy()
        R = st.kf_R[:n].cpu().numpy()
        t = st.kf_t[:n].cpu().numpy()
        if radius is not None and n > 0:
            c = (np.asarray(center) if center is not None
                 else st.aft_mapped.t.cpu().numpy())
            sel = np.linalg.norm(t - c, axis=1) <= radius
            pts, val, R, t = pts[sel], val[sel], R[sel], t[sel]
        out = np.einsum("kij,kcj->kci", R, pts) + t[:, None, :]
        return out[val]
