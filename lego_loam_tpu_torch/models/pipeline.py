"""Full SLAM pipeline: the reference's four ROS processes as two device
stages driven by a thin host loop (counterpart of
``lego_loam_tpu.models.pipeline``, per-scan mode).

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
process_scan; the IMU buffer goes up once a scan without a wait.  Chunked
replay is not ported yet.
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


@dataclass
class FrameResult:
    odom_pose: Pose
    fused_pose: Pose
    mapped_pose: Pose | None
    loop_closed: bool
    stats: dict
    wall_ms: float


class LegoLoamPipeline:
    """Host loop.  Feed scans with process_scan(); poses come back in the
    map frame of the first scan.  The pipeline runs where its state lives,
    on `device`: the card by default, where the kernels run; pass
    ``device="cpu"`` for their plain versions.  On the card a config that
    kernel K2 cannot take raises ValueError here, before any scan."""

    def __init__(self, cfg: PipelineConfig, device="cuda",
                 loop_check_every: int = 10):
        self.cfg = cfg
        self.device = torch.device(device)
        self.loop_check_every = loop_check_every
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
        self.trajectory: list[np.ndarray] = []

    def _maybe_compact(self) -> None:
        cfg = self.cfg
        if self.n_kf_bound < cfg.max_keyframes - 1:
            return
        self.n_kf_bound = int(self.mstate.n_kf)
        if self.n_kf_bound >= cfg.max_keyframes - 1:
            self.mstate = mp.compact_keyframes(self.mstate, cfg)
            self.n_kf_bound = int(self.mstate.n_kf)

    def push_imu(self, t, att_R, acc_body, gyro) -> None:
        """Ingest a 9-DOF IMU sample (world attitude matrix, body specific
        force, body angular rate), the reference's imuHandler
        (featureAssociation.cpp:431-459).  On the host; the buffer goes to
        the device once a scan."""
        self.imu_host.push(t, att_R, acc_body, gyro)
        self.imu_used = True

    def process_scan(self, xyz, valid, ring=None, t: float | None = None
                     ) -> FrameResult:
        cfg = self.cfg
        dev = self.device
        t = float(t) if t is not None else self.frame * cfg.sensor.scan_period
        t0 = _time.perf_counter()
        use_ring = cfg.sensor.use_ring
        if use_ring and ring is None:
            raise ValueError(
                f"sensor {cfg.sensor.name} expects a ring channel; pass "
                "ring= or use an elevation-math preset (use_ring=False)")
        xyz = torch.as_tensor(xyz, dtype=torch.float32, device=dev)
        valid = torch.as_tensor(valid, dtype=torch.bool, device=dev)
        ring_t = (torch.as_tensor(ring, dtype=torch.int32, device=dev)
                  if ring is not None else None)

        imu_buf = t_dev = None
        if self.imu_used:
            imu_buf = self.imu_host.to_device(dev)
            t_dev = torch.full((), t, dtype=torch.float32, device=dev)
        self.ostate, feats, opose, rel, fused, stats = frontend_step(
            self.ostate, xyz, valid, ring_t, self.mstate.bef_mapped,
            self.mstate.aft_mapped, t_dev, cfg, use_ring, imu_buf=imu_buf)

        mapped = None
        if self.frame % cfg.mapping_process_every == 0:
            self._maybe_compact()
            mfeats = feats._replace(less_sharp=self.ostate.ref_corner,
                                    less_flat=self.ostate.ref_surf)
            self.mstate, mapped = mp.mapping_step(self.mstate, mfeats, opose,
                                                  t, cfg, imu_buf=imu_buf)
            self.n_kf_bound += 1

        # the loop-check cadence is independent of the mapping cadence (the
        # reference's 1 Hz thread made deterministic)
        closed = torch.zeros((), dtype=torch.bool, device=dev)
        loop_ran = (cfg.loop_closure_enabled
                    and self.frame % self.loop_check_every == 0)
        if loop_ran:
            self.mstate, res = lc.loop_closure_step(self.mstate, t, cfg)
            closed = res.closed
        if mapped is not None or loop_ran:
            fused = fuse_pose(self.mstate, opose)

        # the one host copy per scan: fused translation, packed stats and
        # the loop flag
        host = torch.cat([fused.t, stats.to(torch.float32),
                          closed.to(torch.float32)[None]]).tolist()
        self.trajectory.append(np.asarray(host[:3], np.float32))
        loop_closed = bool(host[-1])
        if loop_closed:
            # keyframe poses moved: re-gather the local map at the next
            # solve, which comes on a later scan (the JAX package sets this
            # flag on the device)
            self.mstate = self.mstate._replace(map_stale=True)
        wall_ms = (_time.perf_counter() - t0) * 1e3
        self.frame += 1
        return FrameResult(
            odom_pose=opose, fused_pose=fused, mapped_pose=mapped,
            loop_closed=loop_closed,
            stats=dict(zip(STAT_NAMES, (int(v) for v in host[3:-1]))),
            wall_ms=wall_ms)

    def keyframe_poses(self) -> np.ndarray:
        n = int(self.mstate.n_kf)
        return self.mstate.kf_t[:n].cpu().numpy()
