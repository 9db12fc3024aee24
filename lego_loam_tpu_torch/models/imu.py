"""IMU integration, attitude interpolation and de-skew support
(counterpart of ``lego_loam_tpu.models.imu``; featureAssociation.cpp:
317-459 -- 200-entry ring buffer, gravity removal, dead-reckoned velocity
and position, integrated body rates; :1639-1664 -- odometry seeding;
mapOptmization.cpp:463-496 -- roll / pitch blend into the mapped pose).

Same names, same arithmetic, float32 stamps.  Where the JAX package keeps
the ring's newest index and its sample count on the device, the port keeps
them on the host: ImuBuffer.ptr and .count are ints, which the host buffer
always knows.  So the one decision that depends on the count (is the
buffer usable: count >= 2) is a host bool, and nothing on the path reads
the card back.  The buffer reaches the card once a scan as one copy from a
fresh pinned staging tensor (HostImuBuffer.to_device): the copy runs
behind the host, and the next push rewrites the numpy arrays, never the
memory being copied.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from lego_loam_tpu_torch.config import PipelineConfig
from lego_loam_tpu_torch.utils.math3d import (
    Pose,
    euler_to_mat,
    mat_to_euler,
    so3_exp,
    so3_log,
)

GRAVITY = 9.81
QUE_LEN = 200  # imuQueLength (utility.h:109)


class ImuBuffer(NamedTuple):
    time: torch.Tensor    # (Q,) float32 sample stamps; -inf where empty
    att: torch.Tensor     # (Q, 3, 3) world attitude (from the 9-DOF AHRS)
    velo: torch.Tensor    # (Q, 3) dead-reckoned world velocity
    shift: torch.Tensor   # (Q, 3) dead-reckoned world position
    ang: torch.Tensor     # (Q, 3) integrated body angular rate
    ptr: int              # host: index of the newest sample
    count: int            # host: samples seen (saturates at QUE_LEN)


def init_buffer(device=None) -> ImuBuffer:
    return ImuBuffer(
        time=torch.full((QUE_LEN,), -torch.inf, dtype=torch.float32, device=device),
        att=torch.eye(3, dtype=torch.float32, device=device).expand(QUE_LEN, 3, 3).clone(),
        velo=torch.zeros((QUE_LEN, 3), dtype=torch.float32, device=device),
        shift=torch.zeros((QUE_LEN, 3), dtype=torch.float32, device=device),
        ang=torch.zeros((QUE_LEN, 3), dtype=torch.float32, device=device),
        ptr=QUE_LEN - 1,
        count=0,
    )


def _f32(x, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=like.device)


def imu_push(buf: ImuBuffer, t, att_R, acc_body, gyro,
             cfg: PipelineConfig) -> ImuBuffer:
    """Ingest one IMU sample on tensors (AccumulateIMUShiftAndRotation
    analog, featureAssociation.cpp:392-459).  The pipeline pushes through
    HostImuBuffer instead, with the same arithmetic on the host.

    att_R: (3, 3) world attitude.  acc_body: specific force in the body
    frame (includes the gravity reaction).  gyro: body angular rate."""
    t, att_R = _f32(t, buf.time), _f32(att_R, buf.time)
    acc_body, gyro = _f32(acc_body, buf.time), _f32(gyro, buf.time)
    g = torch.zeros(3, dtype=torch.float32, device=buf.time.device)
    g[2] = GRAVITY
    acc_w = att_R @ acc_body - g

    prev = buf.ptr
    dt = t - buf.time[prev]
    # the reference only integrates across gaps shorter than one sweep
    ok = (dt > 0) & (dt < cfg.sensor.scan_period) & (buf.count > 0)
    dtc = torch.where(ok, dt, 0.0)

    shift = buf.shift[prev] + buf.velo[prev] * dtc + 0.5 * acc_w * dtc * dtc
    velo = buf.velo[prev] + acc_w * dtc
    ang = buf.ang[prev] + gyro * dtc

    slot = (buf.ptr + 1) % QUE_LEN

    def put(arr, val):
        arr = arr.clone()
        arr[slot] = val
        return arr

    return ImuBuffer(
        time=put(buf.time, t), att=put(buf.att, att_R),
        velo=put(buf.velo, velo), shift=put(buf.shift, shift),
        ang=put(buf.ang, ang), ptr=slot, count=min(buf.count + 1, QUE_LEN))


def _ordered(buf: ImuBuffer):
    """Chronological view of the ring buffer (a roll by the host pointer)."""
    shift = (buf.ptr + 1) % QUE_LEN
    fields = (buf.time, buf.att, buf.velo, buf.shift, buf.ang)
    if shift == 0:
        return fields
    return tuple(torch.roll(x, -shift, 0) for x in fields)


def _interp_R(Ra, Rb, u):
    """Geodesic blend between attitudes; u in [0, 1]."""
    w = so3_log(Ra.transpose(-1, -2) @ Rb)
    return Ra @ so3_exp(u[..., None] * w)


def imu_sample(buf: ImuBuffer, t):
    """Interpolated (att_R, velo, shift, ang) at float32 time t (clamped to
    the buffer's range).  t may be a scalar or a vector."""
    times, att, velo, shift, ang = _ordered(buf)
    t = _f32(t, times)
    scalar = t.dim() == 0
    tv = t.reshape(-1)

    # side="left", as jnp.searchsorted's default
    hi = torch.clamp(torch.searchsorted(times, tv), 1, QUE_LEN - 1)
    lo = hi - 1
    t0, t1 = times[lo], times[hi]
    # an empty slot is -inf: u is NaN there until the where replaces it
    u = torch.clamp((tv - t0) / torch.clamp(t1 - t0, min=1e-6), 0.0, 1.0)
    u = torch.where(torch.isfinite(t0), u, 1.0)  # clamp below the oldest sample

    R = _interp_R(att[lo], att[hi], u)
    v = velo[lo] + u[:, None] * (velo[hi] - velo[lo])
    s = shift[lo] + u[:, None] * (shift[hi] - shift[lo])
    a = ang[lo] + u[:, None] * (ang[hi] - ang[lo])
    if scalar:
        return R[0], v[0], s[0], a[0]
    return R, v, s, a


def _sweep_ends(buf: ImuBuffer, t_scan, cfg: PipelineConfig):
    """imu_sample at the sweep's start and end stamps, in one call."""
    t_scan = _f32(t_scan, buf.time)
    return imu_sample(buf, torch.stack([t_scan, t_scan + cfg.sensor.scan_period]))


class ScanImu(NamedTuple):
    """Per-scan IMU summary consumed by odometry (the per-point drift for
    de-skew is recomputed from the buffer in _deskew_cloud)."""

    valid: bool                # host: the buffer had usable samples
    att_start: torch.Tensor    # (3, 3) attitude at sweep start
    rel_R: torch.Tensor        # (3, 3) sweep rotation from integrated gyro
    velo_delta: torch.Tensor   # (3,) velocity change over the sweep (start body)


def scan_imu(buf: ImuBuffer, t_scan, cfg: PipelineConfig) -> ScanImu:
    """Summarize the IMU over sweep [t_scan, t_scan + scan_period]
    (imuAngularFromStart / imuShiftFromStart / imuVeloFromStart,
    featureAssociation.cpp:573-607, 1639-1664)."""
    eye = torch.eye(3, dtype=torch.float32, device=buf.time.device)
    if buf.count < 2:
        return ScanImu(False, eye, eye, torch.zeros_like(eye[0]))
    R, v, _, a = _sweep_ends(buf, t_scan, cfg)
    R0, v0, v1 = R[0], v[0], v[1]
    rel_R = so3_exp(a[1] - a[0])  # integrated body rates over the sweep
    # the linear-acceleration part of the velocity change: a steady turn's
    # rotation-induced component ((rel_R - I) v0_body) is taken out
    v0_body = R0.T @ v0
    dv_body = R0.T @ (v1 - v0)
    dv_lin = dv_body - (rel_R - eye) @ v0_body
    return ScanImu(True, R0, rel_R, dv_lin)


def odometry_seed(prev_rel: Pose, si: ScanImu,
                  scan_period: float = 0.1) -> Pose:
    """Seed the scan-to-scan solve (updateInitialGuess analog,
    featureAssociation.cpp:1639-1664): rotation from the integrated gyro,
    translation as constant velocity plus the IMU's velocity-change
    correction (featureAssociation.cpp:345-352, 1659-1663)."""
    if not si.valid:
        return prev_rel
    return Pose(si.rel_R, prev_rel.t + si.velo_delta * scan_period)


def _deskew_points(xyz, s, valid, buf: ImuBuffer, t_scan, cfg: PipelineConfig):
    """The per-point IMU correction of _deskew_cloud on bare points."""
    if buf.count < 2:
        return xyz
    t_scan = _f32(t_scan, buf.time)
    R, _, sh, _ = _sweep_ends(buf, t_scan, cfg)
    R0, s0, s1 = R[0], sh[0], sh[1]
    wm = so3_log(R0.T @ R[1])                            # measured sweep rot

    t_p = t_scan + s * cfg.sensor.scan_period
    Rp, _, sp, _ = imu_sample(buf, t_p)                  # (N,3,3), (N,3)
    Rrel = R0.T @ Rp                                     # R0^T R(t_p)
    shift_s = (sp - s0) @ R0                             # R0^T (shift - s0)
    shift_1 = R0.T @ (s1 - s0)
    dev = shift_s - s[:, None] * shift_1                 # nonlinear drift
    inner = (Rrel @ xyz[:, :, None])[:, :, 0] + dev
    undo = so3_exp(-s[:, None] * wm)                     # (N,3,3)
    out = (undo @ inner[:, :, None])[:, :, 0]
    return torch.where(valid[:, None], out, xyz)


def _deskew_cloud(fc, buf: ImuBuffer, t_scan, cfg: PipelineConfig):
    """Per-point IMU de-skew correction of one feature cloud
    (ShiftToStartIMU / TransformToStartIMU applied per point in
    adjustDistortion, featureAssociation.cpp:317-390, 560-607).

    The constant-velocity warp (odometry.warp_to_start) models the in-sweep
    pose at fraction s as (exp(s log rel.R), s rel.t); this folds in only
    the non-constant part the IMU measures:

        p~ = exp(-s wm) (R0^T R(t_p) p + dev(s)),
        dev(s) = shift(s) - s shift(1)   (start frame)

    with wm the measured sweep rotation.  The correction is the identity at
    s = 0 and s = 1 and under constant motion, so the unchanged
    constant-velocity solver still sees the whole sweep motion (the JAX
    package's docstring has the derivation)."""
    return fc._replace(xyz=_deskew_points(fc.xyz, fc.s, fc.valid, buf, t_scan, cfg))


def deskew_features(feats, buf: ImuBuffer, t_scan, cfg: PipelineConfig):
    """_deskew_cloud on every feature cloud of a scan (the reference warps
    the whole segmented cloud before feature extraction,
    featureAssociation.cpp:560-607; the correction commutes with the
    curvature / pick masks, so it runs on the padded feature sets).  The
    five clouds go through one call: the correction is per point."""
    if buf.count < 2:
        return feats
    clouds = (feats.sharp, feats.less_sharp, feats.flat, feats.less_flat,
              feats.outlier)
    xyz = _deskew_points(torch.cat([c.xyz for c in clouds]),
                         torch.cat([c.s for c in clouds]),
                         torch.cat([c.valid for c in clouds]), buf, t_scan, cfg)
    parts = torch.split(xyz, [c.xyz.shape[0] for c in clouds])
    return feats._replace(**{
        name: c._replace(xyz=p) for name, c, p in zip(
            ("sharp", "less_sharp", "flat", "less_flat", "outlier"), clouds, parts)})


def fold_attitude(ostate, buf: ImuBuffer, t_scan, cfg: PipelineConfig):
    """Blend the AHRS attitude into the accumulated odometry pose (the
    PluginIMURotation analog, featureAssociation.cpp:955-1042 inside
    integrateTransformation :1697-1725): a geodesic pull of weight
    cfg.imu_odom_attitude_blend toward the AHRS attitude expressed in the
    odometry frame.  The anchor, set on the first scan whose buffer is
    usable, is pose.R @ R_end^T at that scan (the rotation from the AHRS
    world frame into the odometry frame), and the blend starts on the scan
    after it; a weight of 0 disables the pull."""
    if buf.count < 2:
        return ostate
    w = cfg.imu_odom_attitude_blend
    R_end = imu_sample(buf, _f32(t_scan, buf.time) + cfg.sensor.scan_period)[0]
    R = ostate.pose.R
    anchor = torch.where(ostate.att_anchor_valid, ostate.att_anchor, R @ R_end.T)
    if w > 0.0:
        att_pred = anchor @ R_end        # measured attitude in odometry frame
        delta = so3_log(R.T @ att_pred)
        R = torch.where(ostate.att_anchor_valid, R @ so3_exp(w * delta), R)
    return ostate._replace(
        pose=Pose(R, ostate.pose.t), att_anchor=anchor,
        att_anchor_valid=torch.ones_like(ostate.att_anchor_valid))


def blend_attitude(T: Pose, buf: ImuBuffer, t, cfg: PipelineConfig) -> Pose:
    """Blend a fraction of the IMU roll / pitch into a mapped pose
    (transformUpdate analog, mapOptmization.cpp:463-496).  The rotation is
    rebuilt from its Euler angles whether or not the buffer is usable, as
    in the JAX package."""
    roll, pitch, yaw = mat_to_euler(T.R)
    if buf.count >= 2:
        w = cfg.imu_attitude_blend
        ir, ip, _ = mat_to_euler(imu_sample(buf, t)[0])
        roll = (1 - w) * roll + w * ir
        pitch = (1 - w) * pitch + w * ip
    return Pose(euler_to_mat(roll, pitch, yaw), T.t)


class HostImuBuffer:
    """Host-side ring buffer with imu_push's integration, in NumPy (the
    reference integrates on the CPU too, featureAssociation.cpp:392-459).

    Samples arrive at 100-200 Hz; the buffer goes to the device once a
    scan through to_device(), cached until the next push."""

    def __init__(self, cfg: PipelineConfig):
        self.cfg = cfg
        self.time = np.full((QUE_LEN,), -np.inf, np.float32)
        self.att = np.tile(np.eye(3, dtype=np.float32), (QUE_LEN, 1, 1))
        self.velo = np.zeros((QUE_LEN, 3), np.float32)
        self.shift = np.zeros((QUE_LEN, 3), np.float32)
        self.ang = np.zeros((QUE_LEN, 3), np.float32)
        self.ptr = QUE_LEN - 1
        self.count = 0
        self._device = None  # (device, ImuBuffer), invalidated on push

    def push(self, t, att_R, acc_body, gyro) -> None:
        att_R = np.asarray(att_R, np.float32)
        acc_w = att_R @ np.asarray(acc_body, np.float32) \
            - np.array([0.0, 0.0, GRAVITY], np.float32)
        prev = self.ptr
        dt = float(t) - float(self.time[prev])
        ok = (0.0 < dt < self.cfg.sensor.scan_period) and self.count > 0
        dtc = dt if ok else 0.0

        slot = (self.ptr + 1) % QUE_LEN
        self.shift[slot] = (self.shift[prev] + self.velo[prev] * dtc
                            + 0.5 * acc_w * dtc * dtc)
        self.velo[slot] = self.velo[prev] + acc_w * dtc
        self.ang[slot] = self.ang[prev] + np.asarray(gyro, np.float32) * dtc
        self.time[slot] = t
        self.att[slot] = att_R
        self.ptr = slot
        self.count = min(self.count + 1, QUE_LEN)
        self._device = None

    def to_device(self, device) -> ImuBuffer:
        """The buffer as tensors on `device`: one host-to-device copy of all
        five arrays, then views.  On the card the copy is staged through a
        fresh pinned tensor and does not block the host; the staging tensor
        is released to PyTorch's pinned-memory cache, which reuses it only
        after the copy has completed.  No host sync."""
        device = torch.device(device)
        if self._device is None or self._device[0] != device:
            flat = np.concatenate([a.reshape(-1) for a in (
                self.time, self.att, self.velo, self.shift, self.ang)])
            staged = torch.from_numpy(flat)      # a copy: never a host array
            if device.type == "cuda":
                staged = staged.pin_memory()
            flat_d = staged.to(device, non_blocking=True)
            Q = QUE_LEN
            time, att, velo, shift, ang = torch.split(flat_d, [Q, 9 * Q, 3 * Q, 3 * Q, 3 * Q])
            self._device = (device, ImuBuffer(
                time=time, att=att.view(Q, 3, 3), velo=velo.view(Q, 3),
                shift=shift.view(Q, 3), ang=ang.view(Q, 3),
                ptr=self.ptr, count=self.count))
        return self._device[1]

    # ---- checkpoint support ----

    def state(self) -> ImuBuffer:
        """The buffer as numpy leaves (ptr / count as 0-d int32, the JAX
        package's checkpoint layout)."""
        return ImuBuffer(self.time, self.att, self.velo, self.shift, self.ang,
                         np.asarray(self.ptr, np.int32),
                         np.asarray(self.count, np.int32))

    def load_state(self, s: ImuBuffer) -> None:
        self.time = np.asarray(s.time, np.float32).copy()
        self.att = np.asarray(s.att, np.float32).copy()
        self.velo = np.asarray(s.velo, np.float32).copy()
        self.shift = np.asarray(s.shift, np.float32).copy()
        self.ang = np.asarray(s.ang, np.float32).copy()
        self.ptr = int(s.ptr)
        self.count = int(s.count)
        self._device = None
