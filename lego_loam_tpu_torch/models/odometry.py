"""Scan-to-scan odometry: Gauss-Newton on feature correspondences
(counterpart of ``lego_loam_tpu.models.odometry``;
featureAssociation.cpp:1044-1725).

Three schedules, as in the JAX package: "block" (the default) and "joint"
take both constraint sets every iteration, 5 association rounds x 5 GN
steps, with "block" zeroing the cross-block Jacobian entries so the
normal equations decouple into (pitch, roll, tz) / (yaw, tx, ty);
"two_step" is the reference's split (featureAssociation.cpp:1270-1478),
a surf phase on (pitch, roll, tz) and then a corner phase on (yaw, tx,
ty), each 5 x 5 GN steps on 3 degrees of freedom.  The surf residual is a
5-point least-squares plane (odom_surf_fit="knn") or the reference's
3-point plane ("tri", featureAssociation.cpp:1163-1249).  The JAX package
takes Jacobians by forward-mode autodiff through the linear motion chart
q(w, v) = q0 + w x q0 + v, (w, v) = chart x; here they are written out:
for a residual with gradient g in the point, the 6-DoF row is (q0 x g, g)
and a phase's chart keeps its columns.  The fori_loops with done masks
are Python loops with torch.where, so the loop needs no host sync; the
3x3 solve is closed-form (ops/lin3.py) and the 3x3 degeneracy projection
is kernel E1 on the card, as the 6x6 one is.  Each association's
correspondence search is one call of ops/assoc.py (kernel K4 on the card,
no (Q, N) distance matrix).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from lego_loam_tpu_torch.config import PipelineConfig
from lego_loam_tpu_torch.ops.assoc import assoc
from lego_loam_tpu_torch.ops.eig6 import degeneracy_projection
from lego_loam_tpu_torch.ops.lin3 import solve3
from lego_loam_tpu_torch.types import FeatureCloud, ScanFeatures, empty_feature_cloud
from lego_loam_tpu_torch.utils.math3d import Pose, project_so3, so3_exp, so3_log

_EPS = 1e-12


class OdometryState(NamedTuple):
    pose: Pose               # world pose of the current sweep end
    rel: Pose                # last relative motion (constant-velocity seed)
    ref_corner: FeatureCloud  # previous less-sharp corners, at sweep end
    ref_surf: FeatureCloud    # previous less-flat surfs, at sweep end
    att_anchor: torch.Tensor      # (3, 3) AHRS anchor (models/imu.fold_attitude)
    att_anchor_valid: torch.Tensor  # bool


def init_state(cfg: PipelineConfig, device) -> OdometryState:
    return OdometryState(
        pose=Pose.identity(device=device),
        rel=Pose.identity(device=device),
        ref_corner=empty_feature_cloud(cfg.max_less_sharp, device),
        ref_surf=empty_feature_cloud(cfg.max_less_flat, device),
        att_anchor=torch.eye(3, dtype=torch.float32, device=device),
        att_anchor_valid=torch.zeros((), dtype=torch.bool, device=device),
    )


def select_pose(cond: torch.Tensor, a: Pose, b: Pose) -> Pose:
    """Elementwise where over a Pose (cond is a 0-d bool tensor)."""
    return Pose(torch.where(cond, a.R, b.R), torch.where(cond, a.t, b.t))


# ---------------------------------------------------------------- warps

def warp_to_start(rel: Pose, pts: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """De-skew: point captured at sweep fraction s -> sweep-start frame
    (sensor pose at s = geodesic interp identity -> rel)."""
    w = so3_log(rel.R)
    Rs = so3_exp(s[:, None] * w)
    return (Rs @ pts[:, :, None])[:, :, 0] + s[:, None] * rel.t


def warp_to_end(rel: Pose, pts: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Project points to the sweep-end frame (featureAssociation.cpp:885-953)."""
    inv = rel.inverse()
    return warp_to_start(rel, pts, s) @ inv.R.T + inv.t


# ---------------------------------------------------------- associations

def _class_gate(q: FeatureCloud, ref: FeatureCloud, cfg):
    """The ground labels of the class gate, (query, ref), or (None, None)."""
    if cfg.odom_class_gate and q.ground is not None and ref.ground is not None:
        return q.ground, ref.ground
    return None, None


def _assoc_corner(rel: Pose, sharp: FeatureCloud, ref: FeatureCloud, cfg):
    """j1 = nearest ref corner; j2 = nearest in a different ring within +-2
    (featureAssociation.cpp:1052-1104): slots 0 and 3 of ops/assoc."""
    q = warp_to_start(rel, sharp.xyz, sharp.s)
    idx, d2 = assoc(q, ref.xyz, ref.valid, ref.ring, "corner")
    thr = cfg.nearest_feature_search_sq_dist
    return idx[:, 0], idx[:, 3], sharp.valid & (d2[:, 0] < thr) & (d2[:, 3] < thr)


def _assoc_surf(rel: Pose, flat: FeatureCloud, ref: FeatureCloud, cfg):
    """3-point plane association (odom_surf_fit="tri"): j1 = nearest; j2 =
    nearest in the same ring, j1 excluded; j3 = nearest in a ring within
    +-2 (featureAssociation.cpp:1163-1226): slots 0, 1 and 3 of ops/assoc.
    With cfg.odom_class_gate every candidate, j1 too, must share the
    query's ground label."""
    q = warp_to_start(rel, flat.xyz, flat.s)
    idx, d2 = assoc(q, ref.xyz, ref.valid, ref.ring, "tri",
                    *_class_gate(flat, ref, cfg))
    thr = cfg.nearest_feature_search_sq_dist
    ok = flat.valid & (d2[:, 0] < thr) & (d2[:, 1] < thr) & (d2[:, 3] < thr)
    return idx[:, 0], idx[:, 1], idx[:, 3], ok


def _assoc_surf_knn(rel: Pose, flat: FeatureCloud, ref: FeatureCloud, cfg):
    """5-point least-squares plane association (odom_surf_fit="knn"):
    nearest + two same-ring + two adjacent-ring reference points (the five
    slots of ops/assoc), fitted with the scan-to-map plane gates
    (models/mapping._fit_planes)."""
    from lego_loam_tpu_torch.models.mapping import _fit_planes

    q = warp_to_start(rel, flat.xyz, flat.s)
    idx, d2 = assoc(q, ref.xyz, ref.valid, ref.ring, "knn",
                    *_class_gate(flat, ref, cfg))
    thr = cfg.nearest_feature_search_sq_dist
    # the core triple must exist; the extras fall back to duplicating their
    # category's first pick so the fit always sees 5 finite rows
    ok = flat.valid & (d2[:, 0] < thr) & (d2[:, 1] < thr) & (d2[:, 3] < thr)
    i4 = torch.where(d2[:, 4] < thr, idx[:, 4], idx[:, 3])
    i5 = torch.where(d2[:, 2] < thr, idx[:, 2], idx[:, 1])
    nn = ref.xyz[torch.stack([idx[:, 0], idx[:, 1], idx[:, 3], i4, i5], dim=1)]
    return _fit_planes(nn, ok, cfg)


# ------------------------------------------------------------- residuals

def _safe_norm(v, dim=-1, keepdim=False):
    """Norm with a smooth, finite gradient at 0."""
    return torch.sqrt(torch.sum(v * v, dim=dim, keepdim=keepdim) + _EPS)


def _corner_distance(q, a, b):
    """Signed point-to-line residual with the perpendicular direction n
    frozen (featureAssociation.cpp:1121-1135).  Returns (d, grad_q) with
    grad_q = n - (n.u) u, the derivative of d in q with n held fixed."""
    u = (a - b) / _safe_norm(a - b, keepdim=True)
    e = q - a
    perp = e - torch.sum(e * u, -1, keepdim=True) * u
    n = perp / _safe_norm(perp, keepdim=True)
    g = n - torch.sum(n * u, -1, keepdim=True) * u
    return torch.sum(n * perp, -1), g


def _surf_distance(q, a, b, c):
    """Signed point-to-plane residual of the plane through a, b, c
    (featureAssociation.cpp:1234-1249).  Returns (d, grad_q): the unit
    normal, with a, b and c held fixed."""
    n = torch.linalg.cross(b - a, c - a, dim=-1)
    n = n / _safe_norm(n, keepdim=True)
    return torch.sum(n * (q - a), dim=-1), n


def _chart_rows(q0: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Jacobian rows in (w, v) of a residual with point gradient g through
    q = q0 + w x q0 + v: d/dw = q0 x g, d/dv = g."""
    return torch.cat([torch.linalg.cross(q0, g, dim=-1), g], dim=-1)


# ----------------------------------------------------------------- solver

def _residual_scale(absd, ok, cfg):
    """Robust residual scale for the Huber width ("mean": masked mean x
    0.845, the half-normal median/mean ratio; "median": masked median)."""
    if cfg.odom_scale_est == "mean":
        n_ok = torch.clamp(ok.sum(), min=1)
        return 0.845 * torch.where(ok, absd, 0.0).sum() / n_ok
    n_ok = ok.sum()
    sorted_d = torch.sort(torch.where(ok, absd, float("inf"))).values
    med = sorted_d[torch.div(torch.clamp(n_ok - 1, min=0), 2, rounding_mode="floor")]
    return torch.where(torch.isfinite(med), med, 0.0)


def solve6(H: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """(H + 1e-6 I) x = g without the host sync of an error check; a
    singular system gives a zero step."""
    A = H + 1e-6 * torch.eye(H.shape[0], dtype=H.dtype, device=H.device)
    x = torch.linalg.solve_ex(A, g[:, None])[0][:, 0]
    return torch.where(torch.isfinite(x), x, 0.0)


# a phase's chart: the se(3) directions (w, v) it solves, as columns of
# the 6-DoF Jacobian.  The surf phase solves (pitch wy, roll wx, vz), the
# corner phase (yaw wz, vx, vy); None is all six in order
_SURF_CHART = (1, 0, 5)
_CORNER_CHART = (2, 3, 4)


def _chart_matrix(cols, device) -> torch.Tensor:
    """(6, dof) 0/1 matrix of a chart (built on the device: a tensor
    literal would be a host copy)."""
    eye = torch.eye(6, dtype=torch.float32, device=device)
    return torch.stack([eye[:, c] for c in cols], dim=1)


def _degeneracy_projection(H, thresh):
    """P = V diag(lam >= thresh) V^T: zero the eigen-directions whose
    eigenvalue is below thresh (featureAssociation.cpp:1329-1356), for a
    6x6 or a 3x3 H.  Kernel E1 on the card (ops/eig6.py): no host sync."""
    return degeneracy_projection(H, thresh)[0]


def _gn_iteration(rel, pts, s, resid_at, cfg, med, compute_scale: bool,
                  jac_mask=None, chart=None):
    """One GN step: residuals at the de-skewed points q0, Jacobian through
    the linear chart.  resid_at(q0) -> (d, qn, ok, grad_q).  `chart` is a
    phase's (cols, (6, dof) matrix), None for all six directions.  Returns
    (x (dof,), the unweighted H (dof, dof), constraints kept, scale)."""
    q0 = warp_to_start(rel, pts, s)
    d0, qn, ok, grad = resid_at(q0)
    J = _chart_rows(q0, grad)
    if chart is not None:
        J = torch.stack([J[:, c] for c in chart[0]], dim=1)
    if jac_mask is not None:
        J = J * jac_mask
    absd = d0.abs()
    if compute_scale:
        med = _residual_scale(absd, ok, cfg)
    delta = torch.maximum(cfg.odom_robust_delta * qn, 0.7 * med)
    w = torch.clamp(delta / torch.clamp(absd, min=1e-9), max=1.0)
    keep = ok & (w > 0.1) & torch.isfinite(d0)
    wk = torch.where(keep, w, 0.0)
    A = J * wk[:, None]
    b = -cfg.odom_step_scale * wk * d0
    # degeneracy analysis uses the UNWEIGHTED system (reference eigen
    # thresholds are calibrated against unit-weight rows)
    Au = J * keep[:, None].to(J.dtype)
    if chart is None:
        x = solve6(A.T @ A, A.T @ b)
        xi = x
    else:
        # closed-form 3x3 solve, as the JAX package takes it at 3 DoF
        H = A.T @ A + 1e-6 * torch.eye(3, dtype=A.dtype, device=A.device)
        x = solve3(H, A.T @ b)
        x = torch.where(torch.isfinite(x), x, 0.0)
        xi = chart[1] @ x
    rot_n = _safe_norm(xi[:3])
    trans_n = _safe_norm(xi[3:])
    scale = torch.clamp(torch.minimum(math.radians(cfg.odom_max_step_rot_deg) / rot_n,
                                      cfg.odom_max_step_trans / trans_n), max=1.0)
    return x * scale, Au.T @ Au, keep.sum(), med


def _phase(rel0, pts, s, make_assoc, make_resid, cfg, jac_mask=None, cols=None):
    """Association rounds x GN steps with convergence freezing
    (featureAssociation.cpp:1666-1695), on all six directions or on a
    chart's `cols`."""
    dev = pts.device
    chart = None if cols is None else (cols, _chart_matrix(cols, dev))
    refresh_each_iter = cfg.odom_scale_refresh == "iter"
    rel = rel0
    P = torch.eye(6 if cols is None else len(cols), dtype=torch.float32, device=dev)
    med = torch.zeros((), dtype=torch.float32, device=dev)
    for _ in range(cfg.odom_outer_iters):
        resid_at = make_resid(make_assoc(rel))
        # a fresh association restarts convergence
        done = torch.zeros((), dtype=torch.bool, device=dev)
        for i in range(cfg.odom_inner_iters):
            round_start = i == 0
            x, H, n_keep, med = _gn_iteration(
                rel, pts, s, resid_at, cfg, med,
                compute_scale=round_start or refresh_each_iter,
                jac_mask=jac_mask, chart=chart)
            if round_start:
                # projection refreshed once per association round
                P = _degeneracy_projection(H, cfg.odom_degen_eig_thresh)
            x = P @ x
            xi = x if chart is None else chart[1] @ x
            apply = ~done & (n_keep >= cfg.odom_min_constraints)
            rel = select_pose(apply, Pose(so3_exp(xi[:3]) @ rel.R, rel.t + xi[3:]), rel)
            d_rot = torch.rad2deg(torch.linalg.vector_norm(xi[:3]))
            d_trans = 100.0 * torch.linalg.vector_norm(xi[3:])
            done = done | (apply & (d_rot < cfg.odom_delta_rot_deg)
                           & (d_trans < cfg.odom_delta_trans_cm))
    return rel


def odometry_step(state: OdometryState, feats: ScanFeatures, cfg: PipelineConfig):
    """Process one scan's features; returns (new_state, world_pose, rel).

    On the first scan (empty references) the solve is a no-op and the pose
    stays at the seed (checkSystemInitialization,
    featureAssociation.cpp:1605-1637)."""
    sharp, flat = feats.sharp, feats.flat
    if not cfg.deskew:
        # motion-compensated input: s = 1 everywhere makes the warps the
        # plain frame-to-frame transform
        sharp = sharp._replace(s=torch.ones_like(sharp.s))
        flat = flat._replace(s=torch.ones_like(flat.s))
        feats = feats._replace(
            less_sharp=feats.less_sharp._replace(s=torch.ones_like(feats.less_sharp.s)),
            less_flat=feats.less_flat._replace(s=torch.ones_like(feats.less_flat.s)))
    ref_c, ref_s = state.ref_corner, state.ref_surf
    n_ref_c = ref_c.valid.sum()
    n_ref_s = ref_s.valid.sum()
    gate = (n_ref_c >= cfg.odom_min_last_corner) & (n_ref_s >= cfg.odom_min_last_surf)
    knn_surf = cfg.odom_surf_fit == "knn"

    def surf_assoc(rel):
        return (_assoc_surf_knn(rel, flat, ref_s, cfg) if knn_surf
                else _assoc_surf(rel, flat, ref_s, cfg))

    def surf_rows(a):
        """q -> (d, grad_q, ok) of the surf constraints of association a."""
        if knn_surf:
            pn, pd, oks = a
            return lambda q: (torch.sum(pn * q, dim=-1) + pd, pn, oks)
        i1, i2, i3, oks = a
        pa, pb, pc = ref_s.xyz[i1], ref_s.xyz[i2], ref_s.xyz[i3]
        return lambda q: (*_surf_distance(q, pa, pb, pc), oks)

    def corner_rows(a):
        j1, j2, okc = a
        ca, cb = ref_c.xyz[j1], ref_c.xyz[j2]
        return lambda q: (*_corner_distance(q, ca, cb), okc)

    def surf_qn(q):
        return torch.sqrt(torch.sqrt(_safe_norm(q)))

    if cfg.odom_mode in ("joint", "block"):
        F = flat.xyz.shape[0]
        pts = torch.cat([flat.xyz, sharp.xyz], dim=0)
        ss = torch.cat([flat.s, sharp.s], dim=0)

        def assoc(rel):
            return surf_assoc(rel), _assoc_corner(rel, sharp, ref_c, cfg)

        def make_resid(a):
            surf, corner = surf_rows(a[0]), corner_rows(a[1])

            def resid_at(q):
                qs, qc = q[:F], q[F:]
                ds, gs, oks = surf(qs)
                dc, gc, okc = corner(qc)
                qn = torch.cat([surf_qn(qs), torch.ones_like(dc)])
                return (torch.cat([ds, dc]), qn, torch.cat([oks, okc]),
                        torch.cat([gs, gc]))
            return resid_at

        jac_mask = None
        if cfg.odom_mode == "block":
            # surf rows drive (pitch wy, roll wx, vz); corner rows (yaw wz,
            # vx, vy) (built on the device: a torch.tensor literal would be
            # a host copy)
            col = torch.arange(6, device=pts.device)
            surf_cols = ((col < 2) | (col == 5)).to(torch.float32)
            row_is_surf = (torch.arange(pts.shape[0], device=pts.device) < F).to(torch.float32)
            jac_mask = (row_is_surf[:, None] * surf_cols[None, :]
                        + (1.0 - row_is_surf)[:, None] * (1.0 - surf_cols)[None, :])
        rel = _phase(state.rel, pts, ss, assoc, make_resid, cfg, jac_mask=jac_mask)
    else:
        # two_step: the surf phase on (pitch, roll, tz), then the corner
        # phase on (yaw, tx, ty) from its result
        def surf_resid(a):
            surf = surf_rows(a)

            def resid_at(q):
                d, g, ok = surf(q)
                return d, surf_qn(q), ok, g
            return resid_at

        def corner_resid(a):
            corner = corner_rows(a)

            def resid_at(q):
                d, g, ok = corner(q)
                # corner weights are not range-normalised
                return d, torch.ones_like(d), ok, g
            return resid_at

        rel = _phase(state.rel, flat.xyz, flat.s, surf_assoc, surf_resid, cfg,
                     cols=_SURF_CHART)
        rel = _phase(rel, sharp.xyz, sharp.s,
                     lambda rel: _assoc_corner(rel, sharp, ref_c, cfg),
                     corner_resid, cfg, cols=_CORNER_CHART)
    rel = select_pose(gate, rel, state.rel)

    # first scan: the map frame IS this scan's frame
    initialized = (n_ref_c + n_ref_s) > 0
    acc = state.pose.compose(rel)
    acc = Pose(project_so3(acc.R), acc.t)
    pose = select_pose(initialized, acc, state.pose)

    # next references at this sweep's end frame (featureAssociation.cpp:1759-1788)
    new_ref_c = feats.less_sharp._replace(
        xyz=warp_to_end(rel, feats.less_sharp.xyz, feats.less_sharp.s))
    new_ref_s = feats.less_flat._replace(
        xyz=warp_to_end(rel, feats.less_flat.xyz, feats.less_flat.s))
    new_state = state._replace(pose=pose, rel=rel, ref_corner=new_ref_c,
                               ref_surf=new_ref_s)
    return new_state, pose, rel
