"""The plain reference that `correct` is judged by: NumPy and SciPy on the
host, from the benchmark's own inputs and ground truth, importing nothing
of the program.

* The front end of a scan, as LeGO-LOAM's imageProjection.cpp defines it
  (and the program's configuration states): the range image's occupied
  pixels (nearest return wins a pixel), the ground pixels (rows below
  ground_scan_ind whose step to the row above is within 10 degrees of
  level), the clusters of the remaining pixels (4-neighbour, columns
  wrapping, joined where the beta angle exceeds segment_theta; a cluster
  is kept with 30 pixels, or with 5 spanning 3 rows), and the segmented
  cloud: kept clusters plus the ground at every 5th column and the first
  and last columns.  It gives the three counts the program reports a scan
  (n_valid_px, n_ground, n_segmented).
* The trajectory: the courses' true poses, against which the program's
  relative motion over a few steps is compared (odometry and mapping).
* The cadences: which steps solve the map and how many keyframes a
  sequence holds (one a solve that moved keyframe_min_translation from the
  last).

The front end's functions take `q`, the rounding of every value they
compute: exact (float32, TF32 off, as the configurations state) by
default, `bf16` for the control that puts the reference, computed in
bfloat16, in the program's place.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from scipy.sparse import coo_matrix
from scipy.sparse.csgraph import connected_components


def exact(x):
    return x


def bf16(x):
    """x rounded to bfloat16 (to nearest, ties to even), as float32."""
    t = torch.from_numpy(np.ascontiguousarray(x, np.float32))
    return t.to(torch.bfloat16).float().numpy()


def project(xyz, valid, ring, s: dict, q=exact):
    """(rng (R, H) float32, inf where empty; xyz grid (R, H, 3)) of one
    scan: row from the ring, or from the elevation where the sensor has no
    ring channel; column from the azimuth; the nearest return wins."""
    R, H = s["n_scan"], s["horizon_scan"]
    x, y, z = (q(xyz[:, i].astype(np.float32)) for i in range(3))
    xy2 = q(q(x * x) + q(y * y))
    rng = q(np.sqrt(q(xy2 + q(z * z))))
    if s["use_ring"]:
        row = ring.astype(np.int64)
    else:
        vert = q(np.degrees(q(np.arctan2(z, q(np.sqrt(xy2))))))
        row = np.floor(q(q(vert + np.float32(s["ang_bottom"]))
                         / q(np.float32(s["ang_res_y"])))).astype(np.int64)
    hor = q(np.degrees(q(np.arctan2(x, y))))
    col = (-np.round(q(q(hor - np.float32(90.0)) / q(np.float32(s["ang_res_x"]))))
           ).astype(np.int64) + H // 2
    col = np.where(col >= H, col - H, col)
    ok = (valid & (row >= 0) & (row < R) & (col >= 0) & (col < H)
          & (rng >= s["min_range"]) & (rng <= s["max_range"]))
    cell = row[ok] * H + col[ok]
    r, p = rng[ok], np.stack([x, y, z], 1)[ok]
    order = np.lexsort((r, cell))           # by cell, then nearest first
    cell, r, p = cell[order], r[order], p[order]
    first = np.ones(len(cell), bool)
    first[1:] = cell[1:] != cell[:-1]
    grid_r = np.full(R * H, np.inf, np.float32)
    grid_p = np.zeros((R * H, 3), np.float32)
    grid_r[cell[first]] = r[first]
    grid_p[cell[first]] = p[first]
    return grid_r.reshape(R, H), grid_p.reshape(R, H, 3)


def ground_mask(rng, pts, s: dict, cfg: dict, q=exact):
    g = s["ground_scan_ind"]
    ok = np.isfinite(rng)
    d = q(pts[1:g + 1] - pts[:g])
    flat_d = q(np.sqrt(q(q(d[..., 0] ** 2) + q(d[..., 1] ** 2))))
    ang = q(np.degrees(q(np.arctan2(d[..., 2], flat_d))))
    flat = (np.abs(q(ang - np.float32(s["mount_angle"])))
            <= np.float32(cfg["ground_angle_thresh_deg"])) & ok[:g] & ok[1:g + 1]
    ground = np.zeros_like(ok)
    ground[:g] |= flat
    ground[1:g + 1] |= flat
    return ground & ok


def _joined(r1, r2, alpha_deg: float, theta_deg: float, q=exact):
    """LeGO-LOAM's beta-angle test between neighbouring ranges."""
    a = np.float32(math.radians(alpha_deg))
    d1, d2 = np.maximum(r1, r2), np.minimum(r1, r2)
    return (q(np.arctan2(q(d2 * q(np.sin(a))), q(d1 - q(d2 * q(np.cos(a))))))
            > q(np.float32(math.radians(theta_deg))))


def frontend_counts(xyz, valid, ring, s: dict, cfg: dict, q=exact):
    """(n_valid_px, n_ground, n_segmented) of one scan."""
    R, H = s["n_scan"], s["horizon_scan"]
    rng, pts = project(xyz, valid, ring, s, q)
    ok = np.isfinite(rng)
    ground = ground_mask(rng, pts, s, cfg, q)
    seg = ok & ~ground
    r = np.where(ok, rng, np.float32(1.0))
    theta = cfg["segment_theta_deg"]
    right = np.roll(r, -1, 1)
    eh = seg & np.roll(seg, -1, 1) & _joined(r, right, s["ang_res_x"], theta, q)
    ev = seg[:-1] & seg[1:] & _joined(r[:-1], r[1:], s["ang_res_y"], theta, q)
    lin = np.arange(R * H).reshape(R, H)
    src = np.concatenate([lin[eh], lin[:-1][ev]])
    dst = np.concatenate([np.roll(lin, -1, 1)[eh], lin[1:][ev]])
    graph = coo_matrix((np.ones(len(src), np.int8), (src, dst)),
                       shape=(R * H, R * H))
    _, comp = connected_components(graph, directed=False)
    comp = comp.reshape(R, H)
    members = comp[seg]
    size = np.bincount(members, minlength=R * H)
    rows = np.broadcast_to(np.arange(R)[:, None], (R, H))[seg]
    lo = np.full(R * H, R)
    hi = np.full(R * H, -1)
    np.minimum.at(lo, members, rows)
    np.maximum.at(hi, members, rows)
    span = hi - lo + 1
    good_c = ((size >= cfg["segment_big_cluster"])
              | ((size >= cfg["segment_valid_point_num"])
                 & (span >= cfg["segment_valid_line_num"])))
    good = seg & good_c[comp]
    cols = np.broadcast_to(np.arange(H)[None, :], (R, H))
    sampled = ground & ((cols % 5 == 0) | (cols <= 5) | (cols >= H - 5))
    return int(ok.sum()), int(ground.sum()), int((good | sampled).sum())


def relative(Ra, ta, Rb, tb):
    """Pose b in the frame of pose a, batched."""
    Rt = np.swapaxes(Ra, -1, -2)
    return Rt @ Rb, np.einsum("...ij,...j->...i", Rt, tb - ta)


def motion_gaps(est_R, est_t, true_R, true_t):
    """(translation m, rotation deg) gap of each estimated relative motion
    from the true one."""
    dR = np.swapaxes(true_R, -1, -2) @ est_R
    cos = np.clip((np.trace(dR, axis1=-2, axis2=-1) - 1.0) / 2.0, -1.0, 1.0)
    return (np.linalg.norm(est_t - true_t, axis=-1), np.degrees(np.arccos(cos)))


def keyframes(true_t: np.ndarray, min_move: float) -> int:
    """Keyframes of one sequence whose solves sit at true positions true_t
    (n, 3), in order: the first solve and each one that moved min_move from
    the last keyframe."""
    n, last = 0, None
    for p in true_t:
        if last is None or np.linalg.norm(p - last) >= min_move:
            n, last = n + 1, p
    return n

