"""Configuration for the PyTorch/CUDA LeGO-LOAM engine.

Field-for-field mirror of ``lego_loam_tpu.config`` (same names, defaults and
sensor presets; ``tests/test_torch_import.py`` asserts it), kept as its own
copy so the port never imports the JAX package.  Knobs that choose between
TPU backends (``segmentation_backend``, ``segstats_backend``,
``max_clusters``, ``feature_backend``, ``nn_backend``, ``nn_query_tile``'s
tiling note, ``nn_exact``) are kept for the mirror; the port picks its
kernels by tensor device instead (see ``lego_loam_tpu_torch/kernels``).

Original notes:

The reference keeps all knobs as compile-time ``extern const`` globals
(reference: LeGO-LOAM/include/utility.h:53-136) and requires recompilation to
change sensors.  Here everything is a frozen dataclass: hashable (so it can be
a static jit argument), runtime-switchable, with the same parameter names and
semantics where they carry over.

Sensor presets mirror the commented blocks in utility.h:62-102 (VLP-16,
HDL-32E, VLS-128, OS1-16, OS1-64) plus an HDL-64E preset for KITTI that the
reference README leaves "to the user" (reference: README.md:86).
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass


@dataclass(frozen=True)
class SensorSpec:
    """Lidar geometry (reference: utility.h:62-102)."""

    name: str
    n_scan: int                 # number of rings (rows of the range image)
    horizon_scan: int           # azimuth bins (columns of the range image);
                                # kernel K2 takes at most 3082 on the card
                                # (ops/features.check_k2_fits; presets <= 1800)
    ang_res_x: float            # azimuth resolution, degrees
    ang_res_y: float            # elevation resolution, degrees
    ang_bottom: float           # |elevation| of the lowest ring, degrees
    ground_scan_ind: int        # rows 0..ground_scan_ind-1 may contain ground
    use_ring: bool = True       # row from the ring channel vs elevation math
    scan_period: float = 0.1    # seconds per sweep (utility.h:107)
    min_range: float = 1.0      # sensorMinimumRange (utility.h:111)
    max_range: float = 120.0    # drop returns beyond this (numerical hygiene)
    mount_angle: float = 0.0    # sensorMountAngle, degrees (utility.h:112)


VLP16 = SensorSpec(
    name="vlp16", n_scan=16, horizon_scan=1800,
    ang_res_x=0.2, ang_res_y=2.0, ang_bottom=15.1, ground_scan_ind=7,
)

HDL32E = SensorSpec(
    name="hdl32e", n_scan=32, horizon_scan=1800,
    ang_res_x=360.0 / 1800, ang_res_y=41.33 / 31, ang_bottom=30.67,
    ground_scan_ind=20,
)

VLS128 = SensorSpec(
    name="vls128", n_scan=128, horizon_scan=1800,
    ang_res_x=0.2, ang_res_y=0.3, ang_bottom=25.0, ground_scan_ind=10,
)

OS1_16 = SensorSpec(
    name="os1_16", n_scan=16, horizon_scan=1024,
    ang_res_x=360.0 / 1024, ang_res_y=33.2 / 15, ang_bottom=16.7,
    ground_scan_ind=7,
)

OS1_64 = SensorSpec(
    name="os1_64", n_scan=64, horizon_scan=1024,
    ang_res_x=360.0 / 1024, ang_res_y=33.2 / 63, ang_bottom=16.7,
    ground_scan_ind=15,
)

# KITTI's HDL-64E: 64 beams, +2 .. -24.8 deg vertical FOV, 10 Hz.  The raw
# .bin scans carry no ring channel, so rows come from elevation math.
HDL64E = SensorSpec(
    name="hdl64e", n_scan=64, horizon_scan=1800,
    ang_res_x=0.2, ang_res_y=26.8 / 63, ang_bottom=24.9, ground_scan_ind=50,
    use_ring=False,
)

SENSOR_PRESETS = {
    s.name: s for s in (VLP16, HDL32E, VLS128, OS1_16, OS1_64, HDL64E)
}


@dataclass(frozen=True)
class PipelineConfig:
    """Algorithm knobs + fixed array capacities for the jitted programs.

    Knob defaults match the reference (utility.h:104-136); capacities are new
    (the TPU build uses fixed-shape padded arrays instead of std::vector).
    """

    sensor: SensorSpec = VLP16

    # --- segmentation (utility.h:113-117, imageProjection.cpp:370-460) ---
    segment_theta_deg: float = 60.0          # edge predicate threshold
    segment_valid_point_num: int = 5
    segment_valid_line_num: int = 3
    segment_big_cluster: int = 30            # >=30 px is always a valid cluster
    ground_angle_thresh_deg: float = 10.0    # imageProjection.cpp:286
    label_prop_max_sweeps: int = 64          # CCL sweep budget (new; see ops/segmentation.py)
    segmentation_backend: str = "auto"       # "auto" = Pallas kernel on TPU,
                                             # XLA scans elsewhere; or force
                                             # "pallas" / "xla"
    segstats_backend: str = "auto"           # cluster size/span reduction:
                                             # "auto" = one-hot MXU matmuls
                                             # on TPU (no random scatters),
                                             # scatter reductions elsewhere;
                                             # or force "matmul" / "scatter"
    max_clusters: int = 1024                 # compact cluster-id capacity of
                                             # the matmul path; components
                                             # beyond it become outliers

    # --- features (utility.h:120-125, featureAssociation.cpp:621-784) ---
    edge_threshold: float = 0.1
    edge_prominence: float = 50.0            # corner curvature must also
                                             # clear this multiple of the
                                             # per-ring median curvature (the
                                             # range-noise floor): keeps
                                             # sensor noise on smooth
                                             # surfaces from saturating the
                                             # per-sector corner quota.  The
                                             # multiple must clear the MAX of
                                             # ~300 chi-square(1) draws per
                                             # sector (the picks are argmax):
                                             # 50 x median puts that tail at
                                             # ~6e-4 expected survivors while
                                             # real edges sit 500-10000x the
                                             # floor (new vs reference — see
                                             # ops/features.label_features;
                                             # 0 = reference-faithful
                                             # absolute threshold only)
    surf_threshold: float = 0.1
    sections_total: int = 6                  # kernel K2 takes 1..8 on the
                                             # card: LegoLoamPipeline(cfg,
                                             # "cuda") refuses more
                                             # (ops/features.check_k2_fits)
    edge_feature_num: int = 2                # sharp corners per sector
    edge_feature_num_less: int = 20          # less-sharp corners per sector
    surf_feature_num: int = 4                # flat surf points per sector
    occlusion_depth_gap: float = 0.3         # featureAssociation.cpp:655
    occlusion_col_diff: int = 10
    parallel_beam_frac: float = 0.02         # featureAssociation.cpp:675
    nearest_feature_search_sq_dist: float = 25.0

    # --- odometry (featureAssociation.cpp:1666-1695) ---
    deskew: bool = True                      # de-skew by sweep time; turn off
                                             # for motion-compensated data
                                             # (e.g. KITTI bins)
    odom_mode: str = "block"                 # "block": both constraint sets
                                             # every iteration with the
                                             # normal equations decoupled
                                             # into the two-step's (pitch,
                                             # roll, tz) / (yaw, tx, ty)
                                             # blocks — the two-step's
                                             # conditioning at HALF its
                                             # sequential GN depth (25 fused
                                             # iterations vs 25 + 25);
                                             # "two_step": surf then corner
                                             # sequentially, the reference's
                                             # split (featureAssociation.cpp:
                                             # 1270-1478); "joint": fully
                                             # coupled 6-DoF (the reference's
                                             # unused calculateTransformation
                                             # path, featureAssociation.cpp:
                                             # 1480-1603; drifts on low-
                                             # excitation paths).  The port
                                             # runs all three (two_step's
                                             # 3x3 degeneracy projection is
                                             # kernel E1 on the card)
    odom_outer_iters: int = 5                # correspondence refresh rounds
    odom_inner_iters: int = 5                # GN steps per refresh (5*5 = 25)
    odom_step_scale: float = 1.0             # 1.0 = full GN steps; the
                                             # reference damps with 0.05
                                             # (featureAssociation.cpp:1321),
                                             # which under-corrects ~28% of
                                             # the seed error per scan
    odom_robust_delta: float = 0.03          # Huber width (m): w=min(1,delta/|d|).
                                             # Replaces the reference's linear
                                             # reject 1-1.8|d| (featureAssociation
                                             # .cpp:1139), which discards any
                                             # residual > 0.5 m and stalls on
                                             # poor seeds; Huber bounds outlier
                                             # influence without rejecting
                                             # signal.  Width: the adaptive
                                             # floor (0.7x robust scale) rules
                                             # the early rounds, so delta only
                                             # binds near convergence where it
                                             # suppresses the nearest-neighbor
                                             # discretization bias; 0.03 cuts
                                             # open-loop drift 5x vs the former
                                             # 0.15 on synthetic courtyards at
                                             # equal cost (15-scan end error
                                             # 0.034 m vs 0.172 m)
    odom_scale_est: str = "mean"             # robust residual scale for the
                                             # Huber width: "mean" (one
                                             # reduction, no sort kernels on
                                             # TPU; 0.845x half-normal factor)
                                             # or "median" (masked sort)
    odom_scale_refresh: str = "round"        # recompute the scale "round"
                                             # (once per association round —
                                             # the scale only moves when the
                                             # correspondences do) or "iter"
                                             # (every GN step)
    odom_max_step_rot_deg: float = 10.0      # trust-region clip per GN step
    odom_max_step_trans: float = 1.0
    odom_degen_eig_thresh: float = 10.0      # featureAssociation.cpp:1338
    odom_surf_fit: str = "knn"               # odometry surf residual: "knn"
                                             # = 5-NN least-squares plane w/
                                             # the scan-to-map quality gates
                                             # (immune to the 3-point plane's
                                             # short-baseline tilt from
                                             # ground-label noise — see
                                             # models/odometry._assoc_surf_knn);
                                             # "tri" = reference-faithful
                                             # 3-point plane
                                             # (featureAssociation.cpp:
                                             # 1163-1226); the port runs
                                             # both, in every odom_mode
    odom_class_gate: bool = True             # surf association may only pair
                                             # points with the SAME ground
                                             # label (new vs reference: its
                                             # featureAssociation discards
                                             # the label and mixed
                                             # ground/wall-base 3-point
                                             # planes give a systematic +z
                                             # odometry bias in corridors —
                                             # see models/odometry._assoc_surf
                                             # and examples/diag_corridor2.py;
                                             # False = reference-faithful)
    odom_delta_rot_deg: float = 0.1          # convergence thresholds
    odom_delta_trans_cm: float = 0.1
    odom_min_constraints: int = 10
    odom_min_last_corner: int = 10
    odom_min_last_surf: int = 100

    # --- mapping (utility.h:128-136, mapOptmization.cpp:1229-1350) ---
    map_iters: int = 10
    map_assoc_iters: int = 3                 # re-associate 5-NN for the first
                                             # N GN iterations, then freeze
                                             # correspondences so the solve
                                             # converges quadratically and the
                                             # early exit actually fires (the
                                             # reference re-searches every
                                             # iteration and always runs all
                                             # 10, mapOptmization.cpp:1336)
    map_degen_eig_thresh: float = 100.0
    map_delta_rot_deg: float = 0.05
    map_delta_trans_cm: float = 0.05
    map_min_constraints: int = 50
    map_nn_radius_sq: float = 1.0            # 5th-NN gate (mapOptmization.cpp:1101)
    map_line_eig_ratio: float = 3.0          # line-ness test
    map_plane_max_resid: float = 0.2
    map_plane_min_spread: float = 0.1        # reject collinear 5-NN "planes":
                                             # require sqrt(mid eigenvalue) of
                                             # the neighbor covariance above
                                             # this (single-ring arcs at far
                                             # range fit arbitrary tilted
                                             # planes that pass the residual
                                             # check and corrupt the solve)
    mapping_process_every: int = 3           # solve every k-th scan (0.3 s at 10 Hz)
    map_refresh_every: int = 4               # re-assemble the cached local
                                             # map every N solves (forced
                                             # immediately after loop
                                             # closures / pool compaction);
                                             # between refreshes the solve
                                             # registers against the cached
                                             # map — the reference's
                                             # incremental cache
                                             # (mapOptmization.cpp:1001-1056)
                                             # with a deterministic policy.
                                             # 1 = re-gather every solve
    keyframe_min_translation: float = 0.3    # mapOptmization.cpp:1360-1363
    surrounding_keyframe_search_radius: float = 50.0
    surrounding_keyframe_search_num: int = 50
    imu_attitude_blend: float = 0.002        # mapOptmization.cpp:488-489
    imu_odom_attitude_blend: float = 0.05    # AHRS attitude pull folded into
                                             # the accumulated odometry pose
                                             # each scan (PluginIMURotation
                                             # analog, featureAssociation.cpp:
                                             # 955-1042, 1697-1725; the
                                             # reference substitutes the
                                             # measured increment outright =
                                             # weight 1.0).  0 disables

    # --- loop closure (utility.h:132-134, mapOptmization.cpp:814-945) ---
    loop_closure_enabled: bool = False
    history_keyframe_search_radius: float = 7.0
    history_keyframe_search_num: int = 25
    history_keyframe_fitness_score: float = 0.3
    loop_min_time_gap: float = 30.0
    loop_icp_iters: int = 30
    loop_icp_max_corr_dist: float = 100.0
    # false-positive gates (new capability; the reference accepts ANY
    # converged ICP with fitness < 0.3, mapOptmization.cpp:904, so a
    # tight-but-wrong alignment in self-similar geometry corrupts the
    # graph unchecked):
    loop_sigma_floor: float = 0.1            # loop-edge noise sigma =
                                             # max(floor, scale*sqrt(fitness)).
                                             # Deliberate deviation: the
                                             # reference hands gtsam the raw
                                             # ICP fitness (mean squared
                                             # PER-POINT NN distance) as the
                                             # factor's VARIANCE
                                             # (mapOptmization.cpp:932-937),
                                             # which makes one loop edge
                                             # orders of magnitude weaker
                                             # than the odometry chain — an
                                             # exact solver then correctly
                                             # computes a near-zero
                                             # correction.  A converged ICP
                                             # alignment aggregates
                                             # thousands of matches, so its
                                             # POSE error is not the
                                             # per-point spread; it is
                                             # bounded below by systematic
                                             # effects (voxel quantization
                                             # at leaf_history, partial
                                             # overlap) — the floor.  Loops
                                             # then dominate exactly when
                                             # accumulated chain drift
                                             # exceeds ICP accuracy
    loop_sigma_scale: float = 0.5            # scales sqrt(fitness) above
                                             # the floor (downweights
                                             # marginal alignments)
    loop_drift_frac: float = 0.10            # allowed translation
                                             # discrepancy between the loop
                                             # measurement and the chain
                                             # estimate, per meter of chain
                                             # path between the endpoints
                                             # (odometry drift grows with
                                             # distance travelled; a
                                             # same-pass false match implies
                                             # a large correction over a
                                             # short path and is rejected)
    loop_drift_abs: float = 1.0              # + absolute floor (m)
    loop_max_rot_correction_deg: float = 45.0  # rotation-discrepancy cap
    loop_degen_eig_frac: float = 0.02        # observability gate: reject the
                                             # candidate when the point-to-
                                             # plane information matrix of
                                             # the converged ICP alignment
                                             # has a translational
                                             # eigenvalue below this
                                             # fraction of the largest
                                             # (smooth corridor: nothing
                                             # pins the along-axis
                                             # direction, so the "tight"
                                             # fit is meaningless there).
                                             # 0 disables

    # --- voxel leaf sizes (featureAssociation.cpp:225, mapOptmization.cpp:249-257) ---
    leaf_less_flat: float = 0.2
    leaf_map_corner: float = 0.2
    leaf_map_surf: float = 0.4
    leaf_scan_corner: float = 0.2
    leaf_scan_surf: float = 0.4
    leaf_outlier: float = 0.4
    leaf_history: float = 0.4

    # --- fixed capacities (new: padded-array shapes for jit) ---
    max_sharp: int = 256                     # 2*6*n_scan rounded up
    max_less_sharp: int = 2048               # 20*6*n_scan
    max_flat: int = 512                      # 4*6*n_scan
    max_less_flat: int = 4096                # voxel-downsampled per-ring rest
    max_outlier: int = 2048
    max_scan_corner_ds: int = 1024           # downsampled current scan (corner)
    max_scan_surf_ds: int = 4096             # downsampled current scan (surf+outlier)
    max_map_corner: int = 8192               # assembled local corner map
    max_map_surf: int = 32768                # assembled local surf map
    max_keyframes: int = 4096
    kf_corner_cap: int = 512                 # per-keyframe padded block sizes
    kf_surf_cap: int = 2048
    kf_outlier_cap: int = 1024
    max_loop_edges: int = 128
    nn_query_tile: int = 2048                # query tile for chunked 5-NN.
                                             # Tiles run sequentially, so the
                                             # tile should be as large as the
                                             # (Q_tile x max_map_surf) f32
                                             # distance matrix affords: 2048 x
                                             # 32768 = 256 MB transient, 2
                                             # sequential tiles for the surf
                                             # 5-NN instead of 16 at 256
    nn_exact: bool = False                   # exact top-k vs TPU approx_min_k
                                             # (XLA backend only)
    nn_backend: str = "auto"                 # map 5-NN backend: "auto" =
                                             # fused Pallas kernel
                                             # (ops/knn_pallas.py; no (Q, N)
                                             # matrix in HBM) when nn_exact
                                             # on TPU, else XLA; or force
                                             # "pallas" / "xla"
    feature_backend: str = "auto"            # pick-loop backend: "auto" =
                                             # single Pallas kernel on TPU
                                             # (ops/features_pallas.py; the
                                             # XLA pick loop is launch-bound),
                                             # XLA elsewhere; or force
                                             # "pallas" / "xla".  Pallas
                                             # requires sector_parallel
    sector_parallel: bool = True             # pick features in all 6 sectors
                                             # at once (cross-sector +-5
                                             # suppression then applies
                                             # simultaneously rather than
                                             # sequentially; False = exact
                                             # reference ordering).  The
                                             # port runs both orders, each
                                             # as a mode of kernel K2 on
                                             # the card

    # --- pose graph (replaces gtsam; models/posegraph.py) ---
    pg_gn_iters: int = 6                     # outer Gauss-Newton iterations;
                                             # each inner solve is EXACT
                                             # (block-tridiagonal factorization
                                             # + Woodbury over loop edges), so
                                             # the outer count only tracks the
                                             # chordal nonlinearity
    pg_damping: float = 1e-6                 # Levenberg diagonal added to the
                                             # normal blocks (stabilizes the
                                             # 6x6 factorization; far below
                                             # every active information weight)
    pg_rot_sigma: float = 2e-3               # odometry edge noise (rot, rad).
    pg_trans_sigma: float = 0.01             # odometry edge noise (trans, m).
                                             # Realistic scan-to-map noise; the
                                             # reference feeds gtsam 1e-3/1e-4
                                             # (variances 1e-6/1e-8,
                                             # mapOptmization.cpp:347-350),
                                             # which makes the chain so stiff a
                                             # loop factor barely corrects it
    pg_prior_sigma: float = 1e-4             # gauge prior on pose 0.  The
                                             # ~7-decade information spread
                                             # (prior 1e8 / chain 1e4-2.5e5 /
                                             # loop ~10) is harmless to the
                                             # direct solver — it factorizes the
                                             # chain exactly instead of
                                             # iterating on it (the round-3 CG
                                             # solver stalled here)

    @property
    def segment_theta(self) -> float:
        return math.radians(self.segment_theta_deg)

    @property
    def segment_alpha_x(self) -> float:
        return math.radians(self.sensor.ang_res_x)

    @property
    def segment_alpha_y(self) -> float:
        return math.radians(self.sensor.ang_res_y)

    def replace(self, **kw) -> "PipelineConfig":
        return dataclasses.replace(self, **kw)


DEFAULT_CONFIG = PipelineConfig()


def config_for(sensor: str | SensorSpec, **kw) -> PipelineConfig:
    """Build a config for a sensor preset, with keyword overrides.

    Per-scan feature capacities scale with the ring count (the dataclass
    defaults are sized for 16 rings; a 64-beam sensor yields ~4x the feature
    candidates, and silently keeping the 16-ring caps drops features until
    odometry diverges).  Explicit keyword overrides always win."""
    spec = SENSOR_PRESETS[sensor] if isinstance(sensor, str) else sensor
    scale = max(1, -(-spec.n_scan // 16))          # ceil(n_scan / 16)
    for key, base in (("max_sharp", 256), ("max_less_sharp", 2048),
                      ("max_flat", 512), ("max_less_flat", 4096),
                      ("max_outlier", 2048)):
        kw.setdefault(key, base * scale)
    return PipelineConfig(sensor=spec, **kw)
