"""Shared test courses of the PyTorch port, free of jax: the CPU parity
tests and chip_smoke.py (which runs where jax is not installed) drive the
same configs over the same seeded synthetic scans.

  * SMALL: the small capacities of tests/test_pipeline.py with the exact
    5-NN (the port's kernel is exact; the JAX default approximates on a
    TPU); slice_course() is tests/test_torch_pipeline.py's 6-scan course.
  * LOOP: tests/test_loop_pipeline.py's config overrides, of which
    LOOP_COURSE_KNOBS are the course's own; loop_course() is its
    out-and-back course (out along x, back 0.3 m to the side), with its
    scan stamps, or a shorter one (LOOP_SHORT_OUT scans out).

Scans come from the port's raycaster, which casts byte-identical scans to
the JAX package's (tests/test_torch_import.py).
"""

from __future__ import annotations

import numpy as np

from lego_loam_tpu_torch.io import synthetic as syn

SMALL = dict(deskew=False, max_keyframes=64, max_map_corner=2048,
             max_map_surf=8192, kf_corner_cap=512, kf_surf_cap=2048,
             kf_outlier_cap=512, max_scan_corner_ds=512, max_scan_surf_ds=2048,
             nn_query_tile=256, mapping_process_every=2, nn_exact=True)
SLICE_SCANS = 6

# the knobs of the out-and-back course: a revisit 3 s after the first
# visit counts, every scan is mapped, and keyframes are 0.25 m apart
LOOP_COURSE_KNOBS = dict(mapping_process_every=1, loop_min_time_gap=3.0,
                         keyframe_min_translation=0.25)
LOOP = dict(deskew=False, max_keyframes=64, max_map_corner=2048,
            max_map_surf=8192, kf_corner_cap=256, kf_surf_cap=1024,
            kf_outlier_cap=256, max_scan_corner_ds=256, max_scan_surf_ds=1024,
            nn_query_tile=256, loop_closure_enabled=True, max_loop_edges=8,
            pg_gn_iters=4, **LOOP_COURSE_KNOBS)
LOOP_CHECK_EVERY = 2
LOOP_SCAN_PERIOD = 0.55     # s between stamps of the out-and-back course
LOOP_FINAL_BOUND = 0.12     # m, the final-pose bound of test_loop_pipeline.py
LOOP_OUT = 8                # scans out (and as many back) on the full course
LOOP_SHORT_OUT = 5          # the shorter course the CPU parity test drives


def slice_course(sensor, n: int = SLICE_SCANS):
    """(poses, scans): the first n poses of a 12-pose circle arc of radius
    8 m in world seed 4, each scan with 1 cm range noise (seed = index)."""
    world = syn.default_world(seed=4)
    poses = syn.circle_trajectory(12, radius=8.0, arc=0.35 * np.pi)[:n]
    scans = [syn.raycast(world, R, t, sensor, noise=0.01,
                         rng=np.random.default_rng(k))
             for k, (R, t) in enumerate(poses)]
    return poses, scans


def loop_positions(n_out: int = LOOP_OUT, step: float = 0.45, side: float = 0.3):
    """Sensor positions of the out-and-back course: n_out steps out along
    x, then the same steps back, `side` metres to the left."""
    out = [np.array([step * i, 0.0, 1.6]) for i in range(n_out)]
    back = [np.array([step * (n_out - 1 - i), side, 1.6]) for i in range(n_out)]
    return out + back


def loop_course(sensor, n_out: int = LOOP_OUT):
    """(positions, scans, stamps) of the out-and-back course in world
    seed 6 (no rotation, 1 cm range noise, seed = index)."""
    world = syn.default_world(seed=6)
    ts = loop_positions(n_out)
    scans = [syn.raycast(world, np.eye(3), t, sensor, noise=0.01,
                         rng=np.random.default_rng(k))
             for k, t in enumerate(ts)]
    return ts, scans, [LOOP_SCAN_PERIOD * k for k in range(len(ts))]
