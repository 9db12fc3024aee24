"""Synthetic scans of an elevation-math preset (no ring channel), moved into
the middle of their rows.

The raycaster of io/synthetic casts each ring at the very elevation where
two rows of the elevation math meet, so the row of every point hangs on the
last bit of atan2: the JAX package's own jitted and unjitted projections of
such a scan disagree on many pixels.  A real sensor's beams sit inside their
rows; :func:`mid_row` moves every point half a row up, range and azimuth
kept.  chip_smoke.py's HDL-64E path and tests/test_torch_hdl64e.py feed the
scans through it.
"""

import numpy as np

from lego_loam_tpu_torch import config_for
from lego_loam_tpu_torch.io import synthetic as syn


def mid_row(xyz, sensor):
    """Each point moved half an elevation row up, range and azimuth kept."""
    p = xyz.astype(np.float64)
    rho = np.hypot(p[:, 0], p[:, 1])
    rng = np.hypot(rho, p[:, 2])
    el = np.arctan2(p[:, 2], rho) + np.radians(0.5 * sensor.ang_res_y)
    az = np.arctan2(p[:, 1], p[:, 0])
    return np.stack([rng * np.cos(el) * np.cos(az), rng * np.cos(el) * np.sin(az),
                     rng * np.sin(el)], axis=1).astype(np.float32)


def test_mid_row_moves_points_from_row_boundaries_to_row_middles():
    sensor = config_for("hdl64e").sensor
    R, t = syn.circle_trajectory(6, radius=8.0, arc=0.12 * np.pi)[1]
    xyz, valid, _ = syn.raycast(syn.default_world(seed=9), R, t, sensor,
                                noise=0.02, rng=np.random.default_rng(1))
    xyz = xyz[valid]
    moved = mid_row(xyz, sensor)
    for pts, frac in ((xyz, 0.0), (moved, 0.5)):
        p = pts.astype(np.float64)
        el = np.degrees(np.arctan2(p[:, 2], np.hypot(p[:, 0], p[:, 1])))
        rows = (el + sensor.ang_bottom) / sensor.ang_res_y
        assert np.abs((rows - frac + 0.5) % 1.0 - 0.5).max() < 1e-4
    np.testing.assert_allclose(np.linalg.norm(moved, axis=1),
                               np.linalg.norm(xyz, axis=1), rtol=1e-6)
    np.testing.assert_allclose(np.arctan2(moved[:, 1], moved[:, 0]),
                               np.arctan2(xyz[:, 1], xyz[:, 0]), atol=1e-5)
