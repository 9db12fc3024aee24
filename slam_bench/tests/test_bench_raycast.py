"""The benchmark's PyTorch raycaster against the port's NumPy generator
(lego_loam_tpu_torch/io/synthetic.raycast) on a few poses of both
sensors, without range noise."""

import math

import numpy as np
import pytest
import torch

from lego_loam_tpu_torch import config_for
from lego_loam_tpu_torch.io import synthetic as syn
from slam_bench import raycast as rc
from slam_bench import traffic as tr


def _sensor(name):
    s = config_for(name).sensor
    return s, rc.Sensor(s.n_scan, s.horizon_scan, s.ang_res_x, s.ang_res_y,
                        s.ang_bottom, s.min_range, s.max_range)


def test_default_world_is_the_generators():
    a, b = rc.default_world(0), syn.default_world(0)
    np.testing.assert_array_equal(a.boxes, b.boxes)
    np.testing.assert_array_equal(a.cylinders, b.cylinders)


@pytest.mark.parametrize("name", ["vlp16", "hdl64e"])
def test_raycast_matches_the_generator(name):
    spec, sensor = _sensor(name)
    world = syn.default_world(0)
    poses = syn.circle_trajectory(5, radius=12.0, arc=0.6 * math.pi)[::2]
    R = torch.as_tensor(np.stack([p[0] for p in poses]))
    t = torch.as_tensor(np.stack([p[1] for p in poses]))
    xyz, valid, ring = rc.raycast(rc.default_world(0), R, t, sensor)
    for k, (Rk, tk) in enumerate(poses):
        want_xyz, want_valid, want_ring = syn.raycast(world, Rk, tk, spec)
        np.testing.assert_array_equal(valid[k].numpy(), want_valid)
        np.testing.assert_array_equal(ring.numpy(), want_ring)
        np.testing.assert_allclose(xyz[k].numpy(), want_xyz, rtol=1e-6, atol=1e-6)
        assert want_valid.sum() > 0.5 * want_valid.size


def test_mid_row_moves_points_half_a_row_up():
    _, sensor = _sensor("hdl64e")
    R = torch.eye(3, dtype=torch.float64)[None]
    t = torch.tensor([[1.0, -2.0, 1.6]], dtype=torch.float64)
    xyz, valid, _ = rc.raycast(rc.default_world(0), R, t, sensor, mid_row=True)
    p = xyz[0][valid[0]].double().numpy()
    el = np.degrees(np.arctan2(p[:, 2], np.hypot(p[:, 0], p[:, 1])))
    rows = (el + sensor.ang_bottom) / sensor.ang_res_y
    assert np.abs((rows - 0.5 + 0.5) % 1.0 - 0.5).max() < 1e-3


def test_courses_are_closed_circles_of_the_mix():
    mix = {"courses": [[3.0, 14.0, 1], [7.0, -8.0, -1]], "scans_per_course": 40,
           "step_m": 0.25, "height_m": 1.6}
    R, t = tr.course_poses(mix)
    assert R.shape == (80, 3, 3) and t.shape == (80, 3)
    for k in range(2):
        c = t[40 * k:40 * (k + 1)]
        steps = np.linalg.norm(np.diff(np.vstack([c, c[:1]]), axis=0), axis=1)
        np.testing.assert_allclose(steps, 0.25, rtol=2e-3)
        # the heading is the direction of travel
        head = R[40 * k:40 * (k + 1), :, 0]
        fwd = np.diff(np.vstack([c, c[:1]]), axis=0)
        cos = (head * fwd).sum(1) / np.linalg.norm(fwd, axis=1)
        assert cos.min() > 0.99


def test_the_seed_changes_noise_and_offsets_not_the_work():
    mix = {"courses": [[3.0, 14.0, 1]], "scans_per_course": 4, "step_m": 0.25,
           "height_m": 1.6, "noise_m": 0.01, "world_seed": 0, "batch": 5}
    _, sensor = _sensor("vlp16")
    a = tr.make_bank(mix, sensor, False, 1, "cpu")
    b = tr.make_bank(mix, sensor, False, 1, "cpu")
    c = tr.make_bank(mix, sensor, False, 2 ** 31 + 12345, "cpu")
    assert torch.equal(a.xyz, b.xyz)
    assert not torch.equal(a.xyz, c.xyz)
    assert torch.equal(a.valid, c.valid)
    np.testing.assert_array_equal(tr.offsets(mix, 7), tr.offsets(mix, 7))
    rows = tr.scan_index(mix, tr.offsets(mix, 7), 3, 2)
    assert rows.shape == (5, 2) and rows.max() < 4
