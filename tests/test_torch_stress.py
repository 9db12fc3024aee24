"""The port on tests/test_stress.py's two courses (its config, seeds and
2 cm noise: tests/torch_courses.STRESS, stress_corridor, stress_fast_yaw),
held to every bound of that test that the JAX package meets.

  * fast yaw (40 scans, a full turn on a 4 m circle): ATE under 0.25 m and
    the final error under 0.35 m, as the JAX package meets them.
  * corridor (50 scans at 0.8 m down a 300 m corridor with poles every
    12 m): finite, and the lateral drift under 0.15 m.  The JAX package
    misses all three of the test's corridor bounds (ROADMAP C2): lateral
    0.326 m, vertical 12.23 m, along 8.11 m (bounds 0.15, 0.15 and 1.96 m);
    the port lands 0.085 / 4.98 / 2.007 m (python -m tests.stress_gaps, CPU).
    So the port is held to the lateral bound it meets, and the vertical and
    along-axis drifts, which both packages miss, are not asserted.

The JAX trajectories are not rerun here (tests/test_stress.py alone takes
~750 s of a tier-1 worker); tests/stress_gaps.py prints both packages'
per-scan gaps.  The port's two courses take ~110 s on one CPU thread, so
the file is `slow`; chip_smoke.py's robustness phase runs both courses on
the card.
"""

from __future__ import annotations

import pytest
import torch

from lego_loam_tpu_torch import config_for
from lego_loam_tpu_torch.models.pipeline import LegoLoamPipeline
from tests.torch_courses import (STRESS, STRESS_LAT, STRESS_YAW_ATE,
                                 STRESS_YAW_FINAL, stress_corridor, stress_errors,
                                 stress_fast_yaw, stress_scans)

pytestmark = pytest.mark.slow

CFG = config_for("vlp16", **STRESS)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(course):
    """test_stress.py's _run: the course through process_scan without
    stats, stamped 0.1 s apart; its errors (stress_errors)."""
    world, poses = course()
    pipe = LegoLoamPipeline(CFG, "cpu", collect_stats=False)
    for k, scan in enumerate(stress_scans(world, poses, CFG.sensor)):
        pipe.process_scan(*scan, t=0.1 * k)
    traj = pipe.trajectory_numpy()
    assert traj.shape == (len(poses), 3)
    return stress_errors(traj, poses)


def test_corridor_is_finite_and_laterally_bounded():
    e = _run(stress_corridor)
    assert e["finite"]
    assert e["lat"] < STRESS_LAT, f"lateral drift {e['lat']:.3f} m"


def test_fast_yaw_high_dynamics():
    e = _run(stress_fast_yaw)
    assert e["finite"]
    assert e["ate"] < STRESS_YAW_ATE, f"fast-yaw ATE {e['ate']:.3f} m"
    assert e["final"] < STRESS_YAW_FINAL, f"fast-yaw final error {e['final']:.3f} m"
