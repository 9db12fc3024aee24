"""Loop-closure false-positive robustness of the port, the counterpart of
tests/test_loop_robustness.py: its corridor worlds, out-and-back course
with injected drift along the axis and config (tests/torch_courses.py:
corridor_world, corridor_out_and_back, loop_robust_cfg), four loop checks:

  * open_corridor: the open 300 m corridor, 1.5 m of drift: a tight fit
    (fitness under history_keyframe_fitness_score) that pins nothing along
    the axis (obs_ratio under loop_degen_eig_frac) is rejected and leaves
    the keyframe poses as they were;
  * landmark_revisit: the capped 40 m corridor with two landmark boxes,
    1.5 m of drift: observable, the loop closes and the revisit keyframe
    moves back by more than half the drift;
  * drift_gate: the same world, 3.5 m of drift: a tight fit recovering
    more than 2.5 m of it is rejected by the drift gate;
  * drift_gate_raised: the same with loop_drift_frac=0.5, and nothing
    else changed: it closes, so the drift gate alone decided.

Each check runs from a state the port builds itself (corridor_state: the
port's voxel_downsample of the keyframe scans), held to every assertion of
the JAX test; the states are built once per module.

The `slow` cases hold the port to the JAX package from the JAX test's own
state (_make_state, carried across with utils/convert.state_from_numpy):
both loop_closure_step calls take the same decision (closed, n_loops),
fitness, drift and obs_ratio agree (below), and every keyframe position
after the step lies within 1 cm.  They are `slow` because the JAX package's
loop check takes ~44 s a call on an 8-core CPU (100 ICP iterations over a
4352 x 16384 search), ~200 s for the four, past the tier-1 budget that
tests/test_loop_robustness.py already spends on the same calls.
Tolerances of the slow cases, the largest measured gap in brackets:
fitness and drift within 1e-3 relative (2.5e-4 and 1.0e-5); obs_ratio
within 2e-2 relative or 1e-4 absolute (6.7e-3 relative on the landmark
corridor; 1.7e-5 absolute on the open one, where it is ~0.0018:
eigvalsh3 on near-collinear 5-NN sets, tests/test_torch_loop.py says
why); keyframe positions within 1 cm (0.018 mm).  torch runs on one thread.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.test_loop_robustness as jlr
from lego_loam_tpu.io import synthetic as jsyn
from lego_loam_tpu.models import loop as jlc
from lego_loam_tpu_torch import config_for
from lego_loam_tpu_torch.models import loop as tlc
from lego_loam_tpu_torch.utils.convert import state_from_numpy, state_to_numpy
from tests.torch_courses import (CORRIDOR_CASES, CORRIDOR_LANDMARKS,
                                 CORRIDOR_START,
                                 corridor_clouds, corridor_gate_faults,
                                 corridor_out_and_back, corridor_state,
                                 corridor_world, loop_robust_cfg)

POS_TOL = 1e-2                       # m, keyframe positions after the step
REL_TOL = 1e-3                       # fitness and drift
OBS_RTOL, OBS_ATOL = 2e-2, 1e-4      # obs_ratio
CASES = {name: (landmarks, drift, over) for name, landmarks, drift, over in CORRIDOR_CASES}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def clouds():
    """Each world's keyframe scans (the two drifts share the true poses)."""
    cfg = config_for("vlp16", **loop_robust_cfg())
    true_world = corridor_out_and_back(0.0)[0]
    return {lm: corridor_clouds(cfg, corridor_world(lm), true_world)
            for lm in (False, True)}


def test_fixtures_are_the_jax_tests():
    """START, LANDMARKS and the out-and-back course equal the JAX test's."""
    np.testing.assert_array_equal(CORRIDOR_START, jlr.START)
    np.testing.assert_array_equal(CORRIDOR_LANDMARKS, jlr.LANDMARKS)
    for drift in (1.5, 3.5):
        ours, theirs = corridor_out_and_back(drift), jlr._out_and_back(drift_x=drift)
        assert ours[2] == theirs[2]
        for a, b in ((ours[0], theirs[0]), (ours[1], theirs[1])):
            assert len(a) == len(b)
            for (Ra, ta), (Rb, tb) in zip(a, b):
                np.testing.assert_array_equal(Ra, Rb)
                np.testing.assert_array_equal(ta, tb)
    for lm in (False, True):
        ours = corridor_world(lm)
        theirs = (jsyn.corridor_world(landmarks=jlr.LANDMARKS, length=40.0) if lm
                  else jsyn.corridor_world(length=300.0, end_caps=False))
        for f in ("ground_z", "boxes", "cylinders"):
            np.testing.assert_array_equal(getattr(ours, f), getattr(theirs, f))


@pytest.mark.parametrize("name", list(CASES))
def test_port_state_meets_the_jax_tests_gates(name, clouds):
    landmarks, drift, over = CASES[name]
    cfg = config_for("vlp16", **loop_robust_cfg(**over))
    _, est_map, times = corridor_out_and_back(drift)
    state = corridor_state(cfg, clouds[landmarks], est_map, times, "cpu")
    before = state.kf_t.clone()
    new_state, res = tlc.loop_closure_step(state, times[-1], cfg)
    for v in (res.fitness, res.drift, res.obs_ratio, new_state.kf_t):
        assert torch.isfinite(v).all(), name
    assert not corridor_gate_faults(name, cfg, res, before, new_state, len(times))


@pytest.mark.slow
@pytest.mark.parametrize("name", list(CASES))
def test_loop_check_matches_jax_from_its_state(name):
    landmarks, drift, over = CASES[name]
    jcfg = jlr._cfg(**over)
    tcfg = config_for("vlp16", **loop_robust_cfg(**over))
    world = (jsyn.corridor_world(landmarks=jlr.LANDMARKS, length=40.0) if landmarks
             else jsyn.corridor_world(length=300.0, end_caps=False))
    tw, em, times = jlr._out_and_back(drift_x=drift)
    jstate = jax.device_get(jlr._make_state(jcfg, world, tw, em, times))
    n = len(tw)
    # loop_closure_step donates its state: hand it a device copy
    jst, jres = jax.device_get(jlc.loop_closure_step(
        jax.device_put(jstate), jnp.float32(times[-1]), jcfg))
    tstate = state_from_numpy(jstate, "cpu")
    tst, tres = tlc.loop_closure_step(tstate, times[-1], tcfg)
    tres_np = state_to_numpy(tres)

    assert not corridor_gate_faults(name, tcfg, tres, jstate.kf_t, tst, n)
    assert bool(tres_np.closed) == bool(jres.closed), name
    assert int(tst.n_loops) == int(jst.n_loops), name
    for f in ("fitness", "drift"):
        np.testing.assert_allclose(getattr(tres_np, f), getattr(jres, f), rtol=REL_TOL,
                                   err_msg=f)
    np.testing.assert_allclose(tres_np.obs_ratio, jres.obs_ratio, rtol=OBS_RTOL,
                               atol=OBS_ATOL, err_msg="obs_ratio")
    np.testing.assert_allclose(tst.kf_t[:n].numpy(), np.asarray(jst.kf_t)[:n],
                               atol=POS_TOL)
