"""The loop-closure slice as a whole: tests/test_loop_pipeline.py's config
(tests/torch_courses.py::LOOP) with loop checks every 2nd scan, through
both LegoLoamPipelines (JAX package and PyTorch port, CPU), on a shortened
out-and-back course (5 scans out, 5 back; the full 8 + 8 course costs
twice the time, and a loop closes on this one in both pipelines).

Both pipelines must take the same loop decisions: loop_closed equal on
every scan (a loop closes on scans 6 and 8), the same n_loops.  The port's
final pose lies within test_loop_pipeline.py's 0.12 m of the truth.

Poses: fused poses on every scan and the keyframe poses at the end within
1 cm / 0.2 deg of the JAX package's: the 1 cm of
tests/test_torch_pipeline.py, the rotation bound twice its 0.1 deg.
Measured over the 10 scans: largest fused gap 6.42 mm and 0.146 deg
(scan 9), keyframes 6.42 mm.  The loop check is not where the two part:
from one state the two packages' loop checks agree far inside 1 cm / 0.1
deg (tests/test_torch_loop.py).  They part in the scan-to-map solves of
this config (mapping on every scan, 1024 surf points a scan), whose
5-point plane fits solve normal equations of points metres from the
origin.  In float32, as the JAX package fits them, few digits are left,
so normals move with the rounding order (XLA's FMAs against torch's
separate products) and some fits cross the validity gates; each solve
then lands millimetres and hundredths of a degree away, and the chain
carries that forward.  The port fits in float64 (models/mapping.py
FIT_DTYPE, a by-design divergence, ROADMAP C).  The gap is not that
choice: tests/loop_parity_gaps.py runs the port with float32 fits
against the JAX package on these scans, and the gap is of the same size,
10.34 mm and 0.110 deg (the float64 fits: 6.42 mm and 0.146 deg, as
above), with the same loops closed.
"""

import numpy as np
import pytest
import torch

from lego_loam_tpu import config_for as jconfig_for
from lego_loam_tpu.models.pipeline import LegoLoamPipeline as JaxPipeline
from lego_loam_tpu_torch import config_for
from lego_loam_tpu_torch.models.pipeline import LegoLoamPipeline
from lego_loam_tpu_torch.ops import features, knn, segmentation

from tests.test_torch_backend import _rot_err_deg
from tests.torch_courses import (
    LOOP,
    LOOP_CHECK_EVERY,
    LOOP_FINAL_BOUND,
    LOOP_SHORT_OUT,
    loop_course,
)

POS_TOL, ROT_TOL_DEG = 1e-2, 0.2


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The suite runs several workers at once; one torch thread keeps this
    module from oversubscribing the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_loop_slice_matches_jax_pipeline():
    jcfg, tcfg = jconfig_for("vlp16", **LOOP), config_for("vlp16", **LOOP)
    positions, scans, stamps = loop_course(tcfg.sensor, LOOP_SHORT_OUT)
    jpipe = JaxPipeline(jcfg, loop_check_every=LOOP_CHECK_EVERY)
    tpipe = LegoLoamPipeline(tcfg, "cpu", loop_check_every=LOOP_CHECK_EVERY)
    wrappers = (segmentation.propagate_labels, features.label_features, knn.knn)
    launches = [w.launches for w in wrappers]

    closed = []
    for (xyz, valid, ring), t in zip(scans, stamps):
        jr = jpipe.process_scan(xyz, valid, ring, t=t)
        tr = tpipe.process_scan(xyz, valid, ring, t=t)
        assert tr.loop_closed == jr.loop_closed
        assert tr.stats == jr.stats
        np.testing.assert_allclose(tr.fused_pose.t.numpy(),
                                   np.asarray(jr.fused_pose.t), atol=POS_TOL)
        assert _rot_err_deg(np.asarray(jr.fused_pose.R),
                            tr.fused_pose.R.numpy()) < ROT_TOL_DEG
        # an accepted loop moved the keyframes: the next solve re-gathers
        # the local map (the JAX package sets this flag on the device)
        assert tpipe.mstate.map_stale == bool(jpipe.mstate.map_stale)
        closed.append(tr.loop_closed)

    assert any(closed), "no loop closure fired on the revisit"
    assert int(tpipe.mstate.n_loops) == int(jpipe.mstate.n_loops) == sum(closed)
    np.testing.assert_allclose(tpipe.keyframe_poses(), jpipe.keyframe_poses(),
                               atol=POS_TOL)
    true_final = positions[-1] - np.array([0.0, 0.0, 1.6])
    assert np.linalg.norm(tr.fused_pose.t.numpy() - true_final) < LOOP_FINAL_BOUND
    # on CPU tensors every wrapper ran its plain version: no kernel launched
    assert [w.launches for w in wrappers] == launches
