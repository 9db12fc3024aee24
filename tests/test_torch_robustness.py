"""Degenerate-input robustness of the port against the JAX package, the
counterpart of tests/test_robustness.py: its config (tests/torch_courses.
ROBUST) and its four courses (robustness_course: an all-invalid scan, one
valid point, 50 random points; NaN and 1e8 m points; one scan repeated four
times; two good scans, a burst of two all-invalid scans, four good scans),
the same numpy scans through both packages' process_scan on the CPU.

On every scan, on both sides: the odometry and fused poses and every
keyframe position finite.  The port against the JAX package: odometry and
fused poses within 1 cm / 0.1 deg (C6's bound; measured up to 2.6 mm on
the recovery course and 0.029 deg on the repeated scan), the same mapping
cadence, loop flag and keyframe count, and keyframe positions within
1 cm.  The repeated scan moves under test_identical_repeated_scans' 0.02 m.

The per-scan stats (valid pixels, ground, segmented cells, sharp and flat
picks) equal the JAX pipeline's, or, on a scan where they do not, those of
the JAX package's front end with project_scan and segment_scan run op by
op under jax.disable_jit (extract_features jitted).  The jitted JAX
pipeline differs from that by up to 2 counts on 4 of these 17 scans
(n_valid_px 14485 / 14484 on the NaN course, n_flat 151 / 152 on the
repeated scan, n_segmented 5965 / 5967 and 6029 / 6027 on the recovery
scans): XLA's fused CPU program rounds the ranges |p| otherwise than
float32 taken op by op (2361 of 28800 squared norms differ in the last
bit on the repeated scan), and a cell at a gate's edge flips.  The port's
stats equal those op-by-op ones on all 17 scans (measured).

One more case: the recovery course through the port's process_chunk in
chunks of 4 (the burst inside the first) against its process_scan, at
1 mm / 0.01 deg with equal stats.  torch runs on one thread.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.test_loop_robustness as jloop
import tests.test_robustness as jrob
import tests.test_stress as jstress
from lego_loam_tpu.models.pipeline import LegoLoamPipeline as JaxPipeline
from lego_loam_tpu.ops.compaction import segment_scan as jsegment_scan
from lego_loam_tpu.ops.features import extract_features as jextract_features
from lego_loam_tpu.ops.projection import project_scan as jproject_scan
from lego_loam_tpu_torch import config_for
from lego_loam_tpu_torch.models.pipeline import STAT_NAMES, LegoLoamPipeline
from tests.test_torch_backend import _rot_err_deg
from tests.torch_courses import (IDENTICAL_BOUND, ROBUST, ROBUST_COURSES,
                                 STRESS, loop_robust_cfg, robustness_course)

JAX_M, JAX_DEG = 1e-2, 0.1           # the port against the JAX package (C6)
SAME_M, SAME_DEG = 1e-3, 0.01        # process_chunk against process_scan
CHUNK_C = 4

TCFG = config_for("vlp16", **ROBUST)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("copy,jax_cfg", [
    (ROBUST, jrob.CFG), (loop_robust_cfg(), jloop._cfg()),
    (loop_robust_cfg(loop_drift_frac=0.5), jloop._cfg(loop_drift_frac=0.5)),
    (STRESS, jstress.CFG)], ids=["robustness", "loop", "loop_drift", "stress"])
def test_copied_configs_equal_the_jax_tests(copy, jax_cfg):
    """tests/torch_courses.py's copies of the A20 configs give the JAX
    tests' configs field for field."""
    assert dataclasses.asdict(config_for("vlp16", **copy)) == dataclasses.asdict(jax_cfg)


_jit_features = jax.jit(jextract_features, static_argnums=2)


def _jax_frontend_stats(xyz, valid, ring):
    """The JAX package's front-end stats of one scan, projection and
    segmentation op by op."""
    with jax.disable_jit():
        img = jproject_scan(jnp.asarray(xyz), jnp.asarray(valid), jrob.CFG,
                            jnp.asarray(ring))
        packed, o_rel, ground, _ = jsegment_scan(img, jrob.CFG)
    feats = _jit_features(packed, o_rel, jrob.CFG)
    vals = (img.valid.sum(), ground.sum(), packed.count.sum(),
            feats.sharp.valid.sum(), feats.flat.valid.sum())
    return dict(zip(STAT_NAMES, (int(v) for v in vals)))


def _assert_finite(res, kf_t, what):
    for name, t in (("odom", res.odom_pose.t), ("fused", res.fused_pose.t),
                    ("keyframes", kf_t)):
        assert np.isfinite(np.asarray(t)).all(), f"{what}: {name} not finite"


def _assert_pose(tp, jp, tol_m, tol_deg, what):
    np.testing.assert_allclose(np.asarray(tp.t), np.asarray(jp.t), atol=tol_m,
                               err_msg=what)
    assert _rot_err_deg(np.asarray(jp.R), np.asarray(tp.R)) < tol_deg, what


@pytest.mark.parametrize("course", ROBUST_COURSES)
def test_course_matches_jax(course):
    jpipe, tpipe = JaxPipeline(jrob.CFG), LegoLoamPipeline(TCFG, "cpu")
    for k, (xyz, valid, ring, t) in enumerate(robustness_course(course, TCFG.sensor)):
        what = f"{course}, scan {k}"
        jr = jpipe.process_scan(xyz, valid, ring, t=t)
        tr = tpipe.process_scan(xyz, valid, ring, t=t)
        _assert_finite(jr, jpipe.mstate.kf_t, what + " (JAX package)")
        _assert_finite(tr, tpipe.mstate.kf_t, what + " (port)")
        _assert_pose(tr.odom_pose, jr.odom_pose, JAX_M, JAX_DEG, what + ", odometry")
        _assert_pose(tr.fused_pose, jr.fused_pose, JAX_M, JAX_DEG, what + ", fused")
        assert (tr.mapped_pose is None) == (jr.mapped_pose is None), what
        assert tr.loop_closed == jr.loop_closed, what
        if tr.stats != jr.stats:
            assert tr.stats == _jax_frontend_stats(xyz, valid, ring), what
        n = int(jpipe.mstate.n_kf)
        assert int(tpipe.mstate.n_kf) == n, what
        np.testing.assert_allclose(tpipe.mstate.kf_t[:n].numpy(),
                                   np.asarray(jpipe.mstate.kf_t)[:n], atol=JAX_M,
                                   err_msg=what)
    if course == "identical_repeated":
        assert np.linalg.norm(tr.fused_pose.t.numpy()) < IDENTICAL_BOUND
        assert np.linalg.norm(np.asarray(jr.fused_pose.t)) < IDENTICAL_BOUND


def test_garbage_burst_inside_a_chunk():
    """The recovery course through process_chunk in chunks of 4 (good, good,
    garbage, garbage | four good; the course's stamps are 0.1 s apart, the
    scan period) against process_scan, scan by scan."""
    scans = robustness_course("garbage_then_recovery", TCFG.sensor)
    assert [t for *_, t in scans] == pytest.approx(
        [TCFG.sensor.scan_period * k for k in range(len(scans))])
    per = LegoLoamPipeline(TCFG, "cpu")
    rows = [per.process_scan(*s) for s in scans]
    chunked = LegoLoamPipeline(TCFG, "cpu")
    k = 0
    for c0 in range(0, len(scans), CHUNK_C):
        part = scans[c0:c0 + CHUNK_C]
        res = chunked.process_chunk(*(np.stack([s[i] for s in part]) for i in range(3)),
                                    t0=part[0][3])
        for j in range(len(part)):
            what = f"scan {k}"
            r = rows[k]
            assert res.stats[j].tolist() == [r.stats[n] for n in STAT_NAMES], what
            assert bool(res.did_map[j]) == (r.mapped_pose is not None), what
            assert bool(res.loop_closed[j]) == r.loop_closed, what
            for got, want in ((res.odom_poses, r.odom_pose),
                              (res.fused_poses, r.fused_pose)):
                assert np.isfinite(got.t[j].numpy()).all(), what
                _assert_pose(type(want)(got.R[j], got.t[j]), want, SAME_M, SAME_DEG, what)
            if r.mapped_pose is not None:
                _assert_pose(type(r.mapped_pose)(res.mapped_poses.R[j],
                                                 res.mapped_poses.t[j]),
                             r.mapped_pose, SAME_M, SAME_DEG, what + ", mapped")
            k += 1
    assert int(chunked.mstate.n_kf) == int(per.mstate.n_kf)
    assert np.isfinite(chunked.mstate.kf_t.numpy()).all()
