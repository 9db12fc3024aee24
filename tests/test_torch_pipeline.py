"""Whole-slice parity: 6 seeded synthetic VLP-16 scans through both
LegoLoamPipelines (JAX package and PyTorch port, CPU), fused poses
compared scan by scan.

Tolerance: 1 cm and 0.1 deg on the fused pose, and the packed per-scan
stats equal.  Each odometry and mapping solve lands within ~1.5 mm /
0.02 deg of the JAX package's (see tests/test_torch_backend.py for why:
ill-conditioned 5-point plane fits amplify float32 rounding differences),
and the pose chain carries those offsets forward, so over 6 scans they
add up to ~4 mm / 0.05 deg (measured); the bound leaves 2x margin while
staying far below the 0.15 m trajectory bound of tests/test_pipeline.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

from lego_loam_tpu import config_for as jconfig_for
from lego_loam_tpu.io import synthetic as syn
from lego_loam_tpu.models.pipeline import LegoLoamPipeline as JaxPipeline
from lego_loam_tpu_torch import SENSOR_PRESETS, config_for
from lego_loam_tpu_torch.models.pipeline import LegoLoamPipeline
from lego_loam_tpu_torch.ops import features, knn, segmentation

from tests.test_torch_backend import _rot_err_deg
from tests.torch_courses import FAITHFUL, SMALL, slice_course

POS_TOL, ROT_TOL_DEG = 1e-2, 0.1


def test_slice_matches_jax_pipeline():
    jcfg, tcfg = jconfig_for("vlp16", **SMALL), config_for("vlp16", **SMALL)
    poses, scans = slice_course(tcfg.sensor)
    jpipe, tpipe = JaxPipeline(jcfg), LegoLoamPipeline(tcfg, "cpu")
    wrappers = (segmentation.propagate_labels, features.label_features, knn.knn)
    launches = [w.launches for w in wrappers]

    R0, t0 = poses[0]
    errs = []
    for (R, t), (xyz, valid, ring) in zip(poses, scans):
        jr = jpipe.process_scan(xyz, valid, ring)
        tr = tpipe.process_scan(xyz, valid, ring)
        assert tr.stats == jr.stats
        assert (tr.mapped_pose is None) == (jr.mapped_pose is None)
        np.testing.assert_allclose(tr.fused_pose.t.numpy(),
                                   np.asarray(jr.fused_pose.t), atol=POS_TOL)
        assert _rot_err_deg(np.asarray(jr.fused_pose.R),
                            tr.fused_pose.R.numpy()) < ROT_TOL_DEG
        errs.append(np.linalg.norm(R0 @ tpipe.trajectory[-1] + t0 - t))

    # the port tracks the ground truth on its own, too
    assert np.sqrt(np.mean(np.square(errs))) < 0.15
    np.testing.assert_allclose(tpipe.keyframe_poses(), jpipe.keyframe_poses(),
                               atol=POS_TOL)
    # on CPU tensors every wrapper ran its plain version: no kernel launched
    assert [w.launches for w in wrappers] == launches


def test_pipeline_requires_ported_features():
    """Every setting the JAX package runs is ported: the constructor takes
    loop closure, and the reference-faithful configuration (sequential
    sector picks, the two-step odometry, the 3-point surf plane) runs
    through process_scan, two scans, the second with its odometry solve."""
    LegoLoamPipeline(config_for("vlp16", loop_closure_enabled=True, **SMALL), "cpu")
    cfg = config_for("vlp16", **dict(SMALL, **FAITHFUL))
    pipe = LegoLoamPipeline(cfg, torch.device("cpu"))
    for x in (0.0, 0.3):
        xyz, valid, ring = syn.raycast(syn.default_world(0), np.eye(3),
                                       np.array([x, 0.0, 1.6]), cfg.sensor)
        res = pipe.process_scan(xyz, valid, ring)
        assert res.stats["n_sharp"] > 0 and res.stats["n_flat"] > 0
    # the solve moved the pose along the 0.3 m step in x (from the zero
    # seed the two-step lands 0.23 m out, as the JAX package's does)
    t = res.fused_pose.t.numpy()
    assert 0.15 < t[0] < 0.45 and abs(t[1]) < 0.05 and abs(t[2]) < 0.05


def test_pipeline_runs_on_the_card_by_default():
    import inspect

    default = inspect.signature(LegoLoamPipeline).parameters["device"].default
    assert torch.device(default).type == "cuda"
    if not torch.cuda.is_available():
        # no quiet fallback to the CPU: without a card the default refuses
        with pytest.raises((AssertionError, RuntimeError)):
            LegoLoamPipeline(config_for("vlp16", **SMALL))


@pytest.mark.parametrize("over", [dict(sections_total=9), dict(horizon_scan=3100)])
def test_card_pipeline_refuses_configs_k2_cannot_take(over):
    """Kernel K2 takes 1..8 sectors and rings of at most 3082 cells; a
    pipeline on the card refuses any other config when it is built, before
    any scan (the plain version and a CPU pipeline take any)."""
    sensor = dataclasses.replace(SENSOR_PRESETS["vlp16"],
                                 horizon_scan=over.get("horizon_scan", 1800))
    kw = {k: v for k, v in over.items() if k != "horizon_scan"}
    cfg = config_for(sensor, **kw, **SMALL)
    with pytest.raises(ValueError, match="do not fit K2"):
        features.check_k2_fits(cfg)
    with pytest.raises(ValueError, match="do not fit K2"):
        LegoLoamPipeline(cfg, "cuda")
    LegoLoamPipeline(cfg, "cpu")
    for name in SENSOR_PRESETS:
        features.check_k2_fits(config_for(name))
    features.check_k2_fits(config_for(dataclasses.replace(sensor, horizon_scan=3082)))
