"""HDL-64E (KITTI's sensor) parity: the PyTorch port against the JAX
package on 64 x 1800 range images whose rows come from elevation math (no
ring channel), CPU.

Two seeded synthetic scans of tests/test_hdl64e.py's course, at its config
and through its KITTI ingest padding, so the JAX side reuses the programs
that test compiles.  The raycaster casts each ring at the very elevation
where two rows of the elevation math meet, so the row of every point
hangs on the last bit of atan2 (the JAX package's own jitted and unjitted
projections of these scans disagree on many pixels); every point is moved
half a row up, range and azimuth kept, into the middle of its row, as a
real sensor's beams are (tests/test_torch_sensor_rows.py::mid_row, which
the HDL-64E path of chip_smoke.py uses too).  The front end (projection, segmentation labels,
feature picks) must match exactly, as on VLP-16
(tests/test_torch_frontend.py); process_scan's fused poses within 1 cm /
0.1 deg and its stats equal, the bound tests/test_torch_pipeline.py
states for VLP-16.  The JAX side's map 5-NN is lax.approx_min_k
(nn_exact=False, as in tests/test_hdl64e.py), which off the TPU is a sort
and slice, an exact top-k like the port's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lego_loam_tpu.io import synthetic as jsyn
from lego_loam_tpu.io.kitti import pad_scan
from lego_loam_tpu.models.pipeline import LegoLoamPipeline as JaxPipeline
from lego_loam_tpu.ops import features as jfeat
from lego_loam_tpu.ops.compaction import segment_scan as jsegment_scan
from lego_loam_tpu.ops.projection import project_scan as jproject
from lego_loam_tpu_torch import config_for
from lego_loam_tpu_torch.io import synthetic as syn
from lego_loam_tpu_torch.models.pipeline import LegoLoamPipeline
from lego_loam_tpu_torch.ops import features as tfeat
from lego_loam_tpu_torch.ops.compaction import segment_scan as tsegment_scan
from lego_loam_tpu_torch.ops.projection import project_scan as tproject

from tests.test_hdl64e import CFG as JCFG
from tests.test_torch_backend import _rot_err_deg
from tests.test_torch_sensor_rows import mid_row

TCFG = config_for("hdl64e", **{
    k: getattr(JCFG, k) for k in (
        "deskew", "max_keyframes", "max_map_corner", "max_map_surf",
        "kf_corner_cap", "kf_surf_cap", "kf_outlier_cap", "max_scan_corner_ds",
        "max_scan_surf_ds", "nn_query_tile", "max_less_flat", "max_less_sharp",
        "max_sharp", "max_flat", "max_outlier")})
POS_TOL, ROT_TOL_DEG = 1e-2, 0.1
N_SCANS = 2


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The suite runs several workers at once; torch's own thread pool on
    top of theirs oversubscribes the host (this module's run time grew
    several-fold in the suite), and one thread costs it little alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scans():
    """(xyz, valid) of N_SCANS scans, padded as the KITTI ingest pads them,
    and the ground-truth poses."""
    world = syn.default_world(seed=9)
    poses = syn.circle_trajectory(6, radius=8.0, arc=0.12 * np.pi)[:N_SCANS]
    out = []
    for k, (R, t) in enumerate(poses):
        xyz, valid, _ = syn.raycast(world, R, t, TCFG.sensor, noise=0.02,
                                    rng=np.random.default_rng(k))
        raw = np.concatenate([mid_row(xyz[valid], TCFG.sensor),
                              np.zeros((valid.sum(), 1), np.float32)], axis=1)
        out.append(pad_scan(raw, JCFG))
    return out, poses


def test_config_and_scan_match_the_jax_side():
    assert dataclasses.asdict(TCFG) == dataclasses.asdict(JCFG)
    assert not TCFG.sensor.use_ring
    R, t = syn.circle_trajectory(6, radius=8.0, arc=0.12 * np.pi)[1]
    a = syn.raycast(syn.default_world(seed=9), R, t, TCFG.sensor, noise=0.02,
                    rng=np.random.default_rng(1))
    b = jsyn.raycast(jsyn.default_world(seed=9), R, t, JCFG.sensor,
                     noise=0.02, rng=np.random.default_rng(1))
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes()


def _jax_frontend(xyz, valid):
    """The JAX package's front end as one program (one compile, where its
    functions called one by one compile every op)."""
    img = jproject(xyz, valid, JCFG, None)
    packed, _, ground, seg = jsegment_scan(img, JCFG)
    lab, pick = jfeat.label_features(packed, JCFG)
    return img.valid, img.xyz, ground, seg, lab, pick


def test_frontend_matches_jax(scans):
    xyz, valid = scans[0][0]
    jvalid, jxyz, jg, js, lab_j, pick_j = jax.jit(_jax_frontend)(
        jnp.asarray(xyz), jnp.asarray(valid))
    ti = tproject(torch.from_numpy(xyz), torch.from_numpy(valid), TCFG, None)
    assert ti.rng.shape == (64, 1800)
    np.testing.assert_array_equal(ti.valid.numpy(), np.asarray(jvalid))
    np.testing.assert_array_equal(ti.xyz.numpy(), np.asarray(jxyz))
    assert ti.valid.numpy().sum() > 50000

    tp, _, tg, ts = tsegment_scan(ti, TCFG)
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    for f in ("labels", "cluster_good", "outlier"):
        np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                      np.asarray(getattr(js, f)), err_msg=f)
    assert ts.cluster_good.numpy().sum() > 5000

    lab_t, pick_t = tfeat.label_features(tp, TCFG)
    np.testing.assert_array_equal(lab_t.numpy(), np.asarray(lab_j))
    np.testing.assert_array_equal(pick_t.numpy(), np.asarray(pick_j))
    assert (lab_t.numpy() == 2).sum() > 20 and (lab_t.numpy() == -1).sum() > 20


def test_process_scan_matches_jax(scans):
    data, poses = scans
    jpipe, tpipe = JaxPipeline(JCFG), LegoLoamPipeline(TCFG, "cpu")
    for k, (xyz, valid) in enumerate(data):
        jr = jpipe.process_scan(xyz, valid, None, t=0.1 * k)
        tr = tpipe.process_scan(xyz, valid, None, t=0.1 * k)
        assert tr.stats == jr.stats
        assert tr.stats["n_sharp"] > 20
        assert (tr.mapped_pose is None) == (jr.mapped_pose is None)
        np.testing.assert_allclose(tr.fused_pose.t.numpy(),
                                   np.asarray(jr.fused_pose.t), atol=POS_TOL)
        assert _rot_err_deg(np.asarray(jr.fused_pose.R),
                            tr.fused_pose.R.numpy()) < ROT_TOL_DEG
    R0, t0 = poses[0]
    err = np.linalg.norm(R0 @ tpipe.trajectory[-1] + t0 - poses[-1][1])
    assert err < 0.2
