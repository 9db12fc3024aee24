"""Front-end parity: the PyTorch port against the JAX package, stage by
stage, on the same seeded synthetic VLP-16 scan (CPU; the port's kernel
wrappers run their plain versions on CPU tensors).

Tolerances: integer and boolean grids (validity, ground, component labels,
cluster masks, compaction order, feature labels, picks) match EXACTLY --
both sides evaluate the same float32 elementwise formulas, and on this scan
no pixel sits on a 1-ulp edge of a threshold.  Ranges agree to 1e-6
relative: sqrt(x^2+y^2+z^2) rounds once differently when XLA fuses it.
Voxel centroids agree to 1e-5 relative: both sum a voxel's points in
float32, in different orders.
"""

from functools import partial

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lego_loam_tpu import config_for as jconfig_for
from lego_loam_tpu.io import synthetic as syn
from lego_loam_tpu.ops import features as jfeat
from lego_loam_tpu.ops import features_pallas
from lego_loam_tpu.ops import voxel as jvox
from lego_loam_tpu.ops.compaction import segment_scan as jsegment_scan
from lego_loam_tpu.ops.ground import mark_ground as jmark_ground
from lego_loam_tpu.ops.projection import project_scan as jproject
from lego_loam_tpu.ops.segmentation import build_edges as jbuild_edges
from lego_loam_tpu.ops.segmentation import label_components as jlabel
from lego_loam_tpu.ops.segmentation_pallas import propagate_labels_pallas
from lego_loam_tpu.types import SegmentedScan as JSegmentedScan
from lego_loam_tpu_torch import config_for
from lego_loam_tpu_torch.ops import features as tfeat
from lego_loam_tpu_torch.ops import segmentation as tseg
from lego_loam_tpu_torch.ops import voxel as tvox
from lego_loam_tpu_torch.ops.compaction import segment_scan as tsegment_scan
from lego_loam_tpu_torch.ops.projection import project_scan as tproject
from lego_loam_tpu_torch.types import SegmentedScan

from tests.test_torch_feature_rows import built_rows, packed_from, random_rows

JCFG = jconfig_for("vlp16")
TCFG = config_for("vlp16")


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def scan():
    world = syn.default_world(seed=3)
    return syn.raycast(world, np.eye(3), np.array([1.0, -2.0, 1.6]),
                       JCFG.sensor, noise=0.01, rng=np.random.default_rng(11))


@pytest.fixture(scope="module")
def imgs(scan):
    xyz, valid, ring = scan
    ji = jproject(jnp.asarray(xyz), jnp.asarray(valid), JCFG, jnp.asarray(ring))
    ti = tproject(_t(xyz), _t(valid), TCFG, _t(ring))
    return ji, ti


@pytest.fixture(scope="module")
def segmented(imgs):
    ji, ti = imgs
    return jsegment_scan(ji, JCFG), tsegment_scan(ti, TCFG)


def test_projection(imgs):
    ji, ti = imgs
    np.testing.assert_array_equal(_np(ti.valid), _np(ji.valid))
    np.testing.assert_array_equal(_np(ti.xyz), _np(ji.xyz))
    np.testing.assert_allclose(_np(ti.rng), _np(ji.rng), rtol=1e-6)
    for f in ("start_orientation", "end_orientation", "orientation_diff"):
        np.testing.assert_allclose(_np(getattr(ti, f)), _np(getattr(ji, f)),
                                   rtol=1e-6)
    assert _np(ti.valid).sum() > 10000


def test_ground_and_segmentation(imgs, segmented):
    (jp, jo, jg, js), (tp, to, tg, ts) = segmented
    np.testing.assert_array_equal(_np(tg), _np(jg))
    for f in ("labels", "cluster_good", "outlier"):
        np.testing.assert_array_equal(_np(getattr(ts, f)), _np(getattr(js, f)))
    assert _np(ts.cluster_good).sum() > 1000


def test_label_propagation_plain_vs_xla_and_pallas(imgs):
    """The plain label loop against the XLA loop and the Pallas kernel in
    interpret mode (called as tests/test_frontend.py calls it)."""
    ji, ti = imgs
    ground = jmark_ground(ji, JCFG)
    edges = jbuild_edges(ji, ground, JCFG)
    seg_xla = jlabel(ji, ground, JCFG, edges=edges)
    seg, edge_h, edge_v = edges
    R, H = seg.shape
    labels0 = jnp.where(seg, jnp.arange(R * H, dtype=jnp.int32).reshape(R, H),
                        jnp.int32(R * H))
    conn_left = jnp.roll(edge_h, 1, axis=1)
    conn_up = jnp.concatenate([jnp.zeros((1, H), bool), edge_v[:-1]], axis=0)
    lab_pallas = propagate_labels_pallas(
        labels0, conn_left, edge_h, conn_up, edge_v,
        JCFG.label_prop_max_sweeps, interpret=True)

    args = tseg.label_inputs(_t(seg), _t(edge_h), _t(edge_v))
    np.testing.assert_array_equal(_np(args[0]), _np(labels0))
    launches = tseg.propagate_labels.launches
    lab = tseg.propagate_labels(*args, TCFG.label_prop_max_sweeps)
    assert tseg.propagate_labels.launches == launches      # CPU: plain path
    np.testing.assert_array_equal(_np(lab), _np(lab_pallas))
    np.testing.assert_array_equal(np.where(_np(seg), _np(lab), -1),
                                  _np(seg_xla.labels))
    # the fixpoint: every segmentable pixel holds its component's min index
    assert (_np(lab)[_np(seg)] <= np.arange(R * H).reshape(R, H)[_np(seg)]).all()


def test_compaction(segmented):
    (jp, jo, jg, js), (tp, to, tg, ts) = segmented
    for f in SegmentedScan._fields:
        a, b = _np(getattr(jp, f)), _np(getattr(tp, f))
        if f == "rng":
            np.testing.assert_allclose(b, a, rtol=1e-6)
        else:
            np.testing.assert_array_equal(b, a, err_msg=f)
    np.testing.assert_array_equal(_np(to), _np(jo))


@pytest.mark.parametrize("out_cap,use_cls", [(4096, False), (300, True)])
def test_voxel_downsample(out_cap, use_cls):
    """Voxel identity and drop order bit for bit (out_cap=300 truncates, so
    the hash order decides which voxels survive); centroids to 1e-5."""
    rng = np.random.default_rng(out_cap)
    xyz = (rng.standard_normal((3000, 3)) * 4.0).astype(np.float32)
    valid = rng.random(3000) > 0.1
    aux = rng.random((3000, 2)).astype(np.float32)
    cls = rng.random(3000) > 0.5 if use_cls else None
    ja = jvox.voxel_downsample(jnp.asarray(xyz), jnp.asarray(valid), 0.7,
                               out_cap, aux=jnp.asarray(aux),
                               cls=None if cls is None else jnp.asarray(cls))
    ta = tvox.voxel_downsample(_t(xyz), _t(valid), 0.7, out_cap, aux=_t(aux),
                               cls=None if cls is None else _t(cls))
    np.testing.assert_array_equal(_np(ta[2]), _np(ja[2]))
    np.testing.assert_allclose(_np(ta[0]), _np(ja[0]), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(_np(ta[1]), _np(ja[1]), rtol=1e-5, atol=1e-6)
    hj = jvox._voxel_keys(jnp.asarray(xyz), jnp.asarray(valid), 0.7,
                          None if cls is None else jnp.asarray(cls))
    ht = tvox._voxel_keys(_t(xyz), _t(valid), 0.7,
                          None if cls is None else _t(cls))
    for a, b in zip(hj, ht):
        np.testing.assert_array_equal(_np(b), _np(a).astype(np.int64))


def _jax_pallas_labels(packed, monkeypatch):
    monkeypatch.setattr(
        features_pallas, "pick_features_pallas",
        partial(features_pallas.pick_features_pallas.__wrapped__, interpret=True))
    return jfeat.label_features(packed, JCFG.replace(feature_backend="pallas"))


def test_feature_picks_vs_xla_and_pallas(segmented, monkeypatch):
    (jp, jo, jg, js), (tp, to, tg, ts) = segmented
    lab_x, pick_x = jfeat.label_features(jp, JCFG.replace(feature_backend="xla"))
    lab_p, pick_p = _jax_pallas_labels(jp, monkeypatch)
    launches = tfeat.label_features.launches
    lab_t, pick_t = tfeat.label_features(tp, TCFG)
    assert tfeat.label_features.launches == launches        # CPU: plain path
    assert (_np(lab_t) == 2).sum() > 0 and (_np(lab_t) == -1).sum() > 0
    for lab, pick in ((lab_x, pick_x), (lab_p, pick_p)):
        np.testing.assert_array_equal(_np(lab_t), _np(lab))
        np.testing.assert_array_equal(_np(pick_t), _np(pick))


def test_feature_picks_empty_scan(monkeypatch):
    R, W = TCFG.sensor.n_scan, TCFG.sensor.horizon_scan

    def empty(mod, zeros):
        return mod(
            xyz=zeros((R, W, 3), "f"), rng=zeros((R, W), "f"),
            col=zeros((R, W), "i"), row_frac=zeros((R, W), "f"),
            ground=zeros((R, W), "b"), valid=zeros((R, W), "b"),
            count=zeros((R,), "i"), outlier_xyz=zeros((TCFG.max_outlier, 3), "f"),
            outlier_valid=zeros((TCFG.max_outlier,), "b"))

    dt = {"f": np.float32, "i": np.int32, "b": bool}
    jp = empty(JSegmentedScan, lambda s, k: jnp.zeros(s, dt[k]))
    tp = empty(SegmentedScan, lambda s, k: torch.from_numpy(np.zeros(s, dt[k])))
    lab_p, _ = _jax_pallas_labels(jp, monkeypatch)
    lab_t, _ = tfeat.label_features(tp, TCFG)
    assert not _np(lab_t).any()
    np.testing.assert_array_equal(_np(lab_t), _np(lab_p))


@pytest.mark.parametrize("rows", ["built", "random"])
def test_label_features_plain_vs_xla_on_built_rows(segmented, rows):
    """K2's plain version against the JAX package's XLA label step on the
    packed rows of tests/test_torch_feature_rows.py (count < 12, = 12, = W,
    ties, bands across sector boundaries, cut reaches, n_ok 0 / 1 / even /
    odd), at this module's shapes and config, so the JAX side reuses the
    program test_feature_picks_vs_xla_and_pallas compiles."""
    jp = segmented[0][0]
    arrays = (built_rows() if rows == "built" else random_rows(3))
    tp = packed_from(*arrays, max_outlier=TCFG.max_outlier)
    jpk = jp._replace(**{f: jnp.asarray(_np(getattr(tp, f))) for f in (
        "rng", "valid", "col", "ground", "count")})
    assert all(getattr(jpk, f).shape == getattr(jp, f).shape
               and getattr(jpk, f).dtype == getattr(jp, f).dtype
               for f in JSegmentedScan._fields)
    lab_x, pick_x = jfeat.label_features(jpk, JCFG.replace(feature_backend="xla"))
    lab_t, pick_t = tfeat.label_features_plain(tp, TCFG)
    np.testing.assert_array_equal(_np(lab_t), _np(lab_x))
    np.testing.assert_array_equal(_np(pick_t), _np(pick_x))
    assert (_np(lab_t) == 2).any() and (_np(lab_t) == -1).any()


def test_extract_features(segmented):
    (jp, jo, jg, js), (tp, to, tg, ts) = segmented
    jf = jfeat.extract_features(jp, jo, JCFG)
    tf = tfeat.extract_features(tp, to, TCFG)
    for cloud in jf._fields:
        jc, tc = getattr(jf, cloud), getattr(tf, cloud)
        np.testing.assert_array_equal(_np(tc.valid), _np(jc.valid), err_msg=cloud)
        np.testing.assert_array_equal(_np(tc.ring), _np(jc.ring), err_msg=cloud)
        np.testing.assert_array_equal(_np(tc.ground), _np(jc.ground), err_msg=cloud)
        np.testing.assert_allclose(_np(tc.xyz), _np(jc.xyz), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(_np(tc.s), _np(jc.s), rtol=1e-5, atol=1e-6)
    assert _np(tf.less_flat.valid).sum() > 500
