"""Back-end parity: odometry_step and mapping_step (with scan_to_map and the
5-NN) of the PyTorch port against the JAX package, each started from the
exact state the JAX package reached (carried across by utils/convert.py),
on seeded synthetic VLP-16 scans; plus the short keyframe block that the
JAX package cannot insert (ROADMAP C1).

Tolerance for poses: 5 mm and 0.05 deg.  The 5-point plane fits solve
A n = -1 through normal equations that are ill-conditioned for points
metres away (column x ~ constant), and XLA's CPU kernels contract products
into FMAs where torch's do not; individual plane normals therefore differ
in the last float32 digits amplified by the conditioning, which moves the
converged pose by up to ~1.5 mm / 0.02 deg per solve.  Discrete outputs
(validity masks, keyframe counts) match exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lego_loam_tpu import config_for as jconfig_for
from lego_loam_tpu.io import synthetic as syn
from lego_loam_tpu.models import mapping as jmap
from lego_loam_tpu.models import odometry as jodo
from lego_loam_tpu.ops.compaction import segment_scan
from lego_loam_tpu.ops.features import extract_features
from lego_loam_tpu.ops.projection import project_scan
from lego_loam_tpu_torch import config_for
from lego_loam_tpu_torch.models import mapping as tmap
from lego_loam_tpu_torch.models import odometry as todo
from lego_loam_tpu_torch.ops.voxel import voxel_downsample
from lego_loam_tpu_torch.utils.convert import state_from_numpy, state_to_numpy

from tests.torch_courses import SMALL

JCFG = jconfig_for("vlp16", **SMALL)
TCFG = config_for("vlp16", **SMALL)
POS_TOL, ROT_TOL_DEG = 5e-3, 0.05


def _rot_err_deg(Ra, Rb):
    d = np.asarray(Ra, np.float64).T @ np.asarray(Rb, np.float64)
    s = 0.5 * np.linalg.norm([d[2, 1] - d[1, 2], d[0, 2] - d[2, 0], d[1, 0] - d[0, 1]])
    return np.degrees(np.arcsin(min(s, 1.0)))


def _assert_pose_close(jp, tp):
    np.testing.assert_allclose(tp.t.numpy(), np.asarray(jp.t), atol=POS_TOL)
    assert _rot_err_deg(np.asarray(jp.R), tp.R.numpy()) < ROT_TOL_DEG


@pytest.fixture(scope="module")
def run():
    """JAX front-end + odometry over scans 0-2 and the first mapping solve;
    returns host copies of every state the tests start from."""
    world = syn.default_world(seed=4)
    poses = syn.circle_trajectory(12, radius=8.0, arc=0.35 * np.pi)
    ostate, mstate = jodo.init_state(JCFG), jmap.init_state(JCFG)
    out = {"ostates": [], "feats": [], "poses": []}
    for k in range(3):
        R, t = poses[k]
        xyz, valid, ring = syn.raycast(world, R, t, JCFG.sensor, noise=0.01,
                                       rng=np.random.default_rng(k))
        img = project_scan(jnp.asarray(xyz), jnp.asarray(valid), JCFG,
                           jnp.asarray(ring))
        packed, o_rel, _, _ = segment_scan(img, JCFG)
        feats = extract_features(packed, o_rel, JCFG)
        out["ostates"].append(jax.device_get(ostate))
        out["feats"].append(jax.device_get(feats))
        ostate, opose, _ = jodo.odometry_step(ostate, feats, JCFG)
        out["poses"].append(jax.device_get(opose))
        out.setdefault("after", []).append(jax.device_get(ostate))
        if k == 0:
            mfeats = feats._replace(less_sharp=ostate.ref_corner,
                                    less_flat=ostate.ref_surf)
            mstate, _ = jmap.mapping_step(mstate, mfeats, opose,
                                          jnp.float32(0.0), JCFG)
            out["mstate1"] = jax.device_get(mstate)
    return out


def test_convert_roundtrip(run):
    st = state_from_numpy(run["mstate1"], "cpu")
    assert isinstance(st, tmap.MappingState)
    assert st.map_age == 0 and st.map_stale is False
    back = state_to_numpy(st)
    for a, b in zip(jax.tree_util.tree_leaves(run["mstate1"]),
                    jax.tree_util.tree_leaves(tuple(back))):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))


@pytest.mark.parametrize("k", [1, 2])
def test_odometry_step(run, k):
    jstate, jfeats = run["ostates"][k], run["feats"][k]
    jnew, jpose, jrel = jax.device_get(jodo.odometry_step(jstate, jfeats, JCFG))
    tnew, tpose, trel = todo.odometry_step(state_from_numpy(jstate, "cpu"),
                                           state_from_numpy(jfeats, "cpu"), TCFG)
    _assert_pose_close(jrel, trel)
    _assert_pose_close(jpose, tpose)
    for cloud in ("ref_corner", "ref_surf"):
        jc, tc = getattr(jnew, cloud), getattr(tnew, cloud)
        np.testing.assert_array_equal(tc.valid.numpy(), jc.valid)
        # reference clouds are warped by rel: pose tolerance x ~10 m lever
        np.testing.assert_allclose(tc.xyz.numpy(), jc.xyz, atol=2e-2)


@pytest.fixture(scope="module")
def solve(run):
    """The JAX package's second mapping solve (scan 2) against the pool
    holding scan 0's keyframe; map_stale forces the local-map gather so the
    solve registers (scan_to_map + the corner / surf 5-NN + line / plane
    fits).  Returns (pool before, mapping feats, odometry pose, result)."""
    m1 = run["mstate1"]._replace(map_stale=np.bool_(True))
    after, feats, opose = run["after"][2], run["feats"][2], run["poses"][2]
    mfeats = feats._replace(less_sharp=after.ref_corner, less_flat=after.ref_surf)
    res = jax.device_get(jmap.mapping_step(
        jax.device_put(m1), jax.device_put(mfeats), jax.device_put(opose),
        jnp.float32(0.2), JCFG))
    return m1, mfeats, opose, res


def test_mapping_step(solve):
    m1, mfeats, opose, (jm, jT) = solve
    tm, tT = tmap.mapping_step(state_from_numpy(m1, "cpu"),
                               state_from_numpy(mfeats, "cpu"),
                               state_from_numpy(opose, "cpu"), 0.2, TCFG)
    _assert_pose_close(jT, tT)
    assert int(tm.n_kf) == int(jm.n_kf) == 2
    assert tm.map_age == int(jm.map_age) and tm.map_stale == bool(jm.map_stale)
    np.testing.assert_array_equal(tm.map_corner_valid.numpy(), jm.map_corner_valid)
    np.testing.assert_array_equal(tm.map_surf_valid.numpy(), jm.map_surf_valid)
    np.testing.assert_allclose(tm.map_surf.numpy(), jm.map_surf, atol=1e-4)
    n = int(jm.n_kf)
    np.testing.assert_allclose(tm.kf_t[:n].numpy(), jm.kf_t[:n], atol=POS_TOL)
    for f in ("kf_corner_valid", "kf_surf_valid", "kf_outlier_valid"):
        np.testing.assert_array_equal(getattr(tm, f)[:n].numpy(), getattr(jm, f)[:n])
    # the solve really registered against a populated map
    assert jm.map_surf_valid.sum() > 1000 and jm.map_corner_valid.sum() > 10


def test_scan_to_map(solve):
    """scan_to_map alone, from the predicted pose against the gathered local
    map, lands where the JAX package's solve landed."""
    m1, mfeats, opose, (jm, jT) = solve
    st = state_from_numpy(m1, "cpu")
    f = state_from_numpy(mfeats, "cpu")
    T0 = tmap.predict_pose(st, state_from_numpy(opose, "cpu"))
    maps = tmap._gather_local_map(st, T0.t, TCFG)
    cp, cok = voxel_downsample(f.less_sharp.xyz, f.less_sharp.valid,
                               TCFG.leaf_scan_corner, TCFG.max_scan_corner_ds)
    sp, sok = voxel_downsample(torch.cat([f.less_flat.xyz, f.outlier.xyz]),
                               torch.cat([f.less_flat.valid, f.outlier.valid]),
                               TCFG.leaf_scan_surf, TCFG.max_scan_surf_ds)
    tT, tn = tmap.scan_to_map(T0, cp, cok, sp, sok, *maps, TCFG)
    _assert_pose_close(jT, tT)
    assert int(tn) >= TCFG.map_min_constraints
    # the solve moved the pose off the prediction (the map constrains it)
    assert float((tT.t - T0.t).norm()) > 1e-4


def test_short_keyframe_block_is_padded(run):
    """ROADMAP C1: with max_scan_surf_ds < kf_surf_cap the JAX package's
    insertion slices a short block into a longer slot and fails to trace;
    the port pads the block with invalid rows."""
    kw = dict(SMALL, max_scan_surf_ds=1024)
    jcfg, tcfg = jconfig_for("vlp16", **kw), config_for("vlp16", **kw)
    after, feats, opose = run["after"][0], run["feats"][0], run["poses"][0]
    jfeats = feats._replace(less_sharp=after.ref_corner, less_flat=after.ref_surf)
    with pytest.raises((TypeError, ValueError)):
        jmap.mapping_step(jmap.init_state(jcfg), jax.device_put(jfeats),
                          jax.device_put(opose), jnp.float32(0.0), jcfg)
    tm, _ = tmap.mapping_step(tmap.init_state(tcfg, "cpu"),
                              state_from_numpy(jfeats, "cpu"),
                              state_from_numpy(opose, "cpu"), 0.0, tcfg)
    assert int(tm.n_kf) == 1
    block, ok = tm.kf_surf[0].numpy(), tm.kf_surf_valid[0].numpy()
    assert block.shape == (tcfg.kf_surf_cap, 3)
    assert ok[:1024].sum() > 100 and not ok[1024:].any()
    assert not block[1024:].any()


def _compact_fixture():
    """A small pool at capacity (K = 8, n_kf = 7) with three loop edges,
    filled from a seed, as host arrays in the JAX package's MappingState."""
    kw = dict(SMALL, max_keyframes=8, max_loop_edges=4)
    jcfg, tcfg = jconfig_for("vlp16", **kw), config_for("vlp16", **kw)
    rng = np.random.default_rng(2)
    st = jax.device_get(jmap.init_state(jcfg))
    K = jcfg.max_keyframes
    q, _ = np.linalg.qr(rng.standard_normal((K, 3, 3)))
    q *= np.sign(np.linalg.det(q))[:, None, None]
    st = st._replace(
        kf_R=q.astype(np.float32),
        kf_t=rng.standard_normal((K, 3)).astype(np.float32),
        kf_surf_valid=rng.random(st.kf_surf_valid.shape) > 0.5,
        kf_time=np.arange(K, dtype=np.float32),
        n_kf=np.int32(K - 1),
        loop_i=np.array([6, 5, 4, 0], np.int32),
        loop_j=np.array([1, 2, 0, 0], np.int32),
        loop_w=np.array([1.0, 2.0, 3.0, 0.0], np.float32),
        n_loops=np.int32(3))
    return jcfg, tcfg, st


def test_compact_keyframes():
    """Pool thinning against the JAX package's compact_keyframes: keyframe
    order, remapped loop edges and chain measurements."""
    jcfg, tcfg, st = _compact_fixture()
    jc = jax.device_get(jmap.compact_keyframes(jax.device_put(st), jcfg))
    tc = tmap.compact_keyframes(state_from_numpy(st, "cpu"), tcfg)
    assert int(tc.n_kf) == int(jc.n_kf) == 6 and int(tc.n_loops) == int(jc.n_loops)
    for f in ("kf_R", "kf_t", "kf_surf_valid", "kf_time", "loop_i", "loop_j",
              "loop_w"):
        np.testing.assert_array_equal(getattr(tc, f).numpy(), getattr(jc, f), err_msg=f)
    np.testing.assert_allclose(tc.kf_meas_R.numpy(), jc.kf_meas_R, atol=1e-5)
    np.testing.assert_allclose(tc.kf_meas_t.numpy(), jc.kf_meas_t, atol=1e-5)
    assert tc.map_stale is True


def test_pipeline_compacts_only_at_capacity():
    """The host bound on n_kf triggers one device read at capacity; the
    pool is thinned only if the device count is really there."""
    from lego_loam_tpu_torch.models.pipeline import LegoLoamPipeline

    jcfg, tcfg, st = _compact_fixture()
    pipe = LegoLoamPipeline(tcfg, "cpu")
    pipe.mstate = state_from_numpy(st._replace(n_kf=np.int32(4)), "cpu")
    pipe.n_kf_bound = tcfg.max_keyframes - 1
    pipe._maybe_compact()
    assert pipe.n_kf_bound == 4 and int(pipe.mstate.n_kf) == 4
    pipe.mstate = state_from_numpy(st, "cpu")
    pipe.n_kf_bound = tcfg.max_keyframes - 1
    pipe._maybe_compact()
    assert pipe.n_kf_bound == 6 and int(pipe.mstate.n_kf) == 6
