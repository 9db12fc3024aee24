"""Loop-closure parity: lego_loam_tpu_torch.ops.icp and models/loop.py
against the JAX package's ops/icp.py and models/loop.py, CPU, on the
inputs of tests/test_posegraph.py (its CFG, so the JAX side reuses the
programs that file compiles).

Tolerances:
  * icp_align on test_icp_known_transform's cloud: T within 1 mm / 0.01 deg
    of the JAX package's (the port's rigid fit is Horn's quaternion form,
    the JAX package's an SVD: the same optimum).  Fitness within 1e-3
    relative or 1e-6 absolute: both runs converge to the exact transform,
    where the fitness is float32 rounding of |q|^2 + |r|^2 - 2 q.r at
    |q|^2 up to 75 m^2 (a few 1e-6 a pair); measured 7.71e-7 against
    6.57e-7, a gap of 1.1e-7 (17 % relative).
  * plane_information: within 1e-4 of the largest entry.
  * loop_closure_step on test_loop_closure_step_end_to_end's keyframe
    pool: the same closed and candidate, fitness and drift within 1e-3
    relative, every keyframe pose and aft_mapped within 1 cm / 0.1 deg,
    the same n_loops and loop-edge slots.  obs_ratio within 1e-2
    relative: measured 0.106912 against 0.106484 (4.0e-3).  The ICP poses
    agree to float32 rounding and the 5-NN sets are the same; the gap is
    eigvalsh3's trigonometric formula on near-collinear 5-NN sets (largest
    eigenvalue ~1 m^2, the two others ~1e-4), where float32 keeps only
    ~1e-4 of the small ones and XLA and torch round it differently: a few
    matched points get normals that differ in the third digit, and a
    surface gate lam1 > 4 lam0 can flip.  The gate this ratio feeds
    (loop_degen_eig_frac = 0.02) sits 5x below it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lego_loam_tpu.io import synthetic as jsyn
from lego_loam_tpu.models import loop as jlc
from lego_loam_tpu.models import mapping as jmp
from lego_loam_tpu.ops import icp as jicp
from lego_loam_tpu.ops.compaction import segment_scan
from lego_loam_tpu.ops.features import extract_features
from lego_loam_tpu.ops.projection import project_scan
from lego_loam_tpu.ops.voxel import voxel_downsample
from lego_loam_tpu.utils.math3d import Pose as JPose
from lego_loam_tpu.utils.math3d import euler_to_mat
from lego_loam_tpu_torch import config_for
from lego_loam_tpu_torch.models import loop as tlc
from lego_loam_tpu_torch.ops import icp as ticp
from lego_loam_tpu_torch.ops import knn
from lego_loam_tpu_torch.utils.convert import state_from_numpy, state_to_numpy
from lego_loam_tpu_torch.utils.math3d import Pose

from tests.test_posegraph import CFG as JCFG
from tests.test_torch_backend import _rot_err_deg

TCFG = config_for("vlp16", **{
    k: getattr(JCFG, k) for k in (
        "deskew", "max_keyframes", "max_map_corner", "max_map_surf",
        "kf_corner_cap", "kf_surf_cap", "kf_outlier_cap", "max_scan_corner_ds",
        "max_scan_surf_ds", "nn_query_tile", "max_loop_edges", "pg_gn_iters")})
POS_TOL, ROT_TOL_DEG = 1e-2, 0.1


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The suite runs several workers at once; one torch thread keeps this
    module from oversubscribing the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _known_transform_cloud():
    """test_icp_known_transform's inputs: 400 uniform points and the same
    points seen from a frame offset by (R, t)."""
    rng = np.random.default_rng(0)
    dst = rng.uniform(-5, 5, (400, 3)).astype(np.float32)
    R = np.asarray(euler_to_mat(jnp.float32(0.02), jnp.float32(-0.03), jnp.float32(0.1)))
    t = np.array([0.3, -0.2, 0.1], np.float32)
    return ((dst - t) @ R).astype(np.float32), dst, R, t


def test_icp_align_matches_jax():
    src, dst, R, t = _known_transform_cloud()
    ones = np.ones(400, bool)
    jT, jfit = jax.device_get(jicp.icp_align(
        jnp.asarray(src), jnp.asarray(ones), jnp.asarray(dst), jnp.asarray(ones),
        JPose.identity(), iters=30, max_corr_dist=5.0))
    launches = knn.knn.launches
    tT, tfit = ticp.icp_align(torch.from_numpy(src), torch.from_numpy(ones),
                              torch.from_numpy(dst), torch.from_numpy(ones),
                              Pose.identity(), iters=30, max_corr_dist=5.0)
    assert knn.knn.launches == launches          # CPU: the plain k-NN
    np.testing.assert_allclose(tT.t.numpy(), jT.t, rtol=0, atol=1e-3)
    assert _rot_err_deg(jT.R, tT.R.numpy()) < 0.01
    np.testing.assert_allclose(float(tfit), float(jfit), rtol=1e-3, atol=1e-6)
    # both found the transform (test_icp_known_transform's bounds)
    np.testing.assert_allclose(tT.t.numpy(), t, atol=0.02)
    assert float(tfit) < 1e-3


def test_kabsch_takes_a_proper_rotation_on_reflected_data():
    """A mirrored cloud: the best proper rotation, not the reflection
    (the JAX package's SVD sign fix), as the JAX _kabsch gives it."""
    rng = np.random.default_rng(5)
    src = rng.standard_normal((50, 3)).astype(np.float32)
    dst = src * np.array([1.0, 1.0, -1.0], np.float32)
    w = np.ones(50, np.float32)
    jT = jax.device_get(jicp._kabsch(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(w)))
    tT = ticp._kabsch(torch.from_numpy(src), torch.from_numpy(dst), torch.from_numpy(w))
    assert abs(np.linalg.det(tT.R.numpy()) - 1.0) < 1e-5
    S = (src - src.mean(0)).T @ (dst - dst.mean(0))
    assert np.trace(tT.R.numpy() @ S) >= np.trace(np.asarray(jT.R) @ S) - 1e-3
    # nothing matched: the identity
    z = ticp._kabsch(torch.from_numpy(src), torch.from_numpy(dst), torch.zeros(50))
    np.testing.assert_array_equal(z.R.numpy(), np.eye(3, dtype=np.float32))


def test_kabsch_takes_a_proper_rotation_on_collinear_data():
    """Collinear matches leave the spin about their line free (a double top
    eigenvalue of Horn's matrix): the fit is still a proper rotation, maps
    the line as the true motion does, and scores tr(R S) as high as the
    JAX package's SVD."""
    rng = np.random.default_rng(7)
    u = np.array([0.6, 0.0, 0.8], np.float32)
    src = (rng.uniform(-3, 3, (40, 1)) * u).astype(np.float32)
    R0 = np.asarray(euler_to_mat(jnp.float32(0.1), jnp.float32(-0.2), jnp.float32(0.3)))
    dst = (src @ R0.T + np.array([0.5, -0.1, 0.2], np.float32)).astype(np.float32)
    w = np.ones(40, np.float32)
    jT = jax.device_get(jicp._kabsch(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(w)))
    R = ticp._kabsch(torch.from_numpy(src), torch.from_numpy(dst),
                     torch.from_numpy(w)).R.numpy()
    np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-5)
    assert abs(np.linalg.det(R) - 1.0) < 1e-5
    np.testing.assert_allclose(R @ u, R0 @ u, atol=1e-4)
    S = (src - src.mean(0)).T @ (dst - dst.mean(0))
    assert np.trace(R @ S) >= np.trace(np.asarray(jT.R) @ S) - 1e-3


def test_plane_information_matches_jax():
    src, dst, _, _ = _known_transform_cloud()
    rng = np.random.default_rng(1)
    match = rng.random(400) > 0.1
    valid = rng.random(400) > 0.05
    jH = np.asarray(jicp.plane_information(
        jnp.asarray(src), jnp.asarray(match), jnp.asarray(dst), jnp.asarray(valid)))
    tH = ticp.plane_information(torch.from_numpy(src), torch.from_numpy(match),
                                torch.from_numpy(dst), torch.from_numpy(valid)).numpy()
    np.testing.assert_allclose(tH, jH, rtol=0, atol=1e-4 * np.abs(jH).max())
    assert np.abs(jH).max() > 1.0


@pytest.fixture(scope="module")
def pool():
    """test_loop_closure_step_end_to_end's keyframe pool (12 raycast
    scans out and back, drift injected) as host arrays, and its config."""
    world = jsyn.default_world(seed=6)
    n = 12
    ts = [np.array([0.4 * i, 0.0, 1.6]) for i in range(n // 2)]
    ts += [np.array([0.4 * (n // 2 - 1 - i), 0.05, 1.6]) for i in range(n // 2)]
    state = jax.device_get(jmp.init_state(JCFG))
    kf_R, kf_t = state.kf_R.copy(), state.kf_t.copy()
    kc, kcv = state.kf_corner.copy(), state.kf_corner_valid.copy()
    ks, ksv = state.kf_surf.copy(), state.kf_surf_valid.copy()
    times = np.zeros(JCFG.max_keyframes, np.float32)
    drift = np.array([0.02, 0.03, 0.0])
    for i, t in enumerate(ts):
        xyz, valid, ring = jsyn.raycast(world, np.eye(3), t, JCFG.sensor,
                                        noise=0.01, rng=np.random.default_rng(i))
        img = project_scan(jnp.asarray(xyz), jnp.asarray(valid), JCFG, jnp.asarray(ring))
        packed, o_rel, _, _ = segment_scan(img, JCFG)
        f = extract_features(packed, o_rel, JCFG)
        cp, cok = voxel_downsample(f.less_sharp.xyz, f.less_sharp.valid,
                                   JCFG.leaf_scan_corner, JCFG.kf_corner_cap)
        sp, sok = voxel_downsample(f.less_flat.xyz, f.less_flat.valid,
                                   JCFG.leaf_scan_surf, JCFG.kf_surf_cap)
        kf_R[i] = np.eye(3)
        kf_t[i] = (t - np.array([0.0, 0.0, 1.6])) + i * drift
        kc[i], kcv[i] = np.asarray(cp), np.asarray(cok)
        ks[i], ksv[i] = np.asarray(sp), np.asarray(sok)
        times[i] = 40.0 * i / n
    meas_R, meas_t = state.kf_meas_R.copy(), state.kf_meas_t.copy()
    for i in range(1, n):
        meas_R[i] = kf_R[i - 1].T @ kf_R[i]
        meas_t[i] = kf_R[i - 1].T @ (kf_t[i] - kf_t[i - 1])
    state = state._replace(
        kf_R=kf_R, kf_t=kf_t, kf_meas_R=meas_R, kf_meas_t=meas_t,
        kf_corner=kc, kf_corner_valid=kcv, kf_surf=ks, kf_surf_valid=ksv,
        kf_time=times, n_kf=np.int32(n),
        aft_mapped=JPose(kf_R[n - 1], kf_t[n - 1]))
    return state, n


def test_loop_closure_step_matches_jax(pool):
    st, n = pool
    jcfg = JCFG.replace(pg_trans_sigma=0.05, pg_rot_sigma=0.005)
    tcfg = TCFG.replace(pg_trans_sigma=0.05, pg_rot_sigma=0.005)
    # loop_closure_step donates its state: hand it a device copy
    jst, jres = jax.device_get(jlc.loop_closure_step(
        jax.device_put(st), jnp.float32(40.0), jcfg))
    tst, tres = tlc.loop_closure_step(state_from_numpy(st, "cpu"), 40.0, tcfg)
    tres = state_to_numpy(tres)

    assert bool(jres.closed) and bool(tres.closed) == bool(jres.closed)
    assert int(tres.candidate) == int(jres.candidate)
    for f, rtol in (("fitness", 1e-3), ("drift", 1e-3), ("obs_ratio", 1e-2)):
        np.testing.assert_allclose(getattr(tres, f), getattr(jres, f), rtol=rtol,
                                   err_msg=f)
    assert int(tst.n_loops) == int(jst.n_loops) == 1
    for f in ("loop_i", "loop_j"):
        np.testing.assert_array_equal(getattr(tst, f).numpy(), getattr(jst, f), err_msg=f)
    np.testing.assert_allclose(tst.loop_t.numpy(), jst.loop_t, atol=POS_TOL)
    np.testing.assert_allclose(tst.loop_w.numpy(), jst.loop_w, rtol=1e-3)
    np.testing.assert_allclose(tst.kf_t.numpy(), jst.kf_t, rtol=0, atol=POS_TOL)
    for k in range(n):
        assert _rot_err_deg(jst.kf_R[k], tst.kf_R[k].numpy()) < ROT_TOL_DEG, k
    np.testing.assert_allclose(tst.aft_mapped.t.numpy(), jst.aft_mapped.t, atol=POS_TOL)
    assert _rot_err_deg(jst.aft_mapped.R, tst.aft_mapped.R.numpy()) < ROT_TOL_DEG
    # the correction itself (test_loop_closure_step_end_to_end's bound)
    true_last = np.array([0.0, 0.05, 0.0])
    assert (np.linalg.norm(tst.kf_t[n - 1].numpy() - true_last)
            < 0.5 * np.linalg.norm(st.kf_t[n - 1] - true_last))


def test_no_candidate_leaves_the_pool_unchanged(pool):
    """Too early for a revisit (every keyframe inside the time gap): no
    loop, and the pose-level state comes back as it went in."""
    st, n = pool
    tst, tres = tlc.loop_closure_step(state_from_numpy(st, "cpu"), 7.0, TCFG)
    assert not bool(tres.closed) and int(tst.n_loops) == 0
    for f in ("kf_R", "kf_t", "loop_i", "loop_j", "loop_R", "loop_t", "loop_w"):
        np.testing.assert_array_equal(getattr(tst, f).numpy(), getattr(st, f), err_msg=f)
    np.testing.assert_array_equal(tst.aft_mapped.t.numpy(), st.aft_mapped.t)
