"""IMU path parity: models/imu.py of the PyTorch port against
lego_loam_tpu.models.imu on the same seeded inputs (CPU), float32.

Tolerance: 1e-5 absolute unless a case says otherwise.  Both sides
evaluate the same float32 formulas in the same order; what differs is
XLA's FMA contraction and libm's last ulp in so3_exp / so3_log, a few
1e-7 on unit rotations and velocities.  The host buffers (HostImuBuffer,
NumPy on both sides) must agree exactly.  The buffer's newest index and
count are host ints in the port (device scalars in the JAX package); they
must be equal.

A `cuda`-marked case holds scan_imu, deskew_features and fold_attitude on
CUDA tensors against the same calls on the CPU; it skips without a card.
"""

import numpy as np
import pytest
import torch

from lego_loam_tpu_torch import config_for
from lego_loam_tpu_torch.io import synthetic as syn
from lego_loam_tpu_torch.models import imu as timu
from lego_loam_tpu_torch.models import odometry as todo
from lego_loam_tpu_torch.ops.compaction import segment_scan
from lego_loam_tpu_torch.ops.features import extract_features
from lego_loam_tpu_torch.ops.projection import project_scan
from lego_loam_tpu_torch.utils import math3d as tm
from lego_loam_tpu_torch.utils.convert import state_from_numpy, state_to_numpy

from tests.torch_courses import accel_profile, truth_buffer, yaw_R

try:    # the card's machine has no jax: only the cuda case runs there
    import jax
    import jax.numpy as jnp

    from lego_loam_tpu import config_for as jconfig_for
    from lego_loam_tpu import types as jtypes
    from lego_loam_tpu.models import imu as jimu
    from lego_loam_tpu.models import odometry as jodo
    from lego_loam_tpu.utils import math3d as jm
except ModuleNotFoundError:
    jconfig_for = None

TCFG = config_for("vlp16")
DT = TCFG.sensor.scan_period
ATOL = 1e-5
if jconfig_for is not None:
    JCFG = jconfig_for("vlp16")
    # jitted: one compile each, where the eager JAX ops compile one by one
    j_sample = jax.jit(jimu.imu_sample)
    j_deskew = jax.jit(jimu.deskew_features, static_argnames="cfg")
    j_fold = jax.jit(jimu.fold_attitude, static_argnames="cfg")
    j_blend = jax.jit(jimu.blend_attitude, static_argnames="cfg")
    _JAX_TYPES = {"FeatureCloud": jtypes.FeatureCloud,
                  "ScanFeatures": jtypes.ScanFeatures,
                  "OdometryState": jodo.OdometryState, "ImuBuffer": jimu.ImuBuffer,
                  "Pose": jm.Pose}


def to_jax(x):
    """A port NamedTuple (tensors, or host ints) as the JAX package's type
    of the same name."""
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return _JAX_TYPES[type(x).__name__](*(to_jax(v) for v in x))
    if isinstance(x, (bool, np.bool_)):
        return jnp.bool_(x)
    if isinstance(x, (int, np.integer)):
        return jnp.int32(x)
    return jnp.asarray(x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x))


def to_port(x, device="cpu"):
    """A JAX NamedTuple as the port's type of the same name on `device`."""
    return state_from_numpy(_np_tree(x), device)


def _np_tree(x):
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_np_tree(v) for v in x))
    return np.asarray(x)


def close(j, t, atol=ATOL):
    np.testing.assert_allclose(t.cpu().numpy() if isinstance(t, torch.Tensor) else t,
                               np.asarray(j), atol=atol, rtol=0)


def stream(n=250, seed=0):
    """(t, R, acc_body, gyro) samples: 100 Hz with a gap of exactly one
    scan period every 37th sample and of three every 74th, random yaw
    attitude, specific force near gravity, random rates."""
    rng = np.random.default_rng(seed)
    t, out = 0.0, []
    for i in range(n):
        t += 0.01 if i % 37 else (DT if i % 74 else 3 * DT)
        R = yaw_R(rng.uniform(-3, 3)).astype(np.float32)
        acc = (rng.normal(size=3) + [0.0, 0.0, 9.8]).astype(np.float32)
        out.append((t, R, acc, rng.normal(size=3).astype(np.float32)))
    return out


def jax_buffer(samples):
    buf = jimu.init_buffer()
    for t, R, acc, gyro in samples:
        buf = jimu.imu_push(buf, jnp.float32(t), jnp.asarray(R), jnp.asarray(acc),
                            jnp.asarray(gyro), JCFG)
    return buf


FIELDS = ("time", "att", "velo", "shift", "ang")


def test_push_matches_jax_over_a_wrapping_stream():
    """250 samples (the ring wraps) with gaps of one scan period and more:
    the port's HostImuBuffer and imu_push against the JAX imu_push, and
    the two packages' HostImuBuffers bit for bit."""
    samples = stream()
    jbuf = jax_buffer(samples)
    jhost, thost = jimu.HostImuBuffer(JCFG), timu.HostImuBuffer(TCFG)
    tbuf = timu.init_buffer()
    for k, (t, R, acc, gyro) in enumerate(samples):
        jhost.push(t, R, acc, gyro)
        thost.push(t, R, acc, gyro)
        tbuf = timu.imu_push(tbuf, np.float32(t), R, acc, gyro, TCFG)
    for f in FIELDS:
        assert np.array_equal(getattr(thost, f), getattr(jhost, f)), f
        close(getattr(jbuf, f), getattr(tbuf, f))
        close(getattr(jbuf, f), getattr(thost, f))
    assert thost.ptr == tbuf.ptr == int(jbuf.ptr) == 49
    assert thost.count == tbuf.count == int(jbuf.count) == timu.QUE_LEN
    # the device view of the host buffer holds the same arrays
    dbuf = thost.to_device("cpu")
    for f in FIELDS:
        assert np.array_equal(getattr(dbuf, f).numpy(), getattr(thost, f)), f
    assert (dbuf.ptr, dbuf.count) == (thost.ptr, thost.count)


def _sample_stamps(buf):
    times = np.asarray(buf.time)
    order = (int(buf.ptr) + 1 + np.arange(timu.QUE_LEN)) % timu.QUE_LEN
    live = times[order][np.isfinite(times[order])]
    mid = 0.5 * (live[:-1] + live[1:])
    return {"at samples": live[[0, 1, 17, -2, -1]],
            "between": mid[[0, 20, -1]],
            "before the oldest": live[:1] - np.float32(0.5),
            "after the newest": live[-1:] + np.float32(0.5)}


@pytest.mark.parametrize("n", [40, 250])
@pytest.mark.parametrize("where", ["at samples", "between", "before the oldest",
                                   "after the newest"])
def test_imu_sample_matches_jax(n, where):
    jbuf = jax_buffer(stream(n))
    tbuf = to_port(jbuf)
    stamps = _sample_stamps(jbuf)[where].astype(np.float32)
    for got, want in zip(timu.imu_sample(tbuf, torch.from_numpy(stamps)),
                         j_sample(jbuf, jnp.asarray(stamps))):
        close(want, got)
    # a scalar stamp gives unbatched outputs, as in the JAX package
    for got, want in zip(timu.imu_sample(tbuf, np.float32(stamps[0])),
                         j_sample(jbuf, jnp.float32(stamps[0]))):
        assert got.shape == want.shape
        close(want, got)


def test_imu_sample_on_an_empty_buffer():
    """Every slot -inf: u is NaN until the where clamps it to 1; the
    sample is the identity attitude and zero motion on both sides."""
    jbuf, tbuf = jimu.init_buffer(), timu.init_buffer()
    for got, want in zip(timu.imu_sample(tbuf, torch.tensor([0.0, 3.5])),
                         j_sample(jbuf, jnp.asarray([0.0, 3.5], jnp.float32))):
        assert torch.isfinite(got).all()
        close(want, got)


@pytest.mark.parametrize("filled", [True, False])
def test_scan_imu_and_seed_match_jax(filled):
    jbuf = jax_buffer(stream(60)) if filled else jimu.init_buffer()
    tbuf = to_port(jbuf)
    t_scan = np.float32(0.31)
    js, ts = jimu.scan_imu(jbuf, jnp.float32(t_scan), JCFG), timu.scan_imu(tbuf, t_scan, TCFG)
    assert ts.valid == bool(js.valid) == filled
    for f in ("att_start", "rel_R", "velo_delta"):
        close(getattr(js, f), getattr(ts, f))
    prev = todo.init_state(TCFG, "cpu").rel._replace(t=torch.tensor([0.4, -0.1, 0.02]))
    jseed = jimu.odometry_seed(to_jax(prev), js, DT)
    tseed = timu.odometry_seed(prev, ts, DT)
    close(jseed.R, tseed.R)
    close(jseed.t, tseed.t)


def _swept_features(pose):
    """The port's feature clouds of one VLP-16 sweep cast along `pose`."""
    xyz, valid, ring = syn.raycast_swept_profile(
        syn.default_world(seed=7), pose, TCFG.sensor, noise=0.005,
        rng=np.random.default_rng(1))
    img = project_scan(torch.from_numpy(xyz), torch.from_numpy(valid), TCFG,
                       torch.from_numpy(ring))
    packed, o_rel, _, _ = segment_scan(img, TCFG)
    return extract_features(packed, o_rel, TCFG)


def test_truth_buffer_is_test_imu_deskews():
    """tests/torch_courses.py's jax-free profile and truth buffer are
    tests/test_imu_deskew.py's, bit for bit."""
    from tests import test_imu_deskew as ref

    args = (np.array([0.0, 0.0, 1.6]), np.array([8.0, 0.0, 0.0]),
            np.array([0.0, 8.0, 0.0]), 0.6, 24.0)
    ours = truth_buffer(DT, *accel_profile(*args))
    theirs = ref._truth_buffer(DT, *ref._accel_profile(*args))
    for a, b in zip(ours, theirs):
        assert np.array_equal(np.asarray(a), np.asarray(b))


PROFILES = {  # tests/test_imu_deskew.py's accelerated and constant sweeps
    "accelerated": (np.array([8.0, 0.0, 0.0]), np.array([0.0, 8.0, 0.0]), 0.6, 24.0),
    "constant": (np.array([5.0, 0.5, 0.0]), np.zeros(3), 0.8, 0.0),
}


@pytest.mark.parametrize("profile", PROFILES)
def test_deskew_features_matches_jax(profile):
    """The features of a real swept scan under hard acceleration and
    angular acceleration, and under constant motion, de-skewed with
    tests/test_imu_deskew.py's truth buffers.  Points lie up to ~50 m out,
    where a float32 ulp is 4e-6 m: 2e-5 m."""
    pose, velo, gyro_int = accel_profile(np.array([0.0, 0.0, 1.6]), *PROFILES[profile])
    feats = _swept_features(pose)
    nbuf = truth_buffer(DT, pose, velo, gyro_int)
    tbuf, jbuf = state_from_numpy(nbuf, "cpu"), to_jax(nbuf)
    got = timu.deskew_features(feats, tbuf, np.float32(DT), TCFG)
    want = j_deskew(to_jax(feats), jbuf, jnp.float32(DT), cfg=JCFG)
    moved = 0.0
    for f in ("sharp", "less_sharp", "flat", "less_flat", "outlier"):
        g, w = getattr(got, f), getattr(want, f)
        close(w.xyz, g.xyz, atol=2e-5)
        moved = max(moved, float((g.xyz - getattr(feats, f).xyz).abs().max()))
        # one cloud through _deskew_cloud alone gives the same points
        one = timu._deskew_cloud(getattr(feats, f), tbuf, np.float32(DT), TCFG)
        close(w.xyz, one.xyz, atol=2e-5)
    # hard acceleration moves points by centimetres; constant motion not
    # at all (tests/test_imu_deskew.py's 5 mm)
    assert moved > 0.05 if profile == "accelerated" else moved < 5e-3
    # no usable samples: the features pass through untouched
    same = timu.deskew_features(feats, timu.init_buffer(), np.float32(DT), TCFG)
    assert same is feats


def _fold_run(cfg_kw, drift, R_base=None, R_pose0=None, n=8):
    """fold_attitude over n scans of a stationary platform (ideal AHRS
    `R_base`), with `drift` rad of yaw injected into the pose each scan,
    on both sides from the same start; returns the per-scan states."""
    jcfg, tcfg = JCFG.replace(**cfg_kw), TCFG.replace(**cfg_kw)
    pose, velo, gyro_int = accel_profile(np.zeros(3), np.zeros(3), np.zeros(3),
                                          0.0, 0.0, R_base=R_base)
    tstate = todo.init_state(tcfg, "cpu")
    if R_pose0 is not None:
        tstate = tstate._replace(pose=tstate.pose._replace(
            R=torch.as_tensor(R_pose0, dtype=torch.float32)))
    jstate = to_jax(tstate)
    R_drift = yaw_R(drift).astype(np.float32)
    out = []
    for k in range(n):
        nbuf = truth_buffer(k * DT, pose, velo, gyro_int)
        tstate = tstate._replace(pose=tstate.pose._replace(
            R=tstate.pose.R @ torch.from_numpy(R_drift)))
        jstate = jstate._replace(pose=jstate.pose._replace(
            R=jstate.pose.R @ jnp.asarray(R_drift)))
        tstate = timu.fold_attitude(tstate, state_from_numpy(nbuf, "cpu"),
                                    np.float32(k * DT), tcfg)
        jstate = j_fold(jstate, to_jax(nbuf), jnp.float32(k * DT), cfg=jcfg)
        out.append((jstate, tstate))
    return out


@pytest.mark.parametrize("case", ["drift", "initial attitude", "prior rotation",
                                  "zero weight"])
def test_fold_attitude_matches_jax(case):
    """tests/test_imu_deskew.py's three anchor cases (heading drift pulled
    back; a rotated AHRS at the start; a pose rotated before the IMU turns
    on) and a zero blend weight (the anchor is set, the pose is left)."""
    tilt = np.array([[1, 0, 0], [0, np.cos(0.2), -np.sin(0.2)],
                     [0, np.sin(0.2), np.cos(0.2)]])
    run = {
        "drift": lambda: _fold_run(dict(imu_odom_attitude_blend=0.2), 0.01, n=30),
        "initial attitude": lambda: _fold_run(
            dict(imu_odom_attitude_blend=0.5), 0.0, R_base=yaw_R(1.1) @ tilt),
        "prior rotation": lambda: _fold_run(
            dict(imu_odom_attitude_blend=0.5), 0.0, R_pose0=yaw_R(0.9)),
        "zero weight": lambda: _fold_run(dict(imu_odom_attitude_blend=0.0), 0.01),
    }[case]()
    for jstate, tstate in run:
        close(jstate.pose.R, tstate.pose.R)
        close(jstate.pose.t, tstate.pose.t)
        close(jstate.att_anchor, tstate.att_anchor)
        assert bool(tstate.att_anchor_valid) == bool(jstate.att_anchor_valid)
    if case == "zero weight":
        # the pose keeps every injected drift
        err = float(torch.linalg.vector_norm(tm.so3_log(run[-1][1].pose.R)))
        assert abs(err - 8 * 0.01) < 1e-4


@pytest.mark.parametrize("filled", [True, False])
def test_blend_attitude_matches_jax(filled):
    R = np.asarray(jm.euler_to_mat(jnp.float32(0.1), jnp.float32(-0.05),
                                   jnp.float32(0.7)))
    jT = jm.Pose(jnp.asarray(R), jnp.asarray([1.0, 2.0, 3.0], jnp.float32))
    tT = tm.Pose(torch.from_numpy(R.copy()), torch.tensor([1.0, 2.0, 3.0]))
    jbuf = jax_buffer(stream(60)) if filled else jimu.init_buffer()
    t = np.float32(0.2)
    want = j_blend(jT, jbuf, jnp.float32(t), cfg=JCFG)
    got = timu.blend_attitude(tT, to_port(jbuf), torch.tensor(t), TCFG)
    close(want.R, got.R)
    close(want.t, got.t)


def test_euler_round_trips_match_jax():
    rng = np.random.default_rng(5)
    rpy = [rng.uniform(-np.pi, np.pi, 64).astype(np.float32),
           rng.uniform(-1.5, 1.5, 64).astype(np.float32),
           rng.uniform(-np.pi, np.pi, 64).astype(np.float32)]
    Rj = jm.euler_to_mat(*(jnp.asarray(a) for a in rpy))
    Rt = tm.euler_to_mat(*(torch.from_numpy(a) for a in rpy))
    close(Rj, Rt)
    for a, j, t in zip(rpy, jm.mat_to_euler(Rj), tm.mat_to_euler(Rt)):
        close(j, t)
        close(a, t, atol=1e-4)       # the round trip itself (pitch in +-1.5)
    for axis in ("rot_x", "rot_y", "rot_z"):
        close(getattr(jm, axis)(jnp.asarray(rpy[0])),
              getattr(tm, axis)(torch.from_numpy(rpy[0])))
    # the clip before asin: a pitch of exactly +-90 degrees stays finite
    gimbal = tm.euler_to_mat(torch.tensor(0.3), torch.tensor(np.pi / 2), torch.tensor(0.0))
    assert all(torch.isfinite(x) for x in tm.mat_to_euler(gimbal))


@pytest.mark.cuda
def test_imu_functions_on_the_card_match_the_cpu():
    """scan_imu, deskew_features and fold_attitude on CUDA tensors against
    the same calls on the CPU (the pipeline's buffer: HostImuBuffer's
    upload)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda:0")
    host = timu.HostImuBuffer(TCFG)
    for t, R, acc, gyro in stream(120):
        host.push(t, R, acc, gyro)
    cbuf, gbuf = host.to_device("cpu"), host.to_device(dev)
    t = np.float32(host.time[host.ptr] - 0.12)
    for a, b in zip(timu.scan_imu(cbuf, t, TCFG)[1:], timu.scan_imu(gbuf, t, TCFG)[1:]):
        close(a, b)
    pose, velo, gyro_int = accel_profile(np.array([0.0, 0.0, 1.6]), np.array([8.0, 0, 0]),
                                          np.array([0.0, 8.0, 0.0]), 0.6, 24.0)
    feats = _swept_features(pose)
    tbuf = state_from_numpy(truth_buffer(DT, pose, velo, gyro_int), "cpu")
    got = timu.deskew_features(state_from_numpy(state_to_numpy(feats), dev),
                               state_from_numpy(state_to_numpy(tbuf), dev),
                               np.float32(DT), TCFG)
    want = timu.deskew_features(feats, tbuf, np.float32(DT), TCFG)
    for f in ("sharp", "less_sharp", "flat", "less_flat", "outlier"):
        close(getattr(want, f).xyz, getattr(got, f).xyz, atol=2e-5)
    ostate = todo.init_state(TCFG, "cpu")
    ostate = ostate._replace(pose=ostate.pose._replace(R=torch.from_numpy(
        yaw_R(0.3).astype(np.float32))))
    c, g = ostate, state_from_numpy(state_to_numpy(ostate), dev)
    for k in range(3):
        c = timu.fold_attitude(c, cbuf, t + k * DT, TCFG)
        g = timu.fold_attitude(g, gbuf, t + k * DT, TCFG)
        close(c.pose.R, g.pose.R)
        close(c.att_anchor, g.att_anchor)
