"""IMU slice parity: both LegoLoamPipelines (JAX package and PyTorch port,
CPU) fed the same scans and the same IMU stream through push_imu, fused
poses compared scan by scan; and the checkpoint handed across between the
two packages in both directions.

  * tests/test_imu.py's config and course (deskew=False, 8 scans of a
    circle arc, 6 IMU samples a scan covering its sweep), so the JAX side
    runs the programs tests/test_imu.py compiles: the odometry seed, the
    attitude fold and the mapping solve's roll / pitch blend;
  * 4 scans of bench.py's fast-yaw course (tests/torch_courses.py) with
    deskew=True at the same capacities: the per-point IMU de-skew too.

Tolerance: 1 cm and 0.1 deg on every fused pose, the packed stats equal,
the bound tests/test_torch_pipeline.py states for the plain slice (float32
rounding carried through the pose chain; the IMU functions alone agree to
~1e-6, tests/test_torch_imu.py).  The 8-scan course holds it running
free.  The de-skew course cannot: with deskew=True the scan-to-scan
motion estimate has an undamped mode in both packages (the error of one
scan's estimate comes back, sign flipped, in the next: ROADMAP C8), so
float32 rounding is carried instead of damped, and the port running free
lands 3.36, 2.91 and 10.74 mm / 0.0176, 0.0282 and 0.0319 deg from the
JAX package on scans 1-3 (on a CPU; `python -m
tests.deskew_trio --gaps`).  So each scan there starts from the JAX
pipeline's own state, handed across through the checkpoint (0.00, 3.36,
3.22 and 3.95 mm / 0.0176 deg at most), while the stats of the two
free-running pipelines must still be equal.

Checkpoints: the JAX pipeline saves after 4 scans, the port loads the file
(every leaf must come out bit-equal when the port writes it back) and
both run 3 more scans, within the same bound; then the port saves and the
JAX package loads.  A config with other shapes raises in the port as it
does in the JAX package.
"""

import numpy as np
import pytest
import torch

from lego_loam_tpu import config_for as jconfig_for
from lego_loam_tpu.io import checkpoint as jckpt
from lego_loam_tpu.models.pipeline import LegoLoamPipeline as JaxPipeline
from lego_loam_tpu_torch import config_for
from lego_loam_tpu_torch.io import checkpoint as tckpt
from lego_loam_tpu_torch.io import synthetic as syn
from lego_loam_tpu_torch.models.imu import GRAVITY
from lego_loam_tpu_torch.models.pipeline import LegoLoamPipeline

from tests.test_torch_backend import _rot_err_deg
from tests.torch_courses import fast_yaw_course, fast_yaw_imu, yaw_R

# tests/test_imu.py::test_pipeline_with_imu's config
IMU = dict(deskew=False, max_keyframes=64, max_map_corner=2048, max_map_surf=8192,
           kf_corner_cap=256, kf_surf_cap=1024, kf_outlier_cap=256,
           max_scan_corner_ds=256, max_scan_surf_ds=1024, nn_query_tile=256)
JCFG, TCFG = jconfig_for("vlp16", **IMU), config_for("vlp16", **IMU)
POS_TOL, ROT_TOL_DEG = 1e-2, 0.1
N_SCANS, CKPT_AT, N_AFTER = 8, 4, 3
DESKEW_SCANS = 4


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Several workers share the host; one torch thread each (as
    tests/test_torch_hdl64e.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def imu_course():
    """tests/test_imu.py's course: (scans, stamps, IMU samples a scan)."""
    dt, arc, radius = TCFG.sensor.scan_period, 0.25 * np.pi, 8.0
    world = syn.default_world(seed=4)
    poses = syn.circle_trajectory(N_SCANS, radius=radius, arc=arc)
    yaw_rate = arc / ((N_SCANS - 1) * dt)
    speed = yaw_rate * radius
    scans, imu = [], []
    for k, (R, t) in enumerate(poses):
        scans.append(syn.raycast(world, R, t, TCFG.sensor, noise=0.01,
                                 rng=np.random.default_rng(k)))
        samples = []
        for j in range(6):     # the whole sweep [t_k, t_k + dt]
            ti = k * dt + j * dt / 5
            yaw = yaw_rate * ti
            acc_w = np.array([-speed * yaw_rate * np.sin(yaw),
                              speed * yaw_rate * np.cos(yaw), 0.0])
            Ri = yaw_R(yaw)
            samples.append((ti, Ri, Ri.T @ (acc_w + np.array([0.0, 0.0, GRAVITY])),
                            np.array([0.0, 0.0, yaw_rate])))
        imu.append(samples)
    return scans, [k * dt for k in range(N_SCANS)], imu


def step(pipe, scan, t, samples):
    for s in samples:
        pipe.push_imu(*s)
    return pipe.process_scan(*scan, t=t)


def pose_of(res):
    return np.asarray(res.fused_pose.R), np.asarray(res.fused_pose.t), res.stats


def assert_close(jrow, trow, where):
    (jR, jt, jstats), (tR, tt, tstats) = jrow, trow
    assert tstats == jstats, where
    np.testing.assert_allclose(tt, jt, atol=POS_TOL, err_msg=where)
    assert _rot_err_deg(jR, tR) < ROT_TOL_DEG, where


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both pipelines over the 8-scan IMU course, each saving a checkpoint
    after CKPT_AT scans; every scan's fused pose and stats kept."""
    scans, stamps, imu = imu_course()
    d = tmp_path_factory.mktemp("ckpt")
    paths = {"jax": str(d / "jax.npz"), "port": str(d / "port.npz")}
    jpipe, tpipe = JaxPipeline(JCFG), LegoLoamPipeline(TCFG, "cpu")
    rows = {"jax": [], "port": []}
    for k in range(N_SCANS):
        rows["jax"].append(pose_of(step(jpipe, scans[k], stamps[k], imu[k])))
        rows["port"].append(pose_of(step(tpipe, scans[k], stamps[k], imu[k])))
        if k == CKPT_AT - 1:
            jckpt.save_checkpoint(jpipe, paths["jax"])
            tckpt.save_checkpoint(tpipe, paths["port"])
    assert tpipe.imu_host.count == jpipe.imu_host.count == 6 * N_SCANS
    return dict(scans=scans, stamps=stamps, imu=imu, rows=rows, paths=paths,
                dir=d, n_kf=(int(jpipe.mstate.n_kf), int(tpipe.mstate.n_kf)))


def test_imu_slice_matches_jax_pipeline(runs):
    for k, (jrow, trow) in enumerate(zip(runs["rows"]["jax"], runs["rows"]["port"])):
        assert_close(jrow, trow, f"scan {k}")
    assert runs["n_kf"][0] == runs["n_kf"][1]


def test_deskew_imu_slice_matches_jax_pipeline(tmp_path):
    """The fast-yaw course's motion-distorted sweeps with de-skew on and
    the IMU pushed: seed, per-point de-skew, fold and blend.  Both
    pipelines run free with equal stats on every scan; each fused pose is
    held to the bound from the JAX pipeline's own state before that scan
    (handed to a port pipeline through the checkpoint)."""
    jcfg, tcfg = JCFG.replace(deskew=True), TCFG.replace(deskew=True)
    _, scans, stamps = fast_yaw_course(tcfg.sensor, DESKEW_SCANS)
    jpipe, tpipe = JaxPipeline(jcfg), LegoLoamPipeline(tcfg, "cpu")
    path = str(tmp_path / "before.npz")
    for k in range(DESKEW_SCANS):
        samples = fast_yaw_imu(k, tcfg.sensor.scan_period)
        jckpt.save_checkpoint(jpipe, path)
        same = LegoLoamPipeline(tcfg, "cpu")
        tckpt.load_checkpoint(same, path)
        jrow = pose_of(step(jpipe, scans[k], stamps[k], samples))
        assert pose_of(step(tpipe, scans[k], stamps[k], samples))[2] == jrow[2]
        assert_close(jrow, pose_of(step(same, scans[k], stamps[k], samples)),
                     f"scan {k} from the JAX state")


def _leaves(path):
    data = np.load(path)
    n = len([k for k in data.files if k.startswith("leaf_")])
    return [data[f"leaf_{i}"] for i in range(n)], data["trajectory"]


def _continue(pipe, runs):
    return [pose_of(step(pipe, runs["scans"][k], runs["stamps"][k], runs["imu"][k]))
            for k in range(CKPT_AT, CKPT_AT + N_AFTER)]


def test_checkpoint_from_jax_to_port(runs):
    pipe = LegoLoamPipeline(TCFG, "cpu")
    tckpt.load_checkpoint(pipe, runs["paths"]["jax"])
    assert pipe.frame == CKPT_AT and pipe.imu_used
    assert pipe.n_kf_bound == int(pipe.mstate.n_kf)
    # written back by the port, every leaf is the JAX package's, bit for bit
    again = str(runs["dir"] / "jax_through_port.npz")
    tckpt.save_checkpoint(pipe, again)
    (a, ta), (b, tb) = _leaves(runs["paths"]["jax"]), _leaves(again)
    assert len(a) == len(b)
    for i, (x, y) in enumerate(zip(a, b)):
        assert x.dtype == y.dtype and x.shape == y.shape, i
        assert np.array_equal(x, y), i
    assert np.array_equal(ta, tb)
    for k, (jrow, trow) in enumerate(zip(runs["rows"]["jax"][CKPT_AT:], _continue(pipe, runs))):
        assert_close(jrow, trow, f"scan {CKPT_AT + k}")


def test_checkpoint_from_port_to_jax(runs):
    pipe = JaxPipeline(JCFG)
    jckpt.load_checkpoint(pipe, runs["paths"]["port"])
    assert pipe.frame == CKPT_AT and pipe.imu_used
    for k, (trow, jrow) in enumerate(zip(runs["rows"]["port"][CKPT_AT:], _continue(pipe, runs))):
        assert_close(jrow, trow, f"scan {CKPT_AT + k}")


def test_checkpoint_config_mismatch_raises(runs):
    other = LegoLoamPipeline(TCFG.replace(max_keyframes=32), "cpu")
    with pytest.raises(ValueError, match="checkpoint shape"):
        tckpt.load_checkpoint(other, runs["paths"]["jax"])
    jother = JaxPipeline(JCFG.replace(max_keyframes=32))
    with pytest.raises(ValueError, match="checkpoint shape"):
        jckpt.load_checkpoint(jother, runs["paths"]["port"])
