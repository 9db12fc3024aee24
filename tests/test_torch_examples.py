"""The port's user entry points (lego_loam_tpu_torch/examples/) on the CPU,
at small capacities:

  * run_synthetic over 4 frames: poses bit-equal to the same
    LegoLoamPipeline driven directly (tests/test_torch_pipeline.py holds
    that pipeline to the JAX package's), its ATE the JAX package's
    ate_rmse of those arrays;
  * run_rosbag on a 3-scan bag of the fast-yaw course with its IMU stream:
    the trajectory bit-equal to the JAX script's replay loop written out
    here, its TUM file and PCD artifacts;
  * run_kitti on a 3-scan HDL-64E sequence directory: per scan and in
    chunks of 2 (the ragged tail per scan) within 1e-5 m / 1e-4 deg, the
    trajectory file, ATE / RPE against the poses file;
  * each main() parses the JAX script's own flags, maps --cpu to the CPU,
    and without a card and without --cpu exits non-zero (the soak's too;
    its run is tests/test_torch_soak.py's).

torch runs on one thread (the workers share the host).
"""

from __future__ import annotations

import ast
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from lego_loam_tpu.utils.metrics import ate_rmse as jax_ate_rmse
from lego_loam_tpu_torch import config_for
from lego_loam_tpu_torch.examples import run_kitti, run_rosbag, run_synthetic, soak
from lego_loam_tpu_torch.io import synthetic as syn
from lego_loam_tpu_torch.io.kitti import pad_scan
from lego_loam_tpu_torch.io.pcd import load_pcd
from lego_loam_tpu_torch.io.rosbag import BagSource, quat_to_mat
from lego_loam_tpu_torch.models.pipeline import LegoLoamPipeline
from tests.test_torch_backend import _rot_err_deg
from tests.test_torch_sensor_rows import mid_row
from tests.torch_courses import (SMALL, fast_yaw_course, fast_yaw_imu,
                                 write_imu_bag, write_kitti_sequence)

REPO = Path(__file__).resolve().parent.parent
EXAMPLES = REPO / "examples"
# run_synthetic's config at SMALL's capacities
SYN_CFG = config_for("vlp16", **dict(SMALL, loop_min_time_gap=5.0))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _quiet(*_):
    pass


# ---------------------------------------------------------------- run_synthetic

def test_run_synthetic_equals_a_direct_drive(tmp_path):
    frames = 4
    out = run_synthetic.run(SYN_CFG, frames, out=str(tmp_path / "maps"),
                            device="cpu", log=_quiet)
    # the same course through the pipeline, written out from the JAX script
    world = syn.default_world(seed=1)
    arc = min(0.6 * (frames - 1) / 10.0, 1.9 * np.pi)
    poses = syn.circle_trajectory(frames, radius=10.0, arc=arc)
    pipe = LegoLoamPipeline(SYN_CFG, "cpu", loop_check_every=5)
    for k, (R, t) in enumerate(poses):
        xyz, valid, ring = syn.raycast(world, R, t, SYN_CFG.sensor, noise=0.02,
                                       rng=np.random.default_rng(k))
        pipe.process_scan(xyz, valid, ring, t=k * SYN_CFG.sensor.scan_period)
    R0, t0 = poses[0]
    est = np.array([R0 @ p.astype(np.float64) + t0 for p in pipe.trajectory])
    np.testing.assert_array_equal(out["pipeline"].trajectory_numpy(),
                                  pipe.trajectory_numpy())
    np.testing.assert_array_equal(out["est"], est)
    np.testing.assert_array_equal(out["gt"], np.array([t for _, t in poses]))
    assert out["ate_m"] == jax_ate_rmse(out["est"], out["gt"])
    assert out["ate_m"] < 0.15
    assert out["n_kf"] == int(pipe.mstate.n_kf) and out["n_loops"] == 0
    # --out: the four PCD artifacts, the trajectory as the keyframe poses
    assert len(out["written"]) == 4
    np.testing.assert_array_equal(
        load_pcd(str(tmp_path / "maps" / "trajectory.pcd")), pipe.keyframe_poses())


def test_run_synthetic_imu_samples():
    """--imu: six samples a scan at 50 Hz over the sweep, the circle's yaw
    rate, gravity from the port's models/imu.GRAVITY along the body z."""
    frames, dt = 30, 0.1
    _, arc = run_synthetic.course(frames)
    s = run_synthetic.imu_samples(2, frames, arc, dt)
    rate = arc / ((frames - 1) * dt)
    assert [round(x[0], 9) for x in s] == [round(0.2 + j * 0.02, 9) for j in range(6)]
    for t, R, acc, gyro in s:
        np.testing.assert_allclose(R[:2, :2], [[np.cos(rate * t), -np.sin(rate * t)],
                                               [np.sin(rate * t), np.cos(rate * t)]],
                                   atol=1e-6)
        np.testing.assert_allclose(gyro, [0.0, 0.0, rate])
        assert acc[2] == pytest.approx(9.81)
        assert np.linalg.norm(acc[:2]) == pytest.approx(10.0 * rate ** 2, rel=1e-6)


# ---------------------------------------------------------------- run_rosbag

@pytest.fixture(scope="module")
def bag(tmp_path_factory):
    """3 swept scans of the fast-yaw course with their IMU stream, as a bag."""
    cfg = config_for("vlp16", **dict(SMALL, deskew=True))
    _, scans, stamps = fast_yaw_course(cfg.sensor, 3)
    imu = [fast_yaw_imu(k, cfg.sensor.scan_period) for k in range(3)]
    path = str(tmp_path_factory.mktemp("bag") / "course.bag")
    write_imu_bag(path, scans, stamps, imu, cfg.sensor.scan_period)
    return cfg, path, stamps


def _replay(cfg, path, imu):
    """examples/run_rosbag.py's replay loop (:76-95), written out."""
    pipe = LegoLoamPipeline(cfg, "cpu")
    for kind, msg in BagSource(path):
        if kind == "imu":
            if imu:
                pipe.push_imu(msg["t"], quat_to_mat(msg["quat"]),
                              np.asarray(msg["acc"], np.float32),
                              np.asarray(msg["gyro"], np.float32))
            continue
        xyz, valid = pad_scan(msg["xyz"], cfg)
        ring = np.zeros(xyz.shape[0], np.int32)
        ring[:min(len(msg["ring"]), len(ring))] = msg["ring"][:len(ring)]
        pipe.process_scan(xyz, valid, ring, t=msg["t"])
    return pipe.trajectory_numpy()


def test_run_rosbag_equals_the_replay_loop(bag, tmp_path):
    cfg, path, stamps = bag
    tum, maps = str(tmp_path / "traj.txt"), str(tmp_path / "maps")
    out = run_rosbag.run(path, cfg, imu=True, out=tum, export_dir=maps,
                         device="cpu", log=_quiet)
    np.testing.assert_array_equal(out["trajectory"], _replay(cfg, path, True))
    assert out["n_scans"] == 3 and out["stamps"] == pytest.approx(stamps)
    rows = np.loadtxt(tum)
    assert rows.shape == (3, 8)
    np.testing.assert_allclose(rows[:, 1:4], out["trajectory"], atol=1e-6)
    np.testing.assert_array_equal(rows[:, 4:], [[0, 0, 0, 1]] * 3)
    assert sorted(os.path.basename(p) for p in out["written"]) == [
        "cornerMap.pcd", "finalCloud.pcd", "surfaceMap.pcd", "trajectory.pcd"]


def test_decode_bag_events(bag):
    """decode_bag: the IMU samples and the padded scans of the bag in file
    order; --frames stops the replay; a ring sensor's cloud without a ring
    channel ends the run."""
    cfg, path, stamps = bag
    events = list(run_rosbag.decode_bag(path, cfg))
    kinds = [k for k, _ in events]
    assert kinds.count("scan") == 3 and kinds.count("imu") == 30
    scans = [item for k, item in events if k == "scan"]
    assert [s[3] for s in scans] == pytest.approx(stamps)
    for xyz, valid, ring, _ in scans:
        assert xyz.shape == (max(cfg.sensor.n_scan * cfg.sensor.horizon_scan, 1 << 17), 3)
        assert ring.dtype == np.int32 and ring.shape == valid.shape
        assert not ring[~valid].any()
    out = run_rosbag.run(path, cfg, frames=1, device="cpu", log=_quiet)
    assert out["n_scans"] == 1


# ---------------------------------------------------------------- run_kitti

@pytest.fixture(scope="module")
def kitti_seq(tmp_path_factory):
    """3 HDL-64E scans of tests/test_hdl64e.py's course (each point moved
    into the middle of its elevation row) as a KITTI sequence; SMALL's
    capacities and a quarter of run_kitti's feature caps (at the preset's
    the odometry's CPU 5-NN takes ~13 s a scan on one thread)."""
    cfg = config_for("hdl64e", **dict(SMALL, max_less_flat=2048, max_less_sharp=1024,
                                      max_sharp=256, max_flat=512, max_outlier=1024))
    poses = syn.circle_trajectory(3, radius=8.0, arc=0.06 * np.pi)
    world = syn.default_world(seed=9)
    scans = []
    for k, (R, t) in enumerate(poses):
        xyz, valid, ring = syn.raycast(world, R, t, cfg.sensor, noise=0.02,
                                       rng=np.random.default_rng(k))
        scans.append((mid_row(xyz, cfg.sensor), valid, ring))
    root = str(tmp_path_factory.mktemp("kitti"))
    return cfg, root, write_kitti_sequence(root, scans, poses)


def test_run_kitti_per_scan_and_chunked(kitti_seq, tmp_path):
    cfg, root, poses = kitti_seq
    traj = str(tmp_path / "traj.txt")
    a = run_kitti.run(root, cfg, poses=poses, out=traj, device="cpu", log=_quiet)
    b = run_kitti.run(root, cfg, poses=poses, chunk=2, device="cpu", log=_quiet)
    assert a["t"].shape == b["t"].shape == (3, 3)
    np.testing.assert_allclose(b["t"], a["t"], atol=1e-5)
    for Ra, Rb in zip(a["R"], b["R"]):
        assert _rot_err_deg(Ra, Rb) < 1e-4
    rows = np.loadtxt(traj).reshape(3, 3, 4)
    np.testing.assert_allclose(rows[:, :, :3], a["R"], atol=1e-8)
    np.testing.assert_allclose(rows[:, :, 3], a["t"], atol=1e-8)
    # the ground truth anchored at its first pose: the course's own motion
    assert a["rpe_delta"] == 2
    assert a["ate_m"] < 0.1 and a["rpe_m"] < 0.1 and np.isfinite(a["rpe_rad"])
    assert b["ate_m"] == pytest.approx(a["ate_m"], abs=1e-5)


# ---------------------------------------------------------------- flags

def _jax_flags(name) -> dict:
    """examples/<name>.py's argparse flags: option -> (default, type, action)."""
    tree = ast.parse((EXAMPLES / f"{name}.py").read_text())
    out = {}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "add_argument"):
            kw = {k.arg: k.value for k in node.keywords}
            default = ast.literal_eval(kw["default"]) if "default" in kw else None
            typ = kw["type"].id if "type" in kw else None
            action = ast.literal_eval(kw["action"]) if "action" in kw else None
            out[node.args[0].value] = (default, typ, action)
    return out


@pytest.mark.parametrize("mod", [run_synthetic, run_kitti, run_rosbag])
def test_main_parses_the_scripts_flags(mod, monkeypatch):
    name = mod.__name__.rsplit(".", 1)[1]
    want = _jax_flags(name)
    required = [f for f in ("--seq", "--bag") if f in want]
    argv = [x for f in required for x in (f, "x")]
    import argparse

    seen = {}
    orig = argparse.ArgumentParser.parse_args

    def grab(self, args=None, namespace=None):
        seen["parser"] = self
        return orig(self, args, namespace)
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", grab)
    mod.parse_args(argv)
    got = {}
    for act in seen["parser"]._actions:
        if not act.option_strings or act.option_strings[0] == "-h":
            continue
        action = "store_true" if isinstance(act, argparse._StoreTrueAction) else None
        typ = act.type.__name__ if act.type is not None else None
        got[act.option_strings[0]] = (None if action else act.default, typ, action)
    want = {k: (None if a else d, t, a) for k, (d, t, a) in want.items()}
    assert got == want

    # --cpu runs the script's config on the CPU; without it, the card
    calls = []
    monkeypatch.setattr(mod, "run", lambda *a, **kw: calls.append((a, kw)))
    mod.main(argv + ["--cpu"])
    mod.main(argv)
    (a_cpu, _), (a_card, _) = calls
    assert a_cpu[-1] == "cpu" and a_card[-1] == "cuda"
    cfg = [x for x in a_cpu if hasattr(x, "max_keyframes")][0]
    assert cfg == (mod.make_config() if mod is not run_synthetic
                   else run_synthetic.make_config("vlp16", False))


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
@pytest.mark.parametrize("mod,argv", [
    (run_synthetic, ["--frames", "1"]), (run_kitti, ["--seq", "nowhere"]),
    (run_rosbag, ["--bag", "nowhere"]), (soak, ["1", "4"])])
def test_no_card_without_cpu_exits(mod, argv):
    """Without a card and without --cpu a runner stops with a message
    before any work: no fallback to the CPU."""
    with pytest.raises(SystemExit) as e:
        mod.main(argv)
    assert e.value.code != 0 and "--cpu" in str(e.value.code)
