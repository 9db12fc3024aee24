"""End-to-end demo: full SLAM on a synthetic world, with ATE report (the
port's counterpart of examples/run_synthetic.py).

Usage:  python -m lego_loam_tpu_torch.examples.run_synthetic [--frames N]
        [--loop] [--imu] [--sensor vlp16] [--out DIR] [--cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from lego_loam_tpu_torch.config import PipelineConfig, config_for
from lego_loam_tpu_torch.examples import require_device
from lego_loam_tpu_torch.io import synthetic as syn
from lego_loam_tpu_torch.models import imu as imu_mod
from lego_loam_tpu_torch.models.pipeline import LegoLoamPipeline
from lego_loam_tpu_torch.utils.math3d import euler_to_mat
from lego_loam_tpu_torch.utils.metrics import ate_rmse

LOOP_CHECK_EVERY = 5
IMU_PER_SCAN = 6


def make_config(sensor: str = "vlp16", loop: bool = False) -> PipelineConfig:
    """The script's config: no de-skew (the raycaster casts each scan from
    one pose), a pool of 256 keyframes, a 5 s loop gap."""
    return config_for(sensor, deskew=False, max_keyframes=256,
                      loop_closure_enabled=loop, loop_min_time_gap=5.0)


def course(frames: int):
    """(poses, arc): ~0.6 m a scan (a brisk 6 m/s at 10 Hz) along a 10 m
    circle, whatever the frame count."""
    arc = min(0.6 * (frames - 1) / 10.0, 1.9 * np.pi)
    return syn.circle_trajectory(frames, radius=10.0, arc=arc), arc


def imu_samples(k: int, frames: int, arc: float, scan_dt: float) -> list:
    """The IMU_PER_SCAN samples pushed before scan k: the circle's yaw and
    centripetal acceleration, plus gravity (the port's imu.GRAVITY), as
    (t, attitude, body specific force, body angular rate)."""
    yaw_rate = arc / ((frames - 1) * scan_dt)
    speed = yaw_rate * 10.0
    out = []
    for j in range(IMU_PER_SCAN):
        ti = k * scan_dt + j * scan_dt / 5
        yaw = yaw_rate * ti
        Ri = euler_to_mat(*torch.tensor([0.0, 0.0, yaw])).numpy()
        acc_w = np.array([-speed * yaw_rate * np.sin(yaw),
                          speed * yaw_rate * np.cos(yaw), 0.0])
        g = np.array([0.0, 0.0, imu_mod.GRAVITY])
        out.append((ti, Ri, Ri.T @ (acc_w + g), np.array([0.0, 0.0, yaw_rate])))
    return out


def run(cfg: PipelineConfig | None = None, frames: int = 30, imu: bool = False,
        out: str | None = None, device="cuda", log=print) -> dict:
    """Drive LegoLoamPipeline over the course's scans (world seed 1, 2 cm
    noise, scan k from seed k), with the IMU stream if `imu`; print a line
    a frame and the ATE through `log`.  Returns the estimated and true
    positions, the ATE, keyframes, loop closures and the exported files."""
    dev = require_device(device)
    cfg = cfg or make_config()
    world = syn.default_world(seed=1)
    poses, arc = course(frames)
    pipe = LegoLoamPipeline(cfg, dev, loop_check_every=LOOP_CHECK_EVERY)
    scan_dt = cfg.sensor.scan_period
    R0, t0 = poses[0]
    est, gt, loops = [], [], []
    for k, (R, t) in enumerate(poses):
        if imu:
            for sample in imu_samples(k, frames, arc, scan_dt):
                pipe.push_imu(*sample)
        xyz, valid, ring = syn.raycast(world, R, t, cfg.sensor, noise=0.02,
                                       rng=np.random.default_rng(k))
        res = pipe.process_scan(xyz, valid, ring, t=k * scan_dt)
        # the scan's host copy of its fused translation
        tw = R0 @ pipe.trajectory[-1].astype(np.float64) + t0
        est.append(tw)
        gt.append(t)
        loops.append(bool(res.loop_closed))
        flag = " LOOP" if res.loop_closed else ""
        log(f"frame {k:3d}: pos=({tw[0]:7.2f},{tw[1]:7.2f},{tw[2]:6.2f}) "
            f"err={np.linalg.norm(tw - t) * 100:6.1f}cm "
            f"{res.wall_ms:6.1f}ms "
            f"sharp={res.stats.get('n_sharp', '-'):>4}{flag}")
    est, gt = np.array(est), np.array(gt)
    ate = ate_rmse(est, gt)
    n_kf, n_loops = int(pipe.mstate.n_kf), int(pipe.mstate.n_loops)
    log(f"\nATE RMSE (aligned): {ate:.3f} m over {frames} frames, {n_kf} "
        f"keyframes, {n_loops} loop closures")
    written = {}
    if out:
        from lego_loam_tpu_torch.io.pcd import export_maps

        written = export_maps(pipe, out)
        for p, n in written.items():
            log(f"wrote {p} ({n} pts)")
    return {"est": est, "gt": gt, "ate_m": ate, "n_kf": n_kf,
            "n_loops": n_loops, "loop_closed": loops, "written": written,
            "pipeline": pipe}


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=30)
    ap.add_argument("--sensor", default="vlp16")
    ap.add_argument("--loop", action="store_true", help="enable loop closure")
    ap.add_argument("--imu", action="store_true", help="feed a synthetic IMU")
    ap.add_argument("--out", default=None, help="export PCD maps here")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    return run(make_config(args.sensor, args.loop), args.frames, args.imu,
               args.out, "cpu" if args.cpu else "cuda")


if __name__ == "__main__":
    main()
