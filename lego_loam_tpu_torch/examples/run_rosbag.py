"""Replay a ROS1 bag through the pipeline — the reference's primary workflow
(`rosbag play *.bag --topic /velodyne_points /imu/data`, reference:
README.md:98-113) without ROS (the port's counterpart of
examples/run_rosbag.py).

Usage:
  python -m lego_loam_tpu_torch.examples.run_rosbag --bag data.bag [--imu] \
      [--loop] [--frames N] [--sensor vlp16] [--out traj.txt] \
      [--export-dir DIR] [--cpu]

IMU messages (if --imu and the topic exists) feed odometry seeding, de-skew,
and the mapping attitude blend, exactly like the reference's optional 9-DOF
input.  --out writes the fused trajectory in TUM's format; --export-dir
writes the reference's shutdown artifacts (cornerMap/surfaceMap/trajectory/
finalCloud .pcd, mapOptmization.cpp:731-755).
"""

from __future__ import annotations

import argparse
from typing import Iterator

import numpy as np

from lego_loam_tpu_torch.config import PipelineConfig, config_for
from lego_loam_tpu_torch.examples import require_device
from lego_loam_tpu_torch.io.kitti import pad_scan
from lego_loam_tpu_torch.io.rosbag import BagSource, quat_to_mat
from lego_loam_tpu_torch.models.pipeline import LegoLoamPipeline

CLOUD_TOPIC = "/velodyne_points"
IMU_TOPIC = "/imu/data"


def make_config(sensor: str = "vlp16", loop: bool = False) -> PipelineConfig:
    return config_for(sensor, loop_closure_enabled=loop)


def decode_bag(path: str, cfg: PipelineConfig, cloud_topic: str = CLOUD_TOPIC,
               imu_topic: str = IMU_TOPIC) -> Iterator[tuple]:
    """A bag's messages in file order, decoded for the pipeline:
    ("imu", (t, attitude (3, 3), body specific force, body angular rate))
    as push_imu takes them, and ("scan", (xyz, valid, ring, t)) with the
    cloud through pad_scan and its ring channel padded alike (None for a
    cloud without one).  A cloud without a ring channel on a sensor that
    needs one ends the run (SystemExit)."""
    for kind, msg in BagSource(path, cloud_topic, imu_topic):
        if kind == "imu":
            yield "imu", (msg["t"], quat_to_mat(msg["quat"]),
                          np.asarray(msg["acc"], np.float32),
                          np.asarray(msg["gyro"], np.float32))
            continue
        xyz, valid = pad_scan(msg["xyz"], cfg)
        cap = xyz.shape[0]
        ring = msg["ring"]
        if ring is not None:
            ring_p = np.zeros(cap, np.int32)
            ring_p[: min(len(ring), cap)] = ring[:cap]
            ring = ring_p
        elif cfg.sensor.use_ring:
            raise SystemExit(
                f"bag cloud has no ring channel; use an elevation-math "
                f"preset (--sensor hdl64e style), not {cfg.sensor.name}")
        yield "scan", (xyz, valid, ring, msg["t"])


def run(bag: str, cfg: PipelineConfig | None = None, imu: bool = False,
        frames: int | None = None, out: str | None = None,
        export_dir: str | None = None, cloud_topic: str = CLOUD_TOPIC,
        imu_topic: str = IMU_TOPIC, device="cuda", log=print) -> dict:
    """Replay the bag's clouds through process_scan, pushing its IMU
    messages first if `imu`; write the TUM trajectory to `out` and the PCD
    artifacts to `export_dir`.  Returns the stamps, the fused trajectory
    (N, 3), the counts and the files written."""
    dev = require_device(device)
    cfg = cfg or make_config()
    pipe = LegoLoamPipeline(cfg, dev)
    stamps, n = [], 0
    for kind, item in decode_bag(bag, cfg, cloud_topic, imu_topic):
        if kind == "imu":
            if imu:
                pipe.push_imu(*item)
            continue
        xyz, valid, ring, t = item
        res = pipe.process_scan(xyz, valid, ring, t=t)
        stamps.append(t)
        n += 1
        if n % 50 == 0:
            log(f"scan {n}  pos={pipe.trajectory[-1].round(2)}  "
                f"{res.wall_ms:.0f} ms  "
                f"kf={int(pipe.mstate.n_kf)}")
        if frames and n >= frames:
            break

    n_kf, n_loops = int(pipe.mstate.n_kf), int(pipe.mstate.n_loops)
    log(f"replayed {n} scans, {n_kf} keyframes, {n_loops} loop closures")

    traj = pipe.trajectory_numpy()
    if out:
        with open(out, "w") as f:
            for t, p in zip(stamps, traj):
                f.write(f"{t:.6f} {p[0]:.6f} {p[1]:.6f} {p[2]:.6f} "
                        "0 0 0 1\n")
        log(f"wrote {out}")

    written = {}
    if export_dir:
        from lego_loam_tpu_torch.io.pcd import export_maps

        written = export_maps(pipe, export_dir)
        for path, count in written.items():
            log(f"wrote {path} ({count} pts)")
    return {"stamps": stamps, "trajectory": traj, "n_scans": n, "n_kf": n_kf,
            "n_loops": n_loops, "written": written, "pipeline": pipe}


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--bag", required=True)
    ap.add_argument("--cloud-topic", default=CLOUD_TOPIC)
    ap.add_argument("--imu-topic", default=IMU_TOPIC)
    ap.add_argument("--imu", action="store_true",
                    help="use IMU messages (ignored if the topic is absent)")
    ap.add_argument("--sensor", default="vlp16")
    ap.add_argument("--frames", type=int, default=None)
    ap.add_argument("--loop", action="store_true")
    ap.add_argument("--export-dir", default=None,
                    help="write PCD map/trajectory artifacts at the end")
    ap.add_argument("--out", default=None, help="write TUM-format trajectory")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    return run(args.bag, make_config(args.sensor, args.loop), args.imu,
               args.frames, args.out, args.export_dir, args.cloud_topic,
               args.imu_topic, "cpu" if args.cpu else "cuda")


if __name__ == "__main__":
    main()
