"""Per-scan gaps between the JAX package's and the port's LegoLoamPipeline
on the CPU over tests/test_stress.py's two courses (its config, seeds and
2 cm noise; tests/torch_courses.STRESS, stress_corridor, stress_fast_yaw):
for each scan both fused positions' errors against the truth (lateral y,
vertical z, along x), the gap between the packages, and the odometry and
mapping cadence; at the end each package's test_stress.py measures (the
corridor's largest lateral / vertical / along errors, the fast-yaw ATE and
final error) beside the bounds.  Not collected by pytest: the JAX side
alone takes minutes a course on a CPU.

    JAX_PLATFORMS=cpu python -m tests.stress_gaps [--course corridor|fast_yaw|both]
        [--scans N] [--port-only]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from lego_loam_tpu_torch import config_for
from lego_loam_tpu_torch.models.pipeline import LegoLoamPipeline
from tests.torch_courses import (STRESS, STRESS_ALONG_FRAC, STRESS_LAT,
                                 STRESS_VERT, STRESS_YAW_ATE, STRESS_YAW_FINAL,
                                 stress_corridor, stress_errors, stress_fast_yaw,
                                 stress_scans)

COURSES = {"corridor": stress_corridor, "fast_yaw": stress_fast_yaw}


def run_course(name: str, n: int | None, port_only: bool) -> dict:
    tcfg = config_for("vlp16", **STRESS)
    world, poses = COURSES[name]()
    poses = poses[:n] if n else poses
    scans = stress_scans(world, poses, tcfg.sensor)
    gt = np.asarray([t for (_, t) in poses]) - poses[0][1]
    pipes = {"port": LegoLoamPipeline(tcfg, "cpu")}
    if not port_only:
        from lego_loam_tpu import config_for as jconfig_for
        from lego_loam_tpu.models.pipeline import LegoLoamPipeline as JaxPipeline

        pipes["jax"] = JaxPipeline(jconfig_for("vlp16", **STRESS))
    secs = dict.fromkeys(pipes, 0.0)
    for k, scan in enumerate(scans):
        row = {}
        for tag, pipe in pipes.items():
            t0 = time.perf_counter()
            res = pipe.process_scan(*scan, t=0.1 * k)
            secs[tag] += time.perf_counter() - t0
            row[tag] = (np.asarray(res.fused_pose.t, np.float64), res.mapped_pose is not None,
                        res.stats)
        line = f"{name} scan {k}:"
        for tag, (t, mapped, stats) in row.items():
            e = t - gt[k]
            line += (f" {tag} err x {e[0]:+.4f} y {e[1]:+.4f} z {e[2]:+.4f}"
                     f"{' (mapped)' if mapped else ''};")
        if "jax" in row:
            gap = np.abs(row["port"][0] - row["jax"][0]).max()
            line += f" gap {1e3 * gap:.3f} mm, stats equal {row['port'][2] == row['jax'][2]}"
        print(line, flush=True)
    out = {"course": name, "scans": len(scans)}
    for tag, pipe in pipes.items():
        traj = np.asarray([np.asarray(t) for t in pipe.trajectory], np.float64)
        out[tag] = dict(stress_errors(traj, poses), seconds=round(secs[tag], 1))
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--course", choices=("corridor", "fast_yaw", "both"), default="both")
    ap.add_argument("--scans", type=int, default=None, help="the first N scans only")
    ap.add_argument("--port-only", action="store_true", help="skip the JAX package")
    args = ap.parse_args()
    torch.set_num_threads(1)
    names = list(COURSES) if args.course == "both" else [args.course]
    bounds = {"corridor": {"lat": STRESS_LAT, "vert": STRESS_VERT,
                           "along": STRESS_ALONG_FRAC},
              "fast_yaw": {"ate": STRESS_YAW_ATE, "final": STRESS_YAW_FINAL}}
    for name in names:
        out = run_course(name, args.scans, args.port_only)
        out["bounds"] = bounds[name]
        print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
