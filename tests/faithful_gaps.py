"""ATE of the reference-faithful configuration on the CPU (not collected by
pytest), for the JAX package and the port side by side:

    JAX_PLATFORMS=cpu python -m tests.faithful_gaps [--course oracle|slice]
                                                    [--package both|port|jax]

--course oracle (the default): tests/test_oracle_pipeline.py's 15-scan
course in its config (tests/torch_courses.ORACLE_CFG), the odometry in the
test's block schedule and in the two-step one, beside the NumPy oracle of
the C++ reference (tests/oracle_pipeline.py, the two-step LM): each
package's ATE against the truth, against the oracle and against the other
package (~3 min).  --course slice: chip_smoke.py's slice course (30 scans
of a 12 m circle in world seed 0) in FAITHFUL with SMALL capacities, the
default block / knn configuration beside it (~2 min a package).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from lego_loam_tpu_torch import config_for
from lego_loam_tpu_torch.io import synthetic as syn
from lego_loam_tpu_torch.models.pipeline import LegoLoamPipeline
from tests.torch_courses import FAITHFUL, ORACLE_CFG, SMALL, oracle_course


def _ate(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.sqrt(np.mean(np.sum((a - b) ** 2, axis=1))))


def _run(package: str, kw: dict, scans) -> np.ndarray:
    """Fused positions of the scans through `package`'s process_scan."""
    if package == "jax":
        from lego_loam_tpu import config_for as jconfig_for
        from lego_loam_tpu.models.pipeline import LegoLoamPipeline as JaxPipeline

        pipe = JaxPipeline(jconfig_for("vlp16", **kw), collect_stats=False)
        for s in scans:
            pipe.process_scan(*s)
        return np.asarray([np.asarray(t) for t in pipe.trajectory])
    pipe = LegoLoamPipeline(config_for("vlp16", **kw), "cpu", collect_stats=False)
    for s in scans:
        pipe.process_scan(*s)
    return pipe.trajectory_numpy()


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--course", choices=("oracle", "slice"), default="oracle")
    ap.add_argument("--package", choices=("both", "port", "jax"), default="both")
    args = ap.parse_args()
    torch.set_num_threads(4)
    packages = ("jax", "port") if args.package == "both" else (args.package,)
    if args.course == "oracle":
        from tests.oracle_pipeline import OraclePipeline

        cfg = config_for("vlp16", **ORACLE_CFG)
        poses, scans = oracle_course(cfg.sensor)
        gt = np.asarray([t for _, t in poses]) - poses[0][1]
        orc = OraclePipeline(cfg)
        for s in scans:
            orc.process_scan(*s)
        print(f"oracle: ATE {_ate(orc.trajectory, gt):.4f} m, {len(orc.kf_R)} keyframes")
        arms = (("block", dict(ORACLE_CFG)),
                ("two_step", dict(ORACLE_CFG, odom_mode="two_step")))
    else:
        world = syn.default_world(seed=0)
        poses = syn.circle_trajectory(30, radius=12.0, arc=0.35 * np.pi)
        sensor = config_for("vlp16").sensor
        scans = [syn.raycast(world, R, t, sensor, noise=0.01,
                             rng=np.random.default_rng(k))
                 for k, (R, t) in enumerate(poses)]
        R0, t0 = poses[0]
        gt = np.asarray([R0.T @ (t - t0) for _, t in poses])
        orc = None
        arms = (("faithful", dict(SMALL, **FAITHFUL)),
                ("default", dict(SMALL)))
    for tag, kw in arms:
        trajs = {p: _run(p, kw, scans) for p in packages}
        line = []
        for p, tr in trajs.items():
            line.append(f"{p} ATE {_ate(tr, gt):.4f} m")
            if orc is not None:
                line.append(f"{p} against the oracle {_ate(tr, orc.trajectory):.4f} m")
        if len(trajs) == 2:
            line.append(f"jax against port {_ate(*trajs.values()):.6f} m")
        print(f"{tag}: " + ", ".join(line), flush=True)


if __name__ == "__main__":
    main()
