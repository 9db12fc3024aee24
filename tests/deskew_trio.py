"""The de-skew trio of bench.py on the CPU, for both packages: the fast-yaw
course (tests/torch_courses.py; bench.py:186-253) through the JAX
package's and the port's LegoLoamPipeline with de-skew off, on, and on
with the ideal IMU stream, at tests/torch_courses.py's SMALL capacities;
ATE after rigid alignment (bench.py's definition), and each package's
scan-to-scan translation (rel.t) a scan on the on arm.

    JAX_PLATFORMS=cpu python -m tests.deskew_trio [--scans 48]
    JAX_PLATFORMS=cpu python -m tests.deskew_trio --gaps [--scans 4]

About 4 minutes for 48 scans on a CPU (the port ~1 s a scan).  --gaps
prints instead, on tests/test_torch_imu_pipeline.py's de-skew course and
config (the IMU pushed), each scan's fused-pose gap between the two
packages running free and with the port started from the JAX pipeline's
state before the scan (through the checkpoint).
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from lego_loam_tpu import config_for as jconfig_for
from lego_loam_tpu.models.pipeline import LegoLoamPipeline as JaxPipeline
from lego_loam_tpu_torch import config_for
from lego_loam_tpu_torch.models.pipeline import LegoLoamPipeline

from tests.torch_courses import SMALL, aligned_ate, fast_yaw_course, fast_yaw_imu


def run(make, scans, stamps, imu, gt):
    pipe = make()
    rel = []
    for k, scan in enumerate(scans):
        for sample in (imu[k] if imu is not None else ()):
            pipe.push_imu(*sample)
        pipe.process_scan(*scan, t=stamps[k])
        rel.append(np.asarray(pipe.ostate.rel.t).round(3).tolist())
    return aligned_ate(np.asarray(pipe.trajectory), gt), rel


def gaps(n: int) -> None:
    import tempfile

    from lego_loam_tpu.io import checkpoint as jckpt
    from lego_loam_tpu_torch.io import checkpoint as tckpt

    from tests.test_torch_backend import _rot_err_deg
    from tests.test_torch_imu_pipeline import JCFG, TCFG

    jcfg, tcfg = JCFG.replace(deskew=True), TCFG.replace(deskew=True)
    _, scans, stamps = fast_yaw_course(tcfg.sensor, n)
    jpipe, tpipe = JaxPipeline(jcfg), LegoLoamPipeline(tcfg, "cpu")

    def gap(jr, tr):
        return (1e3 * float(np.abs(tr.fused_pose.t.numpy()
                                   - np.asarray(jr.fused_pose.t)).max()),
                _rot_err_deg(np.asarray(jr.fused_pose.R), tr.fused_pose.R.numpy()))

    with tempfile.TemporaryDirectory() as d:
        path = f"{d}/before.npz"
        for k in range(n):
            jckpt.save_checkpoint(jpipe, path)
            same = LegoLoamPipeline(tcfg, "cpu")
            tckpt.load_checkpoint(same, path)
            out = []
            for pipe in (jpipe, tpipe, same):
                for sample in fast_yaw_imu(k, tcfg.sensor.scan_period):
                    pipe.push_imu(*sample)
                out.append(pipe.process_scan(*scans[k], t=stamps[k]))
            free, from_jax = gap(out[0], out[1]), gap(out[0], out[2])
            print(f"scan {k}: running free {free[0]:.2f} mm / {free[1]:.4f} deg, "
                  f"from the JAX state {from_jax[0]:.2f} mm / {from_jax[1]:.4f} deg",
                  flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scans", type=int, default=None)
    ap.add_argument("--gaps", action="store_true")
    args = ap.parse_args()
    torch.set_num_threads(1)
    if args.gaps:
        gaps(args.scans or 4)
        return
    args.scans = args.scans or 48
    kw = {k: v for k, v in SMALL.items() if k != "deskew"}
    jcfg, tcfg = jconfig_for("vlp16", **kw), config_for("vlp16", **kw)
    poses, scans, stamps = fast_yaw_course(tcfg.sensor, args.scans)
    imu = [fast_yaw_imu(k, tcfg.sensor.scan_period) for k in range(args.scans)]
    gt = np.asarray([t for _, t in poses])
    out = {}
    for arm, deskew, stream in (("off", False, None), ("on", True, None),
                                ("imu", True, imu)):
        for pkg, make in (
                ("jax", lambda: JaxPipeline(jcfg.replace(deskew=deskew))),
                ("port", lambda: LegoLoamPipeline(tcfg.replace(deskew=deskew), "cpu"))):
            ate, rel = run(make, scans, stamps, stream, gt)
            out[f"{pkg}_{arm}_ate_m"] = ate
            if arm == "on":
                out[f"{pkg}_on_rel_t"] = rel
            print(f"{pkg} de-skew {arm}: aligned ATE {ate:.4f} m", flush=True)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
