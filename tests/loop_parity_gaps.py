"""Per-scan gaps between the JAX package's and the port's LegoLoamPipeline
on the CPU, over tests/test_torch_loop_pipeline.py's course: the LOOP
config with a loop check every 2nd scan, the 5 + 5 scan out-and-back.

The port's 5-point line and plane fits run in float64
(lego_loam_tpu_torch/models/mapping.py FIT_DTYPE); --fit-dtype float32
runs them in float32, as the JAX package fits them, to show how much of
the gap that choice makes.

    JAX_PLATFORMS=cpu python -m tests.loop_parity_gaps [--fit-dtype float32]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from lego_loam_tpu import config_for as jconfig_for
from lego_loam_tpu.models.pipeline import LegoLoamPipeline as JaxPipeline
from lego_loam_tpu_torch import config_for
from lego_loam_tpu_torch.models import mapping
from lego_loam_tpu_torch.models.pipeline import LegoLoamPipeline

from tests.test_torch_backend import _rot_err_deg
from tests.torch_courses import LOOP, LOOP_CHECK_EVERY, LOOP_SHORT_OUT, loop_course


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--fit-dtype", choices=("float64", "float32"), default="float64")
    args = ap.parse_args()
    mapping.FIT_DTYPE = getattr(torch, args.fit_dtype)
    torch.set_num_threads(1)

    jcfg, tcfg = jconfig_for("vlp16", **LOOP), config_for("vlp16", **LOOP)
    _, scans, stamps = loop_course(tcfg.sensor, LOOP_SHORT_OUT)
    jpipe = JaxPipeline(jcfg, loop_check_every=LOOP_CHECK_EVERY)
    tpipe = LegoLoamPipeline(tcfg, "cpu", loop_check_every=LOOP_CHECK_EVERY)
    gaps = []
    for k, ((xyz, valid, ring), t) in enumerate(zip(scans, stamps)):
        jr = jpipe.process_scan(xyz, valid, ring, t=t)
        tr = tpipe.process_scan(xyz, valid, ring, t=t)
        mm = 1e3 * float(np.abs(tr.fused_pose.t.numpy()
                                - np.asarray(jr.fused_pose.t)).max())
        deg = _rot_err_deg(np.asarray(jr.fused_pose.R), tr.fused_pose.R.numpy())
        gaps.append((mm, deg))
        print(f"scan {k}: loop_closed jax {jr.loop_closed} port {tr.loop_closed}, "
              f"stats equal {tr.stats == jr.stats}, fused gap {mm:.3f} mm "
              f"{deg:.4f} deg", flush=True)
    kf_mm = 1e3 * float(np.abs(tpipe.keyframe_poses() - jpipe.keyframe_poses()).max())
    print(json.dumps({
        "fit_dtype": args.fit_dtype,
        "max_fused_gap_mm": max(g[0] for g in gaps),
        "max_fused_gap_deg": max(g[1] for g in gaps),
        "max_keyframe_gap_mm": kf_mm,
        "n_loops": [int(jpipe.mstate.n_loops), int(tpipe.mstate.n_loops)]}))


if __name__ == "__main__":
    main()
