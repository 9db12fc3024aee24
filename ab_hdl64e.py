"""A-B timing of the port's HDL-64E path on one card.

Two checkouts of this repo, A and B, each run in a process of its own, in
the order A B B A, repeated `--rounds` times, so that the host's noise
falls on both alike.  Every process drives the same scans through its own
tree's `chip_smoke.run_slice` (the HDL-64E phase of chip_smoke.py):
scans/s over the window, then `frontend_step` and `mapping_step` ms, each
synchronised, in a second pass, and the ATE; then, in a third pass, the
median wall and host-CPU ms of a scan after the first `WARM` (medians,
and CPU time, are less moved by the shared host than a window's mean).
The course is chip_smoke.py's HDL-64E course (KITTI's sensor, world seed
9, circle of radius 8 m, 2 cm range noise, no ring channel, each point
moved into the middle of its elevation row) at the same step a scan,
lengthened to `--scans` scans.

    python3 ab_hdl64e.py --a path/to/parent --b . [--rounds 4] [--scans 33]
                         [--fits REPS]

Prints one JSON line a process and the medians and ranges of each tree;
with --fits, then B's path with its 5-point fits in float32 and in float64
side by side in one process (FITS below).  Needs one card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np

STEP_ARC = 0.18 * np.pi / 8     # chip_smoke.py: 9 scans over 0.18 pi
WARM, SYNC = 3, 1               # chip_smoke.py's HDL_WARM, HDL_SYNC

CHILD = """
import json, sys, time
import numpy as np, torch
sys.path.insert(0, ".")
import chip_smoke as cs
from lego_loam_tpu_torch import config_for
d = np.load(sys.argv[1])
scans = list(zip(d["xyz"], d["valid"], d["ring"]))
poses = list(zip(d["R"], d["t"]))
cfg, dev = config_for("hdl64e", deskew=False), torch.device("cuda:0")
warm, sync = int(sys.argv[2]), int(sys.argv[3])
r = cs.run_slice(torch, cfg, scans, poses, dev, warm, sync)
out = {k: r[k] for k in ("scans_per_s", "window_scans", "frontend_ms",
                         "mapping_ms", "ate_m", "launches")}
# a third pass: each scan's wall and host-CPU ms (process_scan ends in a
# host copy, so a scan is complete when it returns); the medians of the
# window shrug off bursts of the shared host, CPU ms its contention too
from lego_loam_tpu_torch.models.pipeline import LegoLoamPipeline
pipe = LegoLoamPipeline(cfg, dev)
wall, cpu = [], []
for k, (xyz, valid, _) in enumerate(scans):     # HDL-64E takes no ring
    xyz, valid = torch.as_tensor(xyz, device=dev), torch.as_tensor(valid, device=dev)
    w0, c0 = time.perf_counter(), time.process_time()
    pipe.process_scan(xyz, valid, None)
    if k >= warm:
        wall.append((time.perf_counter() - w0) * 1e3)
        cpu.append((time.process_time() - c0) * 1e3)
out.update(scan_wall_ms=float(np.median(wall)), scan_cpu_ms=float(np.median(cpu)))
print(json.dumps(out))
"""

# --fits: one process on checkout B, two pipelines fed the same scans in
# turn, one with the 5-point fits in float32 and one in float64 (the order
# swapped every scan): wall ms a scan, and mapping_step ms synchronised
FITS = """
import json, sys, time
import numpy as np, torch
sys.path.insert(0, ".")
from lego_loam_tpu_torch import config_for
from lego_loam_tpu_torch.models import pipeline as pl
d = np.load(sys.argv[1])
warm, reps = int(sys.argv[2]), int(sys.argv[3])
cfg, dev = config_for("hdl64e", deskew=False), torch.device("cuda:0")
scans = [(torch.as_tensor(x, device=dev), torch.as_tensor(v, device=dev))
         for x, v in zip(d["xyz"], d["valid"])]
dtypes = {"float32": torch.float32, "float64": torch.float64}
orig, last = pl.mp.mapping_step, []
def timed(*a, **kw):
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = orig(*a, **kw)
    torch.cuda.synchronize()
    last.append((time.perf_counter() - t) * 1e3)
    return out
pl.mp.mapping_step = timed
wall = {k: [] for k in dtypes}
solve = {k: [] for k in dtypes}
ate = {k: [] for k in dtypes}
for rep in range(reps):
    pipes = {k: pl.LegoLoamPipeline(cfg, dev) for k in dtypes}
    for i, (xyz, valid) in enumerate(scans):
        for k in (("float32", "float64") if i % 2 == 0 else ("float64", "float32")):
            pl.mp.FIT_DTYPE = dtypes[k]
            del last[:]
            t = time.perf_counter()
            pipes[k].process_scan(xyz, valid, None)
            if i >= warm:
                wall[k].append((time.perf_counter() - t) * 1e3)
                solve[k] += last
    for k, p in pipes.items():
        err = [np.linalg.norm(d["R"][0] @ q + d["t"][0] - t)
               for q, t in zip(p.trajectory, d["t"])]
        ate[k].append(float(np.sqrt(np.mean(np.square(err)))))
print(json.dumps({k: {"scan_wall_ms": float(np.median(wall[k])),
                      "mapping_ms": float(np.median(solve[k])),
                      "solves": len(solve[k]), "ate_m": ate[k]} for k in dtypes}))
"""


def make_course(n: int, path: str) -> None:
    from lego_loam_tpu_torch import config_for
    from lego_loam_tpu_torch.io import synthetic as syn
    from tests.test_torch_sensor_rows import mid_row

    sensor = config_for("hdl64e", deskew=False).sensor
    world = syn.default_world(seed=9)
    poses = syn.circle_trajectory(n, radius=8.0, arc=STEP_ARC * (n - 1))
    scans = [syn.raycast(world, R, t, sensor, noise=0.02,
                         rng=np.random.default_rng(k))
             for k, (R, t) in enumerate(poses)]
    np.savez(path, xyz=np.stack([mid_row(s[0], sensor) for s in scans]),
             valid=np.stack([s[1] for s in scans]),
             ring=np.stack([s[2] for s in scans]),
             R=np.stack([p[0] for p in poses]), t=np.stack([p[1] for p in poses]))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--a", required=True, help="checkout A (e.g. the parent)")
    ap.add_argument("--b", default=".", help="checkout B (default: this one)")
    ap.add_argument("--rounds", type=int, default=4, help="A B B A rounds")
    ap.add_argument("--scans", type=int, default=33)
    ap.add_argument("--fits", type=int, default=0, metavar="REPS",
                    help="also run B's path REPS times with its fits in "
                         "float32 and float64 side by side in one process")
    args = ap.parse_args()

    here = os.path.dirname(os.path.abspath(__file__))
    os.makedirs(os.path.join(here, "build"), exist_ok=True)
    course = os.path.join(here, "build", "ab_hdl64e_course.npz")
    make_course(args.scans, course)
    trees = {"A": os.path.abspath(args.a), "B": os.path.abspath(args.b)}
    runs = {"A": [], "B": []}
    for rnd in range(args.rounds):
        for tag in "ABBA":
            out = subprocess.run(
                [sys.executable, "-c", CHILD, course, str(WARM), str(SYNC)],
                cwd=trees[tag], capture_output=True, text=True, timeout=600)
            if out.returncode != 0:
                sys.exit(f"{tag} (round {rnd}) failed:\n{out.stderr[-4000:]}")
            r = json.loads(out.stdout.strip().splitlines()[-1])
            runs[tag].append(r)
            print(json.dumps({"tree": tag, "round": rnd, **r}), flush=True)
    summary = {}
    for tag, rs in runs.items():
        summary[tag] = {key: {"median": float(np.median([r[key] for r in rs])),
                              "min": min(r[key] for r in rs),
                              "max": max(r[key] for r in rs)}
                        for key in ("scans_per_s", "frontend_ms", "mapping_ms",
                                    "scan_wall_ms", "scan_cpu_ms", "ate_m")}
    print(json.dumps({"scans": args.scans, "window_scans": runs["B"][0]["window_scans"],
                      "rounds": args.rounds, **summary}))
    if args.fits:
        out = subprocess.run(
            [sys.executable, "-c", FITS, course, str(WARM), str(args.fits)],
            cwd=trees["B"], capture_output=True, text=True, timeout=900)
        if out.returncode != 0:
            sys.exit(f"--fits failed:\n{out.stderr[-4000:]}")
        print(json.dumps({"fits": json.loads(out.stdout.strip().splitlines()[-1])}))


if __name__ == "__main__":
    main()
