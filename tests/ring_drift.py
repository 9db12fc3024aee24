"""The soak's ring road (examples/soak.py, lego_loam_tpu_torch/examples/
soak.py): how far the fused pose drifts along a lap, in either package
(ROADMAP C14).  Not collected by pytest.

On the CPU, at SMALL's capacities with mapping every 3rd scan and loop
closure off, the first --scans scans of a lap at --step m a scan through
process_scan, the JAX package's or the port's (with --fit-dtype float32
the port fits its 5-point planes as the JAX package does):

    JAX_PLATFORMS=cpu python -m tests.ring_drift --package jax --scans 640 --step 0.1

On the card, the port at full width through the soak's own run() (loop
closure on, chunks of 64), for each pool size in --keyframes:

    python -m tests.ring_drift --device cuda --laps 2 --step 0.545 --keyframes 128 4096

Prints the fused pose's distance from the truth every --every scans.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from tests.torch_courses import SMALL


def _truth(step: float, n: int, chunk: int = 64):
    from lego_loam_tpu_torch.examples import soak

    per_lap = soak.scans_per_lap(soak.RADIUS, step, chunk)
    poses = soak.lap_poses(per_lap)
    gt = np.asarray([t for _, t in poses]) - poses[0][1]
    return poses, gt[np.arange(n) % per_lap]


def cpu_drift(package: str, scans: int, step: float, seed: int) -> np.ndarray:
    import torch

    from lego_loam_tpu_torch.examples import soak
    from lego_loam_tpu_torch.io import synthetic as syn

    poses, gt = _truth(step, scans)
    kw = dict(SMALL, mapping_process_every=3)
    if package == "jax":
        from lego_loam_tpu import config_for
        from lego_loam_tpu.models.pipeline import LegoLoamPipeline

        pipe = LegoLoamPipeline(config_for("vlp16", **kw))
    else:
        from lego_loam_tpu_torch import config_for
        from lego_loam_tpu_torch.models.pipeline import LegoLoamPipeline

        torch.set_num_threads(2)
        pipe = LegoLoamPipeline(config_for("vlp16", **kw), "cpu")
    world = soak.ring_world()
    traj = []
    for k in range(scans):
        R, t = poses[k]
        xyz, valid, ring = syn.raycast(world, R, t, pipe.cfg.sensor, noise=0.02,
                                       rng=np.random.default_rng(k + seed))
        res = pipe.process_scan(xyz, valid, ring)
        traj.append(np.asarray(res.fused_pose.t))
    return np.linalg.norm(np.asarray(traj) - gt, axis=1)


def card_drift(laps: int, step: float, keyframes: int) -> tuple:
    import torch

    from lego_loam_tpu_torch import config_for
    from lego_loam_tpu_torch.examples import soak

    cfg = config_for("vlp16", deskew=False, loop_closure_enabled=True,
                     max_keyframes=keyframes)
    out = soak.run(n_laps=laps, step=step, cfg=cfg, device="cuda",
                   workers=8, log=lambda *_: None)
    traj = out["pipeline"].trajectory_numpy()
    _, gt = _truth(step, len(traj))
    del out["pipeline"]
    torch.cuda.empty_cache()
    return np.linalg.norm(traj - gt, axis=1), out["record"]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cpu")
    ap.add_argument("--package", choices=("jax", "torch"), default="torch")
    ap.add_argument("--fit-dtype", choices=("float64", "float32"), default="float64")
    ap.add_argument("--scans", type=int, default=128)
    ap.add_argument("--laps", type=int, default=1)
    ap.add_argument("--step", type=float, default=0.545)
    ap.add_argument("--seed", type=int, default=0, help="added to each scan's noise seed")
    ap.add_argument("--keyframes", type=int, nargs="+", default=[4096])
    ap.add_argument("--every", type=int, default=64)
    args = ap.parse_args()
    if args.fit_dtype == "float32":
        import torch

        from lego_loam_tpu_torch.models import mapping

        mapping.FIT_DTYPE = torch.float32
    t0 = time.perf_counter()
    if args.device == "cpu":
        err = cpu_drift(args.package, args.scans, args.step, args.seed)
        fits = f", fits {args.fit_dtype}" if args.package == "torch" else ""
        print(f"{args.package} (cpu{fits}, seed {args.seed}), "
              f"{args.scans} scans at {args.step} m: error every {args.every} scans "
              f"{err[::args.every].round(3).tolist()}, last {err[-1]:.3f} m, "
              f"{time.perf_counter() - t0:.0f} s", flush=True)
        return
    from chip_smoke import card_line

    print(f"card: {card_line()}", flush=True)
    for K in args.keyframes:
        err, rec = card_drift(args.laps, args.step, K)
        print(f"port (card, max_keyframes {K}), {args.laps} laps at {args.step} m: "
              f"error every {args.every} scans {err[::args.every].round(3).tolist()}, "
              f"last {err[-1]:.3f} m, {time.perf_counter() - t0:.0f} s; {rec}", flush=True)


if __name__ == "__main__":
    main()
