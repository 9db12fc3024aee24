"""Per-sequence gaps of fleet batching (models/batch.py) on chip_smoke.py's
fleet courses (not collected by pytest; jax-free, so it runs on the card):

    python -m tests.fleet_gaps [--device cuda] [--radius-step 0.5]
                               [--deterministic] [--alone-only]
                               [--sequences 0,1,...] [--package jax]

For each of the 8 sequences (tests/torch_courses.fleet_course) it prints the
ATE of two runs alone through LegoLoamPipeline.process_chunk and of two
runs of the whole batch through BatchPipeline (chunks of 10), and the
largest fused-pose gaps batch-alone, batch-batch and alone-alone, with
whether the packed stats agree.  --deterministic turns on
torch.use_deterministic_algorithms (on the card the voxel centroids'
index_add atomics then add in a fixed order); --radius-step 1 gives the
courses of radius 12 + b m; --alone-only runs each sequence alone once (the
ATE of a course, ~1 min a sequence on a CPU at full width), and with
--package jax runs the JAX package's process_scan instead (on the CPU;
the only use of jax here).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

B, N_SCANS, C = 8, 30, 10


def _chunks(scans):
    return [tuple(np.stack([s[i] for s in scans[k:k + C]]) for i in range(3))
            for k in range(0, len(scans), C)]


def _ate(t, poses) -> float:
    R0, t0 = poses[0]
    return float(np.sqrt(np.mean([np.sum((R0 @ p + t0 - tr) ** 2)
                                  for p, (_, tr) in zip(t, poses)])))


def _gap(a, b) -> str:
    """Largest translation (mm) and rotation (deg) gap of two (R, t) runs."""
    (Ra, ta), (Rb, tb) = a, b
    d = np.einsum("kji,kjl->kil", Ra.astype(np.float64), Rb.astype(np.float64))
    s = 0.5 * np.linalg.norm(np.stack([d[:, 2, 1] - d[:, 1, 2], d[:, 0, 2] - d[:, 2, 0],
                                       d[:, 1, 0] - d[:, 0, 1]], 1), axis=1)
    deg = np.degrees(np.arcsin(np.minimum(s, 1.0))).max()
    return f"{np.abs(ta - tb).max() * 1e3:.4f} mm / {deg:.5f} deg"


def _alone(cfg, scans, dev):
    from lego_loam_tpu_torch.models.pipeline import LegoLoamPipeline

    pipe = LegoLoamPipeline(cfg, dev)
    res = [pipe.process_chunk(*ch) for ch in _chunks(scans)]
    return ([torch.cat([getattr(r.fused_poses, f) for r in res]).cpu().numpy()
             for f in ("R", "t")], torch.cat([r.stats for r in res]))


def _alone_jax(scans):
    """The fused translations of the JAX package's process_scan."""
    from lego_loam_tpu import config_for as jconfig_for
    from lego_loam_tpu.models.pipeline import LegoLoamPipeline as JaxPipeline

    pipe = JaxPipeline(jconfig_for("vlp16", deskew=False))
    return np.stack([np.asarray(pipe.process_scan(*s).fused_pose.t) for s in scans])


def _batch(cfg, seqs, dev):
    from lego_loam_tpu_torch.models.batch import BatchPipeline

    bp = BatchPipeline(cfg, len(seqs), device=dev)
    per = [_chunks(s) for s in seqs]
    res = [bp.process_chunk(*(np.stack([p[k][i] for p in per]) for i in range(3)))
           for k in range(len(per[0]))]
    R = torch.cat([r.fused_poses.R for r in res], 1).cpu().numpy()
    t = torch.cat([r.fused_poses.t for r in res], 1).cpu().numpy()
    stats = torch.cat([r.stats for r in res], 1)
    return [((R[b], t[b]), stats[b]) for b in range(len(seqs))]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--radius-step", type=float, default=0.5)
    ap.add_argument("--deterministic", action="store_true")
    ap.add_argument("--alone-only", action="store_true")
    ap.add_argument("--sequences", default=",".join(map(str, range(B))))
    ap.add_argument("--package", choices=("torch", "jax"), default="torch")
    args = ap.parse_args()
    if args.deterministic:
        torch.use_deterministic_algorithms(True, warn_only=True)
    from lego_loam_tpu_torch import config_for
    from tests.torch_courses import fleet_course

    cfg = config_for("vlp16", deskew=False)
    dev = torch.device(args.device)
    seqs = [int(b) for b in args.sequences.split(",")]
    courses = [fleet_course(cfg.sensor, b, N_SCANS, args.radius_step)
               for b in seqs]
    where = (torch.cuda.get_device_name(dev) if dev.type == "cuda" else "the CPU")
    print(f"fleet gaps on {where}: radius 12 + {args.radius_step} b m, "
          f"deterministic {args.deterministic}, package {args.package}")
    if args.alone_only:
        for b, (poses, scans) in zip(seqs, courses):
            t = (_alone_jax(scans) if args.package == "jax"
                 else _alone(cfg, scans, dev)[0][1])
            print(f"sequence {b}: ATE alone {_ate(t, poses):.4f} m", flush=True)
        return
    runs = [_batch(cfg, [s for _, s in courses], dev) for _ in range(2)]
    for i, (b, (poses, scans)) in enumerate(zip(seqs, courses)):
        a1, s1 = _alone(cfg, scans, dev)
        a2, _ = _alone(cfg, scans, dev)
        (p1, st1), (p2, _) = runs[0][i], runs[1][i]
        print(f"sequence {b}: ATE alone {_ate(a1[1], poses):.4f} / "
              f"{_ate(a2[1], poses):.4f} m, batch {_ate(p1[1], poses):.4f} / "
              f"{_ate(p2[1], poses):.4f} m; batch-alone {_gap(p1, a1)} (stats "
              f"{'equal' if torch.equal(st1.cpu(), s1.cpu()) else 'differ'}), "
              f"batch-batch {_gap(p1, p2)}, alone-alone {_gap(a1, a2)}", flush=True)


if __name__ == "__main__":
    main()
