"""Run the pipeline over a KITTI odometry sequence and report ATE/RPE (the
port's counterpart of examples/run_kitti.py).

Usage:
  python -m lego_loam_tpu_torch.examples.run_kitti \
      --seq /data/kitti/sequences/00 [--poses /data/kitti/poses/00.txt] \
      [--frames N] [--loop] [--out traj.txt] [--cpu] [--chunk C]

Expects the standard layout: <seq>/velodyne/*.bin and <seq>/calib.txt.
KITTI scans are motion-compensated, so de-skew is off and rows come from
elevation math (HDL-64E preset).
"""

from __future__ import annotations

import argparse

import numpy as np

from lego_loam_tpu_torch.config import PipelineConfig, config_for
from lego_loam_tpu_torch.examples import require_device
from lego_loam_tpu_torch.io import kitti
from lego_loam_tpu_torch.models.pipeline import LegoLoamPipeline
from lego_loam_tpu_torch.utils.metrics import ate_rmse, poses_to_mat, rpe


def make_config(loop: bool = False) -> PipelineConfig:
    """The script's config: HDL-64E with feature caps for its ~120k-point
    scans and the shipping pool of 4096 keyframes."""
    return config_for(
        "hdl64e", deskew=False,
        max_keyframes=4096,
        max_less_flat=8192, max_less_sharp=4096, max_sharp=1024,
        max_flat=2048, max_outlier=4096,
        loop_closure_enabled=loop,
    )


def _host(pose):
    return pose.R.cpu().numpy(), pose.t.cpu().numpy()


def run(seq: str, cfg: PipelineConfig | None = None, poses: str | None = None,
        frames: int | None = None, out: str | None = None, chunk: int = 0,
        device="cuda", log=print) -> dict:
    """Replay the sequence per scan, or with `chunk` > 1 in chunks of that
    many scans through process_chunk (the ragged tail per scan).  Writes
    the trajectory in KITTI's format to `out`; with a ground-truth `poses`
    file, ATE and RPE against it, anchored at its first pose.  Returns the
    fused poses (R (N, 3, 3), t (N, 3)) and the metrics."""
    dev = require_device(device)
    cfg = cfg or make_config()
    seq_it = kitti.KittiSequence(seq, cfg, max_frames=frames)
    pipe = LegoLoamPipeline(cfg, dev)

    est_R, est_t = [], []
    if chunk > 1:
        # throughput replay: C scans a call; the ragged tail runs through
        # the per-scan path
        buf = []

        def flush_chunk():
            xyzs = np.stack([b[0] for b in buf])
            vals = np.stack([b[1] for b in buf])
            res = pipe.process_chunk(xyzs, vals, None, t0=buf[0][2])
            R, t = _host(res.fused_poses)
            est_R.extend(R)
            est_t.extend(t)
            log(f"frame {len(est_t)}/{len(seq_it)}  pos="
                f"{est_t[-1].round(1)}  "
                f"{res.wall_ms / len(buf):.0f} ms/scan")
            buf.clear()

        for xyz, valid, t in seq_it:
            buf.append((xyz, valid, t))
            if len(buf) == chunk:
                flush_chunk()
        for xyz, valid, t in buf:
            res = pipe.process_scan(xyz, valid, None, t=t)
            R, tt = _host(res.fused_pose)
            est_R.append(R)
            est_t.append(tt)
    else:
        for k, (xyz, valid, t) in enumerate(seq_it):
            res = pipe.process_scan(xyz, valid, None, t=t)
            R, tt = _host(res.fused_pose)
            est_R.append(R)
            est_t.append(tt)
            if k % 50 == 0:
                log(f"frame {k}/{len(seq_it)}  pos={tt.round(1)}  "
                    f"{res.wall_ms:.0f} ms")

    est_R = np.stack(est_R)
    est_t = np.stack(est_t)
    result = {"R": est_R, "t": est_t, "pipeline": pipe}
    if out:
        kitti.write_poses_kitti(out, est_R, est_t)
        log(f"wrote {out}")

    if poses:
        T_cv = kitti.read_calib(seq)
        gt = kitti.read_poses(poses, T_cv)[: len(est_t)]
        # estimates live in the first-scan velodyne frame; gt likewise after
        # anchoring at its first pose
        gt0_inv = np.linalg.inv(gt[0])
        gt_rel = np.einsum("ij,njk->nik", gt0_inv, gt)
        ate = ate_rmse(est_t, gt_rel[:, :3, 3])
        est_T = poses_to_mat(est_R, est_t)
        delta = max(1, min(10, len(est_t) - 1))
        tr, rot = rpe(est_T, gt_rel, delta=delta)
        log(f"ATE RMSE: {ate:.3f} m   RPE@{delta}: {tr:.3f} m, "
            f"{np.degrees(rot):.3f} deg over {len(est_t)} frames")
        result.update(ate_m=ate, rpe_delta=delta, rpe_m=tr, rpe_rad=rot)
    return result


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--seq", required=True)
    ap.add_argument("--poses", default=None, help="ground-truth pose file")
    ap.add_argument("--frames", type=int, default=None)
    ap.add_argument("--loop", action="store_true")
    ap.add_argument("--out", default=None, help="write KITTI-format trajectory")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    ap.add_argument("--chunk", type=int, default=0,
                    help="process C scans a call (throughput replay mode; "
                         "0 = per-scan)")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    return run(args.seq, make_config(args.loop), args.poses, args.frames,
               args.out, args.chunk, "cpu" if args.cpu else "cuda")


if __name__ == "__main__":
    main()
