"""The comparison that decides `correct`: what the timed path produced
(every chunk that BatchPipeline.process_chunk returned in the measured
window, and the keyframes the pipeline inserted there) against the plain
reference (reference.py), on the benchmark's own inputs and ground truth.
The warm-up chunks are set-up: their answers are not due in the window
(the pipeline's first scans, where its odometry starts from rest, are
judged nowhere).

Numbers compared, each against the limit in the cell's file
(``slam_bench/workloads/<cell>.json``):

* rpe_p95_m, rpe_p95_deg, rpe_max_m: the 95th percentile and the widest
  of the gaps of the program's fused relative motion over RPE_STEPS steps
  from the true one, over every such window of every sequence that starts
  in the measured window: the front end, odometry and the re-fuse after
  each solve;
* map_rpe_p95_m, map_rpe_p95_deg: the same for the mapped poses over
  MAP_SOLVES solves: scan-to-map registration;
* px_gap, ground_gap, seg_gap: the widest relative gap of the program's
  per-scan counts (occupied pixels, ground pixels, segmented cloud) from
  the reference's, over COUNT_SAMPLES scans of the window drawn from the
  seed: projection, ground, segmentation through K1, the packing K2 reads;
* did_map_bad, kf_bad, loop_bad, nonfinite (limit 0): steps whose solve
  flag breaks the mapping cadence, sequences whose keyframes inserted in
  the window differ in number from the reference's, loop flags raised
  (loop closure is off in every cell), non-finite pose entries of any
  sequence.
"""

from __future__ import annotations

import numpy as np
import torch

from slam_bench import reference as ref

RPE_STEPS, MAP_SOLVES, COUNT_SAMPLES = 7, 3, 48
ORDER = ("rpe_p95_m", "rpe_p95_deg", "rpe_max_m", "map_rpe_p95_m",
         "map_rpe_p95_deg", "px_gap", "ground_gap", "seg_gap", "did_map_bad",
         "kf_bad", "loop_bad", "nonfinite")


def collect(results, n_kf: torch.Tensor, n_kf0: torch.Tensor) -> dict:
    """The timed path's outputs on the host: poses (B, S, ...) float64,
    stats (B, S, 5), did_map (S,), loop flags (B, S), keyframes (B,) at
    the end and at the window's start."""
    def cat(f):
        return torch.cat([f(r) for r in results], 1).cpu()

    return {
        "fused_R": cat(lambda r: r.fused_poses.R).double().numpy(),
        "fused_t": cat(lambda r: r.fused_poses.t).double().numpy(),
        "mapped_R": cat(lambda r: r.mapped_poses.R).double().numpy(),
        "mapped_t": cat(lambda r: r.mapped_poses.t).double().numpy(),
        "stats": cat(lambda r: r.stats).numpy(),
        "did_map": torch.cat([r.did_map for r in results]).cpu().numpy(),
        "loop": cat(lambda r: r.loop_closed).numpy(),
        "n_kf": n_kf.cpu().numpy(),
        "n_kf0": n_kf0.cpu().numpy(),
    }


def count_samples(seed: int, B: int, w0: int, S: int) -> np.ndarray:
    """(COUNT_SAMPLES, 2) (sequence, step) pairs of the window [w0, S)
    whose scans the reference counts."""
    rng = np.random.default_rng([seed % (1 << 63), 3])
    return np.stack([rng.integers(0, B, COUNT_SAMPLES),
                     rng.integers(w0, max(S, w0 + 1), COUNT_SAMPLES)], 1)


def _motion(out, kind, TR, Tt, s, gap, tag, vals) -> None:
    """Gaps of the program's relative motion from step s to s + gap (every
    sequence) from the true one, into `vals`."""
    if len(s) == 0:          # a run too short to hold one window fails
        vals.update({f"{tag}rpe_{q}_{u}": float("nan")
                     for q in ("p95", "max") for u in ("m", "deg")})
        return
    e = s + gap
    R, t = out[f"{kind}_R"], out[f"{kind}_t"]
    est = ref.relative(R[:, s], t[:, s], R[:, e], t[:, e])
    true = ref.relative(TR[:, s], Tt[:, s], TR[:, e], Tt[:, e])
    gt, gr = ref.motion_gaps(*est, *true)
    for unit, g in (("m", gt), ("deg", gr)):
        vals[f"{tag}rpe_max_{unit}"] = float(g.max())
        for q in (50, 95, 99):
            vals[f"{tag}rpe_p{q}_{unit}"] = float(np.percentile(g, q))
    worst = np.unravel_index(np.argmax(gt), gt.shape)
    vals[f"{tag}rpe_worst"] = [int(worst[0]), int(s[worst[1]])]


def judge(out: dict, scans: list, rows: np.ndarray, w0: int, bank_R, bank_t,
          sensor: dict, pcfg: dict, seed: int, counts=None) -> dict:
    """{name: value} of every number compared (and a few more that help
    read them).  `rows` (B, S) are the bank rows each sequence was fed,
    steps from w0 on the measured window's; `scans` the (xyz, valid, ring)
    host arrays of the count samples' scans, in count_samples' order;
    `sensor` and `pcfg` the configuration file's sensor and pipeline
    settings.  `counts(xyz, valid, ring, sensor, pcfg)`, where given, takes
    the program's place for the per-scan counts (the control)."""
    B, S = rows.shape
    TR, Tt = bank_R[rows], bank_t[rows]
    vals = {}
    every = pcfg["mapping_process_every"]
    span = every * MAP_SOLVES
    steps = np.arange(S)
    solves = steps[steps % every == 0]
    _motion(out, "fused", TR, Tt, np.arange(w0, max(S - RPE_STEPS, w0)),
            RPE_STEPS, "", vals)
    _motion(out, "mapped", TR, Tt, solves[(solves >= w0) & (solves + span < S)],
            span, "map_", vals)

    gaps = np.zeros((len(scans), 3))
    for i, ((bi, si), scan) in enumerate(zip(count_samples(seed, B, w0, S), scans)):
        want = np.asarray(ref.frontend_counts(*scan, sensor, pcfg), float)
        got = (np.asarray(counts(*scan, sensor, pcfg), float) if counts
               else out["stats"][bi, si, :3].astype(float))
        gaps[i] = np.abs(got - want) / np.maximum(want, 1.0)
    vals["px_gap"], vals["ground_gap"], vals["seg_gap"] = (
        float(v) for v in gaps.max(0))

    vals["did_map_bad"] = int((out["did_map"] != (steps % every == 0)).sum())
    # keyframes of the window's solves, from a keyframe at the last solve
    # before the window
    before = solves[solves < w0]
    inside = solves[solves >= w0]
    start = before[-1:] if len(before) else inside[:0]
    want_kf = np.array([ref.keyframes(Tt[i, np.concatenate([start, inside])],
                                      pcfg["keyframe_min_translation"])
                        - len(start) for i in range(B)])
    got_kf = out["n_kf"] - out["n_kf0"]
    vals["kf_bad"] = int((got_kf != want_kf).sum())
    vals["kf_held"] = [int(out["n_kf"].min()), int(out["n_kf"].max())]
    vals["kf_diff"] = [[int(i), int(got_kf[i]), int(want_kf[i])]
                       for i in np.nonzero(got_kf != want_kf)[0][:8]]
    vals["loop_bad"] = int(out["loop"].sum())
    vals["nonfinite"] = int(sum((~np.isfinite(out[k])).sum() for k in (
        "fused_R", "fused_t", "mapped_R", "mapped_t")))
    return vals
