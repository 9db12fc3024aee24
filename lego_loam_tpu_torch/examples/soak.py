"""Stevens-scale soak run (the port's counterpart of examples/soak.py).

The reference's largest validation dataset is the ~20k-scan Stevens campus
bag with many loop revisits (reference: README.md:104-106); no dataset
exists here, so this is the synthetic stand-in at that scale:

  * a ring-road world (buildings + poles inside and outside a radius-50 m
    loop) traversed for N_LAPS laps at 0.1 m/scan — ~12.5k scans, ~1.25 km;
  * chunk-mode replay, loop closure ON, SHIPPING capacities
    (max_keyframes=4096): the pool must FILL, the compaction
    (models/mapping.compact_keyframes, which LegoLoamPipeline triggers from
    its host bound on the keyframe count) must fire IN-PIPELINE, loop
    edges must survive it, and the corrected trajectory must stay bounded.

Scans for one lap are raycast once (in `workers` processes) and replayed
for subsequent laps (identical revisit geometry — the loop-closure regime,
cheaper than re-tracing); the lap stays on the device.  Prints one JSON
line; wall-clock excludes scan generation.  On stderr, '#' lines carry what
the JSON line does not: the keyframe count at each sample, host syncs a
chunk (on a card), the pipeline's own count of compactions, ms a loop check
against the end state's pool and peak device memory.

Run:  python -m lego_loam_tpu_torch.examples.soak [n_laps] [chunk] [--cpu]
"""

from __future__ import annotations

import json
import os
import sys
import time
import warnings
from collections import Counter

import numpy as np
import torch

from lego_loam_tpu_torch.config import PipelineConfig, config_for
from lego_loam_tpu_torch.examples import require_device
from lego_loam_tpu_torch.io import synthetic as syn
from lego_loam_tpu_torch.models import loop as lc
from lego_loam_tpu_torch.models.pipeline import LegoLoamPipeline
from lego_loam_tpu_torch.utils.metrics import ate_rmse

N_LAPS = 4
CHUNK = 64
RADIUS = 50.0
STEP = 0.1                       # m per scan -> keyframe every 3rd scan
LOOP_CHECK_EVERY = 10
LOOP_PROBE_REPS = 3               # loop checks timed on the end state
ATE_LIMIT = 5.0                  # m, the corrected ATE the soak accepts


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def make_config() -> PipelineConfig:
    """The shipping configuration: VLP-16, default capacities, loop
    closure on."""
    return config_for("vlp16", deskew=False, loop_closure_enabled=True)


def ring_world(seed=0, radius=RADIUS):
    """Buildings + poles along both sides of a radius-`radius` ring road."""
    rng = np.random.default_rng(seed)
    boxes, cyl = [], []
    # the course circles the point (0, radius); world structure sits on
    # rings of radius r around that centre
    for a in np.arange(0.0, 2 * np.pi, 2 * np.pi / 24):
        for r, scale in ((radius - 12.0, 1.0), (radius + 12.0, 1.4)):
            cx, cy = r * np.sin(a), radius - r * np.cos(a)
            w, d = rng.uniform(2.5, 7.0, 2) * scale
            h = rng.uniform(2.0, 6.0)
            boxes.append([cx - w / 2, cy - d / 2, 0.0,
                          cx + w / 2, cy + d / 2, h])
    for a in np.arange(0.0, 2 * np.pi, 2 * np.pi / 40):
        for r in (radius - 5.0, radius + 5.0):
            cx, cy = r * np.sin(a), radius - r * np.cos(a)
            cyl.append([cx + rng.uniform(-1, 1), cy + rng.uniform(-1, 1),
                        rng.uniform(0.14, 0.35), rng.uniform(2.5, 5.0)])
    return syn.World(ground_z=0.0, boxes=np.asarray(boxes),
                     cylinders=np.asarray(cyl))


def lap_poses(n, radius=RADIUS):
    poses = []
    for k in range(n):
        a = 2 * np.pi * k / n
        t = np.array([radius * np.sin(a), radius * (1 - np.cos(a)), 1.6])
        c, s = np.cos(a), np.sin(a)
        R = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
        poses.append((R, t))
    return poses


def scans_per_lap(radius: float, step: float, chunk: int) -> int:
    """Scans a lap: the circumference over the step, cut down to a whole
    number of chunks."""
    per_lap = int(round(2 * np.pi * radius / step))
    return per_lap - per_lap % chunk


def _cast(job):
    world, R, t, sensor, k = job
    return syn.raycast(world, R, t, sensor, noise=0.02,
                       rng=np.random.default_rng(k))


def lap_scans(world, poses, sensor, workers: int = 1, log=_log):
    """The lap's scans (scan k with 2 cm noise from seed k) stacked: xyz (n,
    N, 3) float32, valid (n, N) bool, ring (n, N) int32.  With `workers` >
    1 they are cast in that many processes (the same scans)."""
    jobs = [(world, R, t, sensor, k) for k, (R, t) in enumerate(poses)]
    n = len(jobs)
    t0 = time.perf_counter()
    if workers > 1:
        import multiprocessing as mp
        from concurrent.futures import ProcessPoolExecutor

        with ProcessPoolExecutor(workers, mp_context=mp.get_context("spawn")) as ex:
            scans = list(ex.map(_cast, jobs, chunksize=max(1, n // (8 * workers))))
    else:
        scans = []
        for k, job in enumerate(jobs):
            scans.append(_cast(job))
            if k % 500 == 0:
                log(f"#   {k}/{n} ({time.perf_counter() - t0:.0f}s)")
    return tuple(np.stack([s[j] for s in scans]) for j in range(3))


def _count_syncs(dev, fn):
    """fn() under the CUDA sync-debug mode on a card: (its result, the call
    sites of its host syncs); off the card, no sites."""
    if dev.type != "cuda":
        return fn(), []
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return out, [f"{os.path.basename(w.filename)}:{w.lineno}" for w in caught
                 if "synchroniz" in str(w.message)]


def _loop_check_ms(pipe: LegoLoamPipeline, t: float, reps: int) -> float:
    """Mean ms of a loop check (models/loop.loop_closure_step) on the
    pipeline's state, each call synchronised on a card; the state is
    left as it was."""
    dev = pipe.device
    ms = []
    for _ in range(reps):
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        lc.loop_closure_step(pipe.mstate, t, pipe.cfg)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return float(np.mean(ms))


def run(n_laps: int = N_LAPS, chunk: int = CHUNK, radius: float = RADIUS,
        step: float = STEP, cfg: PipelineConfig | None = None, device="cuda",
        workers: int = 1, log=_log) -> dict:
    """The soak: one lap raycast once, `n_laps` laps replayed through
    LegoLoamPipeline(cfg, collect_stats=False, loop_check_every=10).
    process_chunk in chunks of `chunk` scans, the first one outside the
    timed window, the keyframe count sampled every 2nd chunk (a fall is a
    compaction).  Returns {"record": the JSON line, "extra": what the '#'
    lines print}."""
    dev = require_device(device)
    cfg = cfg or make_config()
    per_lap = scans_per_lap(radius, step, chunk)
    if per_lap == 0:
        raise ValueError(f"a lap of {2 * np.pi * radius / step:.0f} scans "
                         f"holds no chunk of {chunk}")
    n_total = n_laps * per_lap

    world = ring_world(radius=radius)
    poses = lap_poses(per_lap, radius)
    log(f"# generating {per_lap} scans (replayed x{n_laps} = {n_total})")
    t0 = time.perf_counter()
    xyz, valid, ring = (torch.as_tensor(a).to(dev) for a in
                        lap_scans(world, poses, cfg.sensor, workers, log))
    gen_s = time.perf_counter() - t0

    pipe = LegoLoamPipeline(cfg, dev, collect_stats=False,
                            loop_check_every=LOOP_CHECK_EVERY)

    def chunk_at(i):
        j = i % per_lap
        return xyz[j:j + chunk], valid[j:j + chunk], ring[j:j + chunk]

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    # the first chunk (kernel build and library set-up) before the timed
    # region
    t0 = time.perf_counter()
    r = pipe.process_chunk(*chunk_at(0))
    r.fused_poses.t.cpu()
    compile_s = time.perf_counter() - t0

    n_loops = int(r.loop_closed.sum())
    kf_peak, compactions = 0, 0
    prev_nkf = int(pipe.mstate.n_kf)
    samples = [(chunk, prev_nkf)]
    syncs, sites, compacted = [], Counter(), []
    t0 = time.perf_counter()
    for i in range(chunk, n_total, chunk):
        before = pipe.compactions

        def one_chunk():
            r = pipe.process_chunk(*chunk_at(i))
            return r, int(r.loop_closed.sum())
        (r, closed), hits = _count_syncs(dev, one_chunk)
        n_loops += closed
        syncs.append(len(hits))
        sites.update(hits)
        if pipe.compactions > before:
            # the pipeline thinned its pool in this chunk (its host count)
            compacted.append(i // chunk)
        if (i // chunk) % 2 == 0 or i + chunk >= n_total:
            # a fall of n_kf is the compaction signal: the pipeline thins
            # the pool at the solve that finds it at K-1, so the peak itself
            # is unobservable at chunk-boundary sampling; a drop proves the
            # pool filled (one scalar pull)
            n_kf = int(pipe.mstate.n_kf)
            samples.append((i + chunk, n_kf))
            log(f"# scan {i + chunk}/{n_total}: {n_kf} keyframes, "
                f"{pipe.compactions} compactions, {n_loops} loops closed, "
                f"{time.perf_counter() - t0:.0f} s")
            kf_peak = max(kf_peak, n_kf)
            if n_kf < prev_nkf:
                compactions += 1
            prev_nkf = n_kf
    r.fused_poses.t.cpu()
    wall = time.perf_counter() - t0

    # corrected keyframe trajectory vs ground truth (by stamp)
    n_kf = int(pipe.mstate.n_kf)
    kf_t = pipe.mstate.kf_t[:n_kf].cpu().numpy()
    kf_time = pipe.mstate.kf_time[:n_kf].cpu().numpy()
    idx = np.clip(np.round(kf_time / cfg.sensor.scan_period).astype(int),
                  0, n_total - 1) % per_lap
    gt = np.asarray([t for (_, t) in poses]) - poses[0][1]
    ate_corr = ate_rmse(kf_t, gt[idx])

    rec = {
        "metric": "soak_ring_road",
        "n_scans": n_total,
        "course_m": round(n_total * step, 1),
        "laps": n_laps,
        "fps": round((n_total - chunk) / wall, 1),
        "wall_s": round(wall, 1),
        "compile_s": round(compile_s, 1),
        "gen_s": round(gen_s, 1),
        "n_kf_final": n_kf,
        "n_kf_peak": kf_peak,
        "compactions_observed": compactions,
        "n_loops_closed": n_loops,
        "n_loop_edges_final": int(pipe.mstate.n_loops),
        "ate_corrected_m": round(float(ate_corr), 3),
    }
    extra = {
        "scans_per_lap": per_lap, "wall_s": wall, "gen_s": gen_s,
        "scans_per_s": (n_total - chunk) / wall,
        "ate_corrected_m": float(ate_corr), "n_kf_samples": samples,
        "compactions_in_pipeline": pipe.compactions,
        "compaction_chunks": compacted,
        "syncs_per_chunk": syncs, "sync_sites": dict(sites),
        "loop_check_ms_end": _loop_check_ms(
            pipe, (n_total - 1) * cfg.sensor.scan_period, LOOP_PROBE_REPS),
        "peak_mem_bytes": (int(torch.cuda.max_memory_allocated(dev))
                           if dev.type == "cuda" else None),
    }
    return {"record": rec, "extra": extra, "pipeline": pipe}


def failures(rec: dict, cfg: PipelineConfig) -> list:
    """The soak's four checks on its record; the ones that fail."""
    out = []
    # an observed n_kf drop proves the pool hit capacity-1 and the
    # pipeline's compaction fired in-pipeline
    if rec["compactions_observed"] < 1:
        out.append("compaction never fired in-pipeline")
    if rec["n_kf_final"] >= cfg.max_keyframes:
        out.append("pool overflowed")
    if rec["n_loop_edges_final"] <= 0:
        out.append("no loop edges survived")
    ate = rec["ate_corrected_m"]
    if not (np.isfinite(ate) and ate < ATE_LIMIT):
        out.append(f"corrected ATE {ate:.2f} m unbounded")
    return out


def parse_args(argv=None):
    """`soak [n_laps] [chunk] [--cpu]` -> (n_laps, chunk, cpu)."""
    argv = sys.argv[1:] if argv is None else list(argv)
    pos = [a for a in argv if a != "--cpu"]
    return (int(pos[0]) if len(pos) > 0 else N_LAPS,
            int(pos[1]) if len(pos) > 1 else CHUNK, "--cpu" in argv)


def main(argv=None) -> dict:
    n_laps, chunk, cpu = parse_args(argv)
    cfg = make_config()
    assert cfg.max_keyframes == 4096, "soak must run at shipping capacity"
    out = run(n_laps, chunk, cfg=cfg, device="cpu" if cpu else "cuda",
              workers=min(8, os.cpu_count() or 1))
    rec, extra = out["record"], out["extra"]
    for key, val in extra.items():
        _log(f"# {key}: {val}")
    print(json.dumps(rec), flush=True)
    bad = failures(rec, cfg)
    assert not bad, "; ".join(bad)
    _log("SOAK OK")
    return out


if __name__ == "__main__":
    main()
