#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``lego_loam_tpu_torch``) on one
NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result lines):

  1. card: name and power limit from nvidia-smi, torch and CUDA versions;
     refuses to run without a CUDA device;
  2. build: nvcc builds the three kernels of csrc/ (sm_90a) and prints the
     time and the register / shared-memory use ptxas reports;
  3. kernels against their plain PyTorch versions on the card, on inputs
     from real synthetic VLP-16 scans at the shapes of the main path:
     K1 label propagation and K2 feature picks must match exactly; K3 k-NN
     at (1024 x 8192) and (4096 x 32768), k=5, must match the distances to
     rtol 1e-4 / atol 1e-3 and return true neighbours of those distances
     (the scheme of tests/test_knn_pallas.py).  Each kernel and its plain
     version are timed with CUDA events after a warm-up (device time: the
     host's launch work is hidden behind a queued device sleep); each
     kernel's host-clock time per call, launch included, is printed beside,
     and so are its bound (the larger of its bytes over the card's memory
     rate and its operations over the FP32 rate, from this run's inputs) and
     the kernel's share of it.  K3 also prints its split count and grid, and,
     as information only, the time of torch.topk(torch.cdist(q, r)), a
     two-call composition that the port never calls;
  4. the slice: LegoLoamPipeline(config_for("vlp16", deskew=False), "cuda")
     at the full default capacities (max_keyframes=4096) over 30 scans of a
     circle course with 1 cm range noise; asserts that all three kernels
     were launched on that path and that the fused-pose ATE is under
     0.15 m; prints steady-state scans/s, per-stage ms, host syncs per scan
     and peak device memory.

deskew=False is the setting for motion-free scans: the raycaster casts
every scan from one pose.  Every other knob is the default PipelineConfig.

Prints the slice's numbers as one JSON line, then the kernel results as
{"kernels": [...]}, and as the last line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import warnings
from collections import Counter

import numpy as np

N_SCANS = 30
WARM_SCANS = 6          # scans before the timed window
SYNC_SCANS = 6          # scans at the end run under sync-debug counting
ATE_BOUND = 0.15        # m, the bound of tests/test_pipeline.py
SLEEP_CYCLES = 40_000_000   # ~20 ms of device clock ahead of each timing
# H100 SXM peaks at 700 W (NVIDIA's H100 datasheet): HBM3 and float32
# outside the tensor cores; the kernels' 32-bit integer and compare work is
# counted against the same 32-bit lane rate
MEM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, reps: int, warmup: int = 2) -> float:
    """Mean device ms per call over `reps` calls, CUDA events, after a
    warm-up.  A device-side sleep queued first lets the host enqueue the
    calls before the first one starts, so the host's launch time is hidden
    wherever `fn` does not itself wait on the card."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def call_ms(torch, fn, reps: int) -> float:
    """Mean host-clock ms per call, launch overhead included (run after
    cuda_ms, which warmed `fn` up)."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) * 1e3 / reps


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def bound(n_bytes: int, ops: float):
    """(bound_ms, bound_by): the least time the card could take for work
    that moves `n_bytes` once and does `ops` 32-bit operations."""
    t_bytes = n_bytes / MEM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def make_scans(cfg, world, poses, noise=0.01):
    from lego_loam_tpu_torch.io import synthetic as syn

    return [syn.raycast(world, R, t, cfg.sensor, noise=noise,
                        rng=np.random.default_rng(k))
            for k, (R, t) in enumerate(poses)]


def check_k1(torch, cfg, imgs):
    """K1 on every image must equal its plain version; timed on the first."""
    from lego_loam_tpu_torch.ops import segmentation as seg_ops
    from lego_loam_tpu_torch.ops.ground import mark_ground

    ms = cfg.label_prop_max_sweeps
    sweeps = []
    for img in reversed(imgs):          # ends with imgs[0]'s args, timed below
        args = seg_ops.label_inputs(*seg_ops.build_edges(img, mark_ground(img, cfg), cfg))
        got = seg_ops.propagate_labels(*args, ms)
        ref = seg_ops.propagate_labels_plain(*args, ms)
        torch.cuda.synchronize()
        sweeps.append(int(seg_ops.propagate_labels.last_sweeps))
        if not torch.equal(got, ref):
            fail(f"K1 label_prop differs from its plain version at "
                 f"{int((got != ref).sum())} pixels")
    kernel = lambda: seg_ops.propagate_labels(*args, ms)  # noqa: E731
    # each input read once, the labels written once; ~8 min / select ops a
    # pixel a sweep (4 neighbours, 4 segmented scans)
    b_ms, b_by = bound(nbytes(*args, ref), 8 * ref.numel() * sweeps[-1])
    return {
        "name": "label_prop", "route": "cuda",
        "source": "lego_loam_tpu_torch/csrc/label_prop.cu",
        "replaces": "lego_loam_tpu/ops/segmentation_pallas.py:120",
        "max_abs_err": 0.0,
        "ms": cuda_ms(torch, kernel, 50),
        "call_ms": call_ms(torch, kernel, 50),
        "plain_ms": cuda_ms(torch, lambda: seg_ops.propagate_labels_plain(*args, ms), 5),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
    }, f"equal on {len(imgs)} scans, sweeps {sweeps[::-1]}"


def check_k2(torch, cfg, imgs):
    """K2 on every image must equal its plain version; timed on the first."""
    from lego_loam_tpu_torch.ops import features as fops
    from lego_loam_tpu_torch.ops.compaction import segment_scan

    counts = []
    for img in reversed(imgs):          # ends with imgs[0]'s args, timed below
        packed, _, _, _ = segment_scan(img, cfg)
        args = fops.pick_inputs(packed, cfg) + (
            cfg.sections_total, cfg.edge_feature_num_less, cfg.edge_feature_num,
            cfg.surf_feature_num)
        lab, pick = fops.pick_features(*args)
        lab_p, pick_p = fops.pick_features_plain(*args)
        torch.cuda.synchronize()
        if not (torch.equal(lab, lab_p) and torch.equal(pick, pick_p)):
            fail(f"K2 pick_features differs from its plain version: "
                 f"{int((lab != lab_p).sum())} labels, "
                 f"{int((pick != pick_p).sum())} picked cells")
        counts.append((int((lab == 2).sum()), int((lab == -1).sum())))
        if 0 in counts[-1]:
            fail("K2 check scan produced no features")
    kernel = lambda: fops.pick_features(*args)  # noqa: E731
    # each input read once, labels and picks written once; a compare and a
    # select a cell for each of the n_corner + n_surf pick steps
    tensors = [a for a in args if isinstance(a, torch.Tensor)]
    b_ms, b_by = bound(nbytes(*tensors, lab, pick),
                       2 * lab.numel() * (args[-3] + args[-1]))
    return {
        "name": "pick_features", "route": "cuda",
        "source": "lego_loam_tpu_torch/csrc/pick_features.cu",
        "replaces": "lego_loam_tpu/ops/features_pallas.py:87",
        "max_abs_err": 0.0,
        "ms": cuda_ms(torch, kernel, 50),
        "call_ms": call_ms(torch, kernel, 50),
        "plain_ms": cuda_ms(torch, lambda: fops.pick_features_plain(*args), 5),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
    }, f"equal on {len(imgs)} scans, (sharp, flat) picks {counts[::-1]}"


def knn_case(torch, query, ref, valid, k=5):
    """Kernel vs plain k-NN on one shape; returns a dict of max_abs_err, ms,
    plain_ms, shares of identical indices and bit-equal distances, call_ms,
    cdist_topk_ms, and the bound of this shape and data."""
    from lego_loam_tpu_torch.ops import knn as knn_ops

    idx, d2 = knn_ops.knn(query, ref, valid, k)
    pidx, pd2 = knn_ops.knn_plain(query, ref, valid, k)
    torch.cuda.synchronize()
    real = pd2 < 1e29                    # slots with a true (valid) neighbour
    if not torch.equal(real, d2 < 1e29):
        fail("K3 knn: sentinel slots differ from the plain version")
    if not torch.allclose(d2[real], pd2[real], rtol=1e-4, atol=1e-3):
        fail("K3 knn distances differ from the plain version")
    # same neighbour set up to ties: each returned index is a valid point at
    # the returned distance
    il = idx.long()
    if not bool(valid[il[real]].all()):
        fail("K3 knn returned an invalid reference point")
    # the direct |q - r|^2 differs from |q|^2 + |r|^2 - 2 q.r by float32
    # cancellation: a few ulps of |q|^2 + |r|^2 (~1e-3 at 40 m)
    d_true = ((query[:, None, :] - ref[il]) ** 2).sum(-1)
    mag = (query * query).sum(1)[:, None] + (ref[il] ** 2).sum(-1)
    tol = 1e-3 + 1e-4 * d_true + 4 * 1.2e-7 * mag
    if not bool(((d_true - d2).abs() <= tol)[real].all()):
        fail("K3 knn indices do not match their distances")
    err = float((d2[real] - pd2[real]).abs().max())
    same_idx = float((idx == pidx).float().mean())
    same_d2 = float((d2[real] == pd2[real]).float().mean())
    kernel = lambda: knn_ops.knn(query, ref, valid, k)  # noqa: E731
    # each input read once, (idx, d2) written once; 8 flops (3 sub, 3 mul,
    # 2 add) a query for each valid reference
    b_ms, b_by = bound(nbytes(query, ref, valid, idx, d2),
                       8 * query.shape[0] * int(valid.sum()))
    return {
        "err": err, "same_idx": same_idx, "same_d2": same_d2,
        "bound_ms": b_ms, "bound_by": b_by,
        "ms": cuda_ms(torch, kernel, 20), "call_ms": call_ms(torch, kernel, 20),
        "plain_ms": cuda_ms(torch, lambda: knn_ops.knn_plain(query, ref, valid, k), 3),
        "cdist_topk_ms": cuda_ms(torch, lambda: torch.topk(
            torch.cdist(query, ref), k, largest=False), 3),
    }


def check_k3(torch, cfg, world, dev):
    """Maps and queries from synthetic scans: map = 6 scans around the course
    in the world frame, voxel-downsampled to the map capacities; queries =
    another scan downsampled to the scan capacities."""
    from lego_loam_tpu_torch.io import synthetic as syn
    from lego_loam_tpu_torch.ops import knn as knn_ops
    from lego_loam_tpu_torch.ops.voxel import voxel_downsample

    poses = syn.circle_trajectory(7, radius=12.0, arc=0.35 * np.pi)
    pts = []
    for k, (R, t) in enumerate(poses[:6]):
        xyz, valid, _ = syn.raycast(world, R, t, cfg.sensor, noise=0.01,
                                    rng=np.random.default_rng(100 + k))
        pts.append((xyz[valid].astype(np.float64) @ R.T + t).astype(np.float32))
    world_pts = torch.as_tensor(np.concatenate(pts), device=dev)
    wv = torch.ones(world_pts.shape[0], dtype=torch.bool, device=dev)
    R, t = poses[6]
    xyz, valid, _ = syn.raycast(world, R, t, cfg.sensor, noise=0.01,
                                rng=np.random.default_rng(106))
    q = torch.as_tensor((xyz[valid].astype(np.float64) @ R.T + t).astype(np.float32),
                        device=dev)
    qv = torch.ones(q.shape[0], dtype=torch.bool, device=dev)
    out = {}
    for tag, leaf_map, n_map, leaf_q, n_q in (
            ("corner", cfg.leaf_map_corner, cfg.max_map_corner,
             cfg.leaf_scan_corner, cfg.max_scan_corner_ds),
            ("surf", cfg.leaf_map_surf, cfg.max_map_surf,
             cfg.leaf_scan_surf, cfg.max_scan_surf_ds)):
        ref, ref_valid = voxel_downsample(world_pts, wv, leaf_map, n_map)
        query, _ = voxel_downsample(q, qv, leaf_q, n_q)
        r = out[tag] = knn_case(torch, query.contiguous(), ref.contiguous(),
                                ref_valid.contiguous())
        S = knn_ops.knn_splits(n_q, n_map)
        tiles = -(-n_q // knn_ops.QUERY_TILE)
        print(f"  K3 knn {tag}: {n_q} x {n_map}, {int(ref_valid.sum())} valid "
              f"refs: max|d2 err| {r['err']:.3g}, kernel {r['ms']:.4f} ms "
              f"(call {r['call_ms']:.4f} ms), plain {r['plain_ms']:.4f} ms, "
              f"identical indices {100 * r['same_idx']:.2f} %, bit-equal "
              f"distances {100 * r['same_d2']:.2f} %")
        print(f"  K3 knn {tag}: S = {S} splits of {-(-n_map // S)} refs, grid "
              f"{tiles} x {S} = {tiles * S} blocks"
              + (" + a merge pass, one thread a query" if S > 1 else "")
              + f"; bound {r['bound_ms']:.5f} ms ({r['bound_by']}), kernel at "
              f"{100 * r['bound_ms'] / r['ms']:.2f} % of it; information only: "
              f"topk(cdist(q, r)), a two-call composition the port never "
              f"calls, {r['cdist_topk_ms']:.4f} ms")
    c, s = out["corner"], out["surf"]
    return {
        "name": "knn", "route": "cuda",
        "source": "lego_loam_tpu_torch/csrc/knn.cu",
        "replaces": "lego_loam_tpu/ops/knn_pallas.py:81",
        "max_abs_err": max(c["err"], s["err"]),
        "ms": s["ms"], "call_ms": s["call_ms"], "plain_ms": s["plain_ms"],
        "bound_ms": s["bound_ms"], "bound_by": s["bound_by"], "library_ms": None,
    }, (f"ms/plain_ms at {cfg.max_scan_surf_ds}x{cfg.max_map_surf}; at "
        f"{cfg.max_scan_corner_ds}x{cfg.max_map_corner}: kernel {c['ms']:.4f} ms, "
        f"plain {c['plain_ms']:.4f} ms")


def run_slice(torch, cfg, scans, poses, dev):
    """The main path through process_scan; returns its numbers."""
    from lego_loam_tpu_torch.models import pipeline as pl
    from lego_loam_tpu_torch.ops import features, knn, segmentation

    wrappers = (segmentation.propagate_labels, features.pick_features, knn.knn)
    dscans = [tuple(torch.as_tensor(a, device=dev) for a in s) for s in scans]
    # a throwaway pipeline first: library handles, allocator pools and the
    # kernel library load are set-up, not part of the measured run
    warm = pl.LegoLoamPipeline(cfg, dev)
    for xyz, valid, ring in dscans[:WARM_SCANS]:
        warm.process_scan(xyz, valid, ring)
    del warm
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    pipe = pl.LegoLoamPipeline(cfg, dev)
    for w in wrappers:
        w.launches = 0
    t_win = None
    syncs = []
    sync_sites = Counter()
    n_win = N_SCANS - WARM_SCANS - SYNC_SCANS
    for k, (xyz, valid, ring) in enumerate(dscans):
        if k == WARM_SCANS:
            torch.cuda.synchronize()
            t_win = time.perf_counter()
        if k == WARM_SCANS + n_win:
            # process_scan ends in a host copy of the pose, so the window is
            # complete once the last scan of it returned
            t_win = time.perf_counter() - t_win
        if k >= WARM_SCANS + n_win:
            torch.cuda.set_sync_debug_mode("warn")
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                pipe.process_scan(xyz, valid, ring)
            torch.cuda.set_sync_debug_mode("default")
            hits = [w for w in caught if "synchroniz" in str(w.message)]
            syncs.append(len(hits))
            sync_sites.update(f"{os.path.relpath(w.filename)}:{w.lineno}"
                              for w in hits)
        else:
            pipe.process_scan(xyz, valid, ring)
    launches = {w.__name__: w.launches for w in wrappers}
    peak = torch.cuda.max_memory_allocated(dev)

    R0, t0 = poses[0]
    errs = [np.linalg.norm(R0 @ p + t0 - t)
            for p, (_, t) in zip(pipe.trajectory, poses)]
    ate = float(np.sqrt(np.mean(np.square(errs))))

    # per-stage device time: a second pass with each stage synchronised
    fe_ms, map_ms = [], []

    def timed(fn, acc):
        def wrapper(*a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            acc.append((time.perf_counter() - t) * 1e3)
            return out
        return wrapper

    orig_fe, orig_map = pl.frontend_step, pl.mp.mapping_step
    pl.frontend_step = timed(orig_fe, fe_ms)
    pl.mp.mapping_step = timed(orig_map, map_ms)
    try:
        pipe2 = pl.LegoLoamPipeline(cfg, dev)
        n_map0 = 0
        for k, (xyz, valid, ring) in enumerate(dscans):
            if k == WARM_SCANS:
                del fe_ms[:]
                n_map0 = len(map_ms)
            pipe2.process_scan(xyz, valid, ring)
        del map_ms[:n_map0]
    finally:
        pl.frontend_step, pl.mp.mapping_step = orig_fe, orig_map
    return {
        "launches": launches, "ate_m": ate, "max_err_m": float(np.max(errs)),
        "scans_per_s": n_win / t_win, "window_scans": n_win,
        "frontend_ms": float(np.mean(fe_ms)), "mapping_ms": float(np.mean(map_ms)),
        "host_syncs_per_scan": syncs, "sync_sites": dict(sync_sites),
        "peak_mem_bytes": int(peak),
        "n_kf": int(pipe.mstate.n_kf),
    }


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a card")
    from lego_loam_tpu_torch import config_for
    from lego_loam_tpu_torch.io import synthetic as syn
    from lego_loam_tpu_torch.kernels import build as kb
    from lego_loam_tpu_torch.ops.projection import project_scan

    dev = torch.device("cuda:0")
    card = card_line()
    name = torch.cuda.get_device_name(0)
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {name}, "
          f"{torch.cuda.device_count()} device(s)")

    t0 = time.perf_counter()
    kb.library()
    print(f"build: {time.perf_counter() - t0:.1f} s (nvcc "
          f"{kb.build_info['seconds']:.1f} s) -> {kb.build_info['path']}")
    for line in kb.build_info["log"].splitlines():
        if "registers" in line or "Compiling entry" in line or "bytes stack" in line:
            print(f"  ptxas: {line.strip()}")

    cfg = config_for("vlp16", deskew=False)
    world = syn.default_world(seed=0)
    poses = syn.circle_trajectory(N_SCANS, radius=12.0, arc=0.35 * np.pi)
    t0 = time.perf_counter()
    scans = make_scans(cfg, world, poses)
    print(f"scans: {len(scans)} VLP-16 raycasts in {time.perf_counter() - t0:.1f} s")

    imgs = [project_scan(*(torch.as_tensor(a, device=dev) for a in scans[k][:2]),
                         cfg, torch.as_tensor(scans[k][2], device=dev))
            for k in (0, 10, 20)]
    results = []
    for r, note in (check_k1(torch, cfg, imgs), check_k2(torch, cfg, imgs),
                    check_k3(torch, cfg, world, dev)):
        print(f"  {r['name']}: kernel {r['ms']:.4f} ms (call {r['call_ms']:.4f} "
              f"ms), plain {r['plain_ms']:.4f} ms, max|err| "
              f"{r['max_abs_err']:.3g}, bound {r['bound_ms']:.5f} ms "
              f"({r['bound_by']}), {100 * r['bound_ms'] / r['ms']:.2f} % of "
              f"bound ({note})")
        results.append(r)

    sl = run_slice(torch, cfg, scans, poses, dev)
    print(f"slice: {N_SCANS} scans, ATE {sl['ate_m']:.4f} m (max "
          f"{sl['max_err_m']:.4f} m), {sl['n_kf']} keyframes")
    print(f"slice: {sl['scans_per_s']:.2f} scans/s over {sl['window_scans']} "
          f"scans; frontend_step {sl['frontend_ms']:.2f} ms, mapping_step "
          f"{sl['mapping_ms']:.2f} ms; peak memory "
          f"{sl['peak_mem_bytes'] / 2**20:.1f} MiB")
    print(f"slice: host syncs per scan {sl['host_syncs_per_scan']}, by "
          f"call site over those scans: {sl['sync_sites']}")
    print(f"slice: kernel launches {sl['launches']}")
    for r, key in zip(results, ("propagate_labels", "pick_features", "knn")):
        r["launches"] = sl["launches"][key]
        if r["launches"] == 0:
            fail(f"kernel {r['name']} was not launched on the main path")
    if not np.isfinite(sl["ate_m"]) or sl["ate_m"] >= ATE_BOUND:
        fail(f"slice ATE {sl['ate_m']:.4f} m is not under {ATE_BOUND} m")

    print(json.dumps({"slice": sl, "card": card}))
    print(json.dumps({"kernels": [
        {key: r[key] for key in ("name", "route", "source", "replaces",
                                 "launches", "max_abs_err", "ms", "plain_ms",
                                 "bound_ms", "bound_by", "library_ms")}
        for r in results]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
