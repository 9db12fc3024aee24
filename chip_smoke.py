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
     from real synthetic VLP-16 scans at the shapes of the main path (and
     K1 at every sensor preset, below):
     K1 label propagation and K2, the whole feature-label step from the
     packed scan, must match exactly; K3 k-NN
     at (1024 x 8192) and (4096 x 32768), k=5, must match the distances to
     rtol 1e-4 / atol 1e-3 and return true neighbours of those distances
     (the scheme of tests/test_knn_pallas.py).  Each kernel and its plain
     version are timed with CUDA events after a warm-up (device time: the
     host's launch work is hidden behind a queued device sleep); each
     kernel's host-clock time per call, launch included, is printed beside,
     and so are its bound (the larger of its bytes over the card's memory
     rate and its operations over the FP32 rate, from this run's inputs; K1's
     is its bytes alone) and the kernel's share of it.  K3 prints its
     split count and grid, and, as information only, the time of
     torch.topk(torch.cdist(q, r)), a two-call composition that the port
     never calls;
  4. the slice: LegoLoamPipeline(config_for("vlp16", deskew=False), "cuda")
     at the full default capacities (max_keyframes=4096) over 30 scans of a
     circle course with 1 cm range noise; asserts that all three kernels
     were launched on that path and that the fused-pose ATE is under
     0.15 m; prints steady-state scans/s, per-stage ms, host syncs per scan
     and peak device memory;
  5. the HDL-64E path (KITTI's sensor): config_for("hdl64e", deskew=False)
     at its default, ring-scaled capacities, 9 scans (3 mapping solves) of
     tests/test_hdl64e.py's course with 2 cm range noise, each point moved
     half a row up into the middle of its elevation row (mid_row, from
     tests/test_torch_sensor_rows.py), fed without a ring channel (rows
     from elevation math); asserts that all three kernels, K1 among them,
     were launched on it and that the ATE is under tests/test_hdl64e.py's
     0.2 m; prints the same numbers as the slice;
  6. torch.profiler, after every timed phase (a profiler session can leave
     the launch path slower for the rest of the process): the device
     kernels one K2 call runs (more than 2 fails), beside those of the
     tensor-op prep it replaced; and 6 steady VLP-16 scans of a new
     pipeline: device events a scan, device busy ms a scan and the
     device's idle share.

K1 is also held against its plain version, and timed beside its bound, on
one synthetic scan of each other sensor preset (OS1-16, HDL-32E, OS1-64,
HDL-64E, VLS-128), with its block count; K2 on one scan of each of the six
presets and on the first scan of the HDL-64E path (64 x 1800, that path's
config), timed there as well.  K3's
shapes do not depend on the sensor: the map and scan capacities are not
ring-scaled.

deskew=False is the setting for motion-free scans: the raycaster casts
every scan from one pose.  Every other knob is the default PipelineConfig.

Prints the slice's and the HDL-64E path's numbers, K1's at each preset and
K2's at HDL-64E as one JSON line, then the kernel results as {"kernels": [...]} (K1 at
VLP-16's shape), and as the last line {"ok": true, "device": {...}}.
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
# the HDL-64E path: KITTI's sensor, rows from elevation math (no ring
# channel), the course and bound of tests/test_hdl64e.py, 3 mapping solves
HDL_SCANS, HDL_WARM, HDL_SYNC = 9, 3, 1
HDL_ATE_BOUND = 0.2     # m, the bound of tests/test_hdl64e.py
K1_PRESETS = ("os1_16", "hdl32e", "os1_64", "hdl64e", "vls128")
K2_PRESETS = ("vlp16",) + K1_PRESETS
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


def preset_image(torch, name, dev):
    """One synthetic scan of a sensor preset, projected on the card."""
    from lego_loam_tpu_torch import config_for
    from lego_loam_tpu_torch.io import synthetic as syn
    from lego_loam_tpu_torch.ops.projection import project_scan
    from tests.test_torch_sensor_rows import mid_row

    cfg = config_for(name)
    xyz, valid, ring = syn.raycast(syn.default_world(seed=0), np.eye(3),
                                   np.array([1.0, -2.0, 1.7]), cfg.sensor,
                                   noise=0.01, rng=np.random.default_rng(7))
    if cfg.sensor.use_ring:
        ring = torch.as_tensor(ring, device=dev)
    else:
        xyz, ring = mid_row(xyz, cfg.sensor), None
    return cfg, project_scan(torch.as_tensor(xyz, device=dev),
                             torch.as_tensor(valid, device=dev), cfg, ring)


def k1_case(torch, cfg, img):
    """K1 on one image: must equal its plain version; timed, with its bound
    (each input read once, the labels written once)."""
    from lego_loam_tpu_torch.kernels import build as kb
    from lego_loam_tpu_torch.ops import segmentation as seg_ops
    from lego_loam_tpu_torch.ops.ground import mark_ground

    ms = cfg.label_prop_max_sweeps
    args = seg_ops.label_inputs(*seg_ops.build_edges(img, mark_ground(img, cfg), cfg))
    got = seg_ops.propagate_labels(*args, ms)
    ref = seg_ops.propagate_labels_plain(*args, ms)
    torch.cuda.synchronize()
    R, H = ref.shape
    if not torch.equal(got, ref):
        fail(f"K1 label_prop differs from its plain version at "
             f"{int((got != ref).sum())} pixels of a {R}x{H} image")
    kernel = lambda: seg_ops.propagate_labels(*args, ms)  # noqa: E731
    b_ms, b_by = bound(nbytes(*args, ref), 0)
    return {
        "shape": f"{R}x{H}", "blocks": kb.library().lego_label_prop_grid(R, H),
        "ms": cuda_ms(torch, kernel, 50),
        "call_ms": call_ms(torch, kernel, 50),
        "plain_ms": cuda_ms(torch, lambda: seg_ops.propagate_labels_plain(*args, ms), 5),
        "bound_ms": b_ms, "bound_by": b_by,
    }


def check_k1(torch, cfg, imgs, dev):
    """K1 on every VLP-16 image and on one scan of each other preset must
    equal its plain version; the kernels line takes the first VLP-16 image."""
    cases = [k1_case(torch, cfg, img) for img in imgs]
    for name in K1_PRESETS:
        pcfg, img = preset_image(torch, name, dev)
        cases.append(dict(k1_case(torch, pcfg, img), preset=name))
    for c in cases:
        print(f"  K1 label_prop {c.get('preset', 'vlp16')} {c['shape']}: "
              f"{c['blocks']} blocks, kernel {c['ms']:.4f} ms (call {c['call_ms']:.4f} ms), plain "
              f"{c['plain_ms']:.4f} ms, bound {c['bound_ms']:.5f} ms "
              f"({c['bound_by']}), {100 * c['bound_ms'] / c['ms']:.2f} % of it")
    c = cases[0]
    return {
        "name": "label_prop", "route": "cuda",
        "source": "lego_loam_tpu_torch/csrc/label_prop.cu",
        "replaces": "lego_loam_tpu/ops/segmentation_pallas.py:120",
        "max_abs_err": 0.0, "library_ms": None, "presets": cases[len(imgs):],
        **{k: c[k] for k in ("ms", "call_ms", "plain_ms", "bound_ms", "bound_by")},
    }, (f"equal on {len(imgs)} VLP-16 scans and one scan each of "
        f"{', '.join(K1_PRESETS)}")


def device_kernels(torch, fn) -> list:
    """Names of the device activities (kernels, copies, fills) of one call
    of `fn`, from torch.profiler, after a warm-up call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def k2_case(torch, cfg, img, need_features=True):
    """K2 on the packed scan of one image: labels and picks must equal
    label_features_plain's; returns the packed scan, the outputs and the
    (sharp, flat) pick counts (which must not be 0 if `need_features`)."""
    from lego_loam_tpu_torch.ops import features as fops
    from lego_loam_tpu_torch.ops.compaction import segment_scan

    packed = segment_scan(img, cfg)[0]
    lab, pick = fops.label_features(packed, cfg)
    lab_p, pick_p = fops.label_features_plain(packed, cfg)
    torch.cuda.synchronize()
    R, W = lab.shape
    if not (torch.equal(lab, lab_p) and torch.equal(pick, pick_p)):
        fail(f"K2 label_features differs from its plain version at {R}x{W}: "
             f"{int((lab != lab_p).sum())} labels, "
             f"{int((pick != pick_p).sum())} picked cells")
    counts = (int((lab == 2).sum()), int((lab == -1).sum()))
    if need_features and 0 in counts:
        fail(f"K2 check scan at {R}x{W} produced no features")
    return packed, lab, pick, counts


def k2_timing(torch, cfg, packed, lab, pick):
    """K2's device and call time, its plain version's and its bound, and
    the host time of the prep it replaced (pick_inputs, the old path's
    tensor ops)."""
    from lego_loam_tpu_torch.ops import features as fops

    kernel = lambda: fops.label_features(packed, cfg)  # noqa: E731
    prep = lambda: fops.pick_inputs(packed, cfg)  # noqa: E731
    R, W = lab.shape
    counts = packed.count.clamp(0, W).sort().values.tolist()
    kept = sum(counts)
    steps = cfg.edge_feature_num_less + cfg.surf_feature_num
    # bytes: rng, valid, col, ground of each kept cell (10 B), labels and
    # picked of every cell (5 B), count (4 B a ring); operations: the
    # curvature stencil (13 a kept cell), then a compare and a select a
    # kept cell for each pick step
    b_ms, b_by = bound(10 * kept + 5 * R * W + 4 * R, kept * (13 + 2 * steps))
    return {
        "ms": cuda_ms(torch, kernel, 50), "call_ms": call_ms(torch, kernel, 50),
        "plain_ms": cuda_ms(torch, lambda: fops.label_features_plain(packed, cfg), 5),
        "bound_ms": b_ms, "bound_by": b_by, "kept_cells": kept,
        "ring_counts": (counts[0], counts[len(counts) // 2], counts[-1]),
        "prep_call_ms": call_ms(torch, prep, 20),
    }


def k2_device_kernels(torch, k2):
    """The device kernels one label_features call runs (torch.profiler; at
    most 2, or fail), beside those of the prep it replaced, on the scans K2
    was timed on.  Run after every timed phase: a profiler session can
    leave the launch path slower for the rest of the process."""
    from lego_loam_tpu_torch.ops import features as fops

    for tag, cfg, packed in k2.pop("_cases"):
        names = device_kernels(torch, lambda: fops.label_features(packed, cfg))
        if not names:
            fail("torch.profiler saw no device work in a label_features call")
        if len(names) > 2:
            fail(f"one label_features call ran {len(names)} device kernels: "
                 f"{names}")
        prep = len(device_kernels(torch, lambda: fops.pick_inputs(packed, cfg)))
        row = k2 if tag == "vlp16" else k2["hdl64e"]
        row.update(device_kernels=len(names), prep_device_kernels=prep)
        print(f"  K2 label_features {tag}: one call runs {len(names)} device "
              f"kernel(s) {sorted(set(names))} (torch.profiler), where the "
              f"replaced prep (pick_inputs) ran {prep}")


def check_k2(torch, cfg, imgs, hcfg, himg, dev):
    """K2 must equal its plain version on every VLP-16 image, on the HDL-64E
    path's first image (with that path's config) and on one scan of each
    sensor preset; timed on the first VLP-16 image, for the kernels line,
    and on the HDL-64E one."""
    cases = [k2_case(torch, cfg, img) for img in imgs]
    hcase = k2_case(torch, hcfg, himg)
    presets = {}
    for name in K2_PRESETS:
        pcfg, img = preset_image(torch, name, dev)
        presets[name] = k2_case(torch, pcfg, img, need_features=False)[3]
    rows = [("vlp16", cfg, cases[0]), ("hdl64e", hcfg, hcase)]
    out = {tag: k2_timing(torch, c, *case[:3]) for tag, c, case in rows}
    for tag, c, case in rows:
        h = out[tag]
        print(f"  K2 label_features {tag} {'x'.join(map(str, case[1].shape))} "
              f"({h['kept_cells']} kept cells, a ring's count min / median / "
              f"max {h['ring_counts']}): equal, (sharp, flat) picks "
              f"{case[3]}, kernel {h['ms']:.4f} ms (call {h['call_ms']:.4f} "
              f"ms), plain {h['plain_ms']:.4f} ms, bound {h['bound_ms']:.5f} "
              f"ms ({h['bound_by']}), {100 * h['bound_ms'] / h['ms']:.2f} % of "
              f"it; the replaced prep (pick_inputs) took "
              f"{h['prep_call_ms']:.4f} ms of host time a call")
    print(f"  K2 label_features presets: equal, (sharp, flat) picks {presets}")
    return {
        "name": "label_features", "route": "cuda",
        "source": "lego_loam_tpu_torch/csrc/pick_features.cu",
        "replaces": "lego_loam_tpu/ops/features_pallas.py:87",
        "max_abs_err": 0.0, "library_ms": None, "hdl64e": out["hdl64e"],
        "_cases": [(tag, c, case[0]) for tag, c, case in rows],
        **{k: out["vlp16"][k] for k in ("ms", "call_ms", "plain_ms",
                                        "bound_ms", "bound_by")},
    }, (f"equal on {len(imgs)} VLP-16 scans, (sharp, flat) picks "
        f"{[c[3] for c in cases]}, on the HDL-64E path's first scan and on "
        f"one scan each of {', '.join(K2_PRESETS)}")


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


def run_slice(torch, cfg, scans, poses, dev, n_warm=WARM_SCANS,
              n_sync=SYNC_SCANS):
    """The main path through process_scan: `n_warm` scans through a
    throwaway pipeline, then every scan through a new one, timed over all
    but the first `n_warm` and the last `n_sync` (which count host syncs),
    and again with each stage synchronised; returns its numbers."""
    from lego_loam_tpu_torch.models import pipeline as pl
    from lego_loam_tpu_torch.ops import features, knn, segmentation

    wrappers = (segmentation.propagate_labels, features.label_features, knn.knn)
    # an elevation-math preset takes no ring channel
    dscans = [(torch.as_tensor(xyz, device=dev), torch.as_tensor(valid, device=dev),
               torch.as_tensor(ring, device=dev) if cfg.sensor.use_ring else None)
              for xyz, valid, ring in scans]
    # a throwaway pipeline first: library handles, allocator pools and the
    # kernel library load are set-up, not part of the measured run
    warm = pl.LegoLoamPipeline(cfg, dev)
    for xyz, valid, ring in dscans[:n_warm]:
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
    n_win = len(dscans) - n_warm - n_sync
    for k, (xyz, valid, ring) in enumerate(dscans):
        if k == n_warm:
            torch.cuda.synchronize()
            t_win = time.perf_counter()
        if k == n_warm + n_win:
            # process_scan ends in a host copy of the pose, so the window is
            # complete once the last scan of it returned
            t_win = time.perf_counter() - t_win
        if k >= n_warm + n_win:
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
            if k == n_warm:
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


def profile_scans(torch, cfg, scans, dev, n_warm=3, n_prof=6):
    """Device activity of `n_prof` steady scans under torch.profiler (after
    `n_warm` through the same new pipeline): device events a scan, device
    busy ms a scan (the union of their intervals), host ms a scan under the
    profiler, and the device's idle share of that window."""
    from torch.profiler import ProfilerActivity, profile

    from lego_loam_tpu_torch.models import pipeline as pl

    pipe = pl.LegoLoamPipeline(cfg, dev)
    dscans = [(torch.as_tensor(xyz, device=dev), torch.as_tensor(valid, device=dev),
               torch.as_tensor(ring, device=dev) if cfg.sensor.use_ring else None)
              for xyz, valid, ring in scans[:n_warm + n_prof]]
    for xyz, valid, ring in dscans[:n_warm]:
        pipe.process_scan(xyz, valid, ring)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for xyz, valid, ring in dscans[n_warm:]:
            pipe.process_scan(xyz, valid, ring)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    if not spans:
        fail("torch.profiler saw no device work over the profiled scans")
    busy, lo, hi = 0.0, spans[0][0], spans[0][1]
    for a, b in spans[1:]:
        if a > hi:
            busy += hi - lo
            lo, hi = a, b
        else:
            hi = max(hi, b)
    busy += hi - lo
    return {"scans": n_prof, "device_events_per_scan": len(spans) / n_prof,
            "device_busy_ms_per_scan": busy / n_prof / 1e3,
            "host_ms_per_scan": wall_us / n_prof / 1e3,
            "device_idle_share": 1.0 - busy / wall_us}


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a card")
    from lego_loam_tpu_torch import config_for
    from lego_loam_tpu_torch.io import synthetic as syn
    from lego_loam_tpu_torch.kernels import build as kb
    from lego_loam_tpu_torch.ops.projection import project_scan
    from tests.test_torch_sensor_rows import mid_row

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
    # the HDL-64E path's scans: K2 is checked on the first one as well
    hcfg = config_for("hdl64e", deskew=False)
    hposes = syn.circle_trajectory(HDL_SCANS, radius=8.0, arc=0.18 * np.pi)
    hscans = [(mid_row(xyz, hcfg.sensor), valid, ring) for xyz, valid, ring in
              make_scans(hcfg, syn.default_world(seed=9), hposes, noise=0.02)]
    himg = project_scan(*(torch.as_tensor(a, device=dev) for a in hscans[0][:2]),
                        hcfg, None)
    results = []
    for r, note in (check_k1(torch, cfg, imgs, dev),
                    check_k2(torch, cfg, imgs, hcfg, himg, dev),
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
    for r, key in zip(results, ("propagate_labels", "label_features", "knn")):
        r["launches"] = sl["launches"][key]
        if r["launches"] == 0:
            fail(f"kernel {r['name']} was not launched on the main path")
    if not np.isfinite(sl["ate_m"]) or sl["ate_m"] >= ATE_BOUND:
        fail(f"slice ATE {sl['ate_m']:.4f} m is not under {ATE_BOUND} m")

    hl = run_slice(torch, hcfg, hscans, hposes, dev, HDL_WARM, HDL_SYNC)
    print(f"hdl64e: {HDL_SCANS} scans ({hcfg.sensor.n_scan} x "
          f"{hcfg.sensor.horizon_scan}, no ring channel), ATE {hl['ate_m']:.4f} "
          f"m (max {hl['max_err_m']:.4f} m), {hl['n_kf']} keyframes")
    print(f"hdl64e: {hl['scans_per_s']:.2f} scans/s over {hl['window_scans']} "
          f"scans; frontend_step {hl['frontend_ms']:.2f} ms, mapping_step "
          f"{hl['mapping_ms']:.2f} ms; peak memory "
          f"{hl['peak_mem_bytes'] / 2**20:.1f} MiB; host syncs per scan "
          f"{hl['host_syncs_per_scan']}; kernel launches {hl['launches']}")
    for key, count in hl["launches"].items():
        if count == 0:
            fail(f"kernel {key} was not launched on the HDL-64E path")
    if not np.isfinite(hl["ate_m"]) or hl["ate_m"] >= HDL_ATE_BOUND:
        fail(f"HDL-64E ATE {hl['ate_m']:.4f} m is not under {HDL_ATE_BOUND} m")

    # profiler phases last: they must not slow the timed ones
    k2_device_kernels(torch, results[1])
    sl["profile"] = pr = profile_scans(torch, cfg, scans, dev)
    print(f"slice: torch.profiler over {pr['scans']} steady scans: "
          f"{pr['device_events_per_scan']:.0f} device events a scan, device "
          f"busy {pr['device_busy_ms_per_scan']:.2f} ms of "
          f"{pr['host_ms_per_scan']:.2f} ms a scan (host clock, under the "
          f"profiler): device idle {100 * pr['device_idle_share']:.1f} %")

    print(json.dumps({"slice": sl, "hdl64e": hl, "k1_presets": results[0]["presets"],
                      "k2_hdl64e": results[1]["hdl64e"], "card": card}))
    print(json.dumps({"kernels": [
        {key: r[key] for key in ("name", "route", "source", "replaces",
                                 "launches", "max_abs_err", "ms", "plain_ms",
                                 "bound_ms", "bound_by", "library_ms")}
        for r in results]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
