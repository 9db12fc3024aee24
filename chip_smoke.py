#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``lego_loam_tpu_torch``) on one
NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result lines):

  1. card: name and power limit from nvidia-smi, torch and CUDA versions;
     refuses to run without a CUDA device;
  2. build: nvcc builds the four kernels of csrc/ (sm_90a; one nvcc a
     source, all started together, then one link) and prints the time and
     the register / shared-memory use ptxas reports;
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
     never calls.  E1, the 6x6 degeneracy projection (no TPU kernel behind
     it: it takes torch.linalg.eigh's host sync off the path), is held
     against its plain version (float32 eigh) on the H of the slice's first
     7 scans (every odometry round and mapping solve) and on seeded spectra
     at both thresholds: P within 1e-5, eigenvalues within 1e-5 of |H|,
     equal keep masks (a flip is allowed, and counted, only for an
     eigenvalue within that rounding of the threshold); timed on one 6x6
     beside torch.linalg.eigh + the projection (library_ms).  Then the
     reference-faithful configuration's forms (FAITHFUL below): K2 in the
     sequential order (sector_parallel=False) bit-equal to its plain
     version on the VLP-16 check scans, the HDL-64E path's first scan and
     one scan of each preset, on 8 VLP-16 scans in one vmapped launch, and
     on tests/test_features.py's scan equal to the NumPy oracle of the C++
     reference's order (oracle_extract's labels); E1 at 3x3 on the H of
     the two-step odometry's phases over 7 scans and on seeded 3x3
     spectra, held and timed as at 6x6;
  4. the slice: LegoLoamPipeline(config_for("vlp16", deskew=False), "cuda")
     at the full default capacities (max_keyframes=4096) over 30 scans of a
     circle course with 1 cm range noise; asserts that all four kernels
     were launched on that path and that the fused-pose ATE is under
     0.15 m; prints steady-state scans/s, per-stage ms, host syncs per scan
     and peak device memory, and fails unless a plain and a mapping scan
     each make exactly 1 host sync (process_scan's one copy).  A second
     process_scan run of the same scans must give bit-identical fused and
     mapped poses (no float atomic sum is left on the path).
     Then the same 30 scans through process_chunk in chunks of 10 host
     arrays, with and without collect_stats: fused and mapped poses
     within 1 mm / 0.01 deg of the per-scan run, equal stats, did_map and
     keyframe count, ATE under 0.15 m, all four kernels launched inside
     process_chunk, host syncs per chunk 1 with collect_stats and 0
     without (printed by call site), scans/s of both modes; 6 scans of
     process_scan with collect_stats=False must make no host sync.  The
     chunked run's map is exported (export_maps to a temporary directory,
     every file read back with load_pcd equal to global_map /
     keyframe_poses), dump_keyframe and dump_stages run on the card, and
     the native reader, built from native/fast_io.cpp into build/native/,
     must be the one in use, read_bin of a real scan written as a KITTI
     .bin byte-equal to it and pad_scan_native equal to pad_scan;
  4b. the reference-faithful configuration, FAITHFUL =
     config_for("vlp16", deskew=False, nn_exact=True, sector_parallel=False,
     odom_class_gate=False, edge_prominence=0.0, odom_mode="two_step",
     odom_surf_fit="tri") (tests/torch_courses.FAITHFUL) at the default
     capacities over the slice's 30 scans: scans/s, stage ms, peak memory;
     fails unless every kernel launched, K2 in the sequential order once a
     scan and E1 at 3x3 ten times a scan (2 phases x 5 rounds), 1 host
     sync a scan with collect_stats and 0 without, torch.linalg.eigh never
     called, the ATE under 0.15 m; then the course in chunks of 10
     without stats: 0 host syncs a chunk, poses within 1 mm / 0.01 deg of
     process_scan;
  5. the HDL-64E path (KITTI's sensor): config_for("hdl64e", deskew=False)
     at its default, ring-scaled capacities, 9 scans (3 mapping solves) of
     tests/test_hdl64e.py's course with 2 cm range noise, each point moved
     half a row up into the middle of its elevation row (mid_row, from
     tests/test_torch_sensor_rows.py), fed without a ring channel (rows
     from elevation math); asserts that all four kernels, K1 among them,
     were launched on it and that the ATE is under tests/test_hdl64e.py's
     0.2 m; prints the same numbers as the slice;
  6. the loop-closure path at full width:
     config_for("vlp16", deskew=False, loop_closure_enabled=True) at the
     default capacities (max_keyframes=4096, max_map_surf=32768,
     max_loop_edges=128, pg_gn_iters=6), only the course's own knobs set as
     tests/test_loop_pipeline.py sets them (tests/torch_courses.py), over
     its 16-scan out-and-back course with a loop check every 2nd scan;
     asserts that a loop closed, that all four kernels ran on the path and
     K3 inside every loop check, the ATE under 0.15 m and the final pose
     within 0.12 m of the truth; prints ms a loop check (synchronised) by
     part (gather + voxel, ICP, plane_information, solve_pose_graph), host
     syncs a loop check by call site and peak device memory.  K3 is then
     held against knn_plain at the loop check's own shapes (k = 1 for ICP,
     k = 5 for plane_information) on the inputs of a check that closed.
     Then the same course through process_chunk in chunks of 4 (the
     course's 0.55 s stamps as the sensor's scan period): the same loops
     closed as through process_scan, the final pose within 0.12 m, and at
     most 1 + one host sync a loop check in a chunk (the pending loop flag
     a later solve must read);
  7. the IMU path at full width: config_for("vlp16"), the default
     PipelineConfig (deskew=True, max_keyframes=4096, 8192 / 32768 map
     points), over the first 48 scans of bench.py's fast-yaw course
     (tests/torch_courses.py: swept raycasts, 2 cm noise, an ideal AHRS and
     accelerometer at 10 samples a sweep), written to a ROS bag and
     replayed as the port's run_rosbag replays one (its decode_bag:
     BagSource, pad_scan, quat_to_mat; then push_imu, process_scan), in
     four arms: de-skew off, on, on with the IMU, and the IMU with de-skew
     off.  Asserts that K1-K3
     launched on every arm, that the IMU adds no host sync a scan, and the
     ATE (after rigid alignment, bench.py's definition) of the stable arms:
     de-skew off under 0.15 m, the IMU with de-skew off under
     tests/test_imu.py's 0.2 m.  Prints the de-skew trio (not ordered by an
     assert: the constant-velocity de-skew diverges on this course in the
     JAX package too, ROADMAP C8), and scans/s, stage ms, peak memory and
     syncs a scan of each arm;
  8. the card against a CPU run: tests/torch_courses.py's SMALL config over
     its 6-scan course, its LOOP config over the shorter out-and-back
     course, and SMALL with deskew=True over the first 8 scans of the
     fast-yaw course with its IMU stream, each through
     LegoLoamPipeline(cfg, "cuda") and (cfg, "cpu"); fails if on any scan a
     fused or keyframe pose differs by more than 1 cm / 0.1 deg, or the
     packed stats or loop_closed differ; prints the largest gaps; and a
     chunk arm: SMALL over its 6 scans through process_chunk (chunks of 3)
     on the card against process_scan on the CPU, at the same bounds with
     equal stats and did_map; and SMALL with FAITHFUL's knobs over the
     6-scan course, at the same bounds;
  8b. the C++ reference's NumPy oracle (tests/oracle_pipeline.py, the
     reference's sequential picks, two-step LM and 3-point planes) over
     tests/test_oracle_pipeline.py's 15-scan course against the port on
     the card, in that test's config and in it with odom_mode="two_step":
     that test's bounds (oracle ATE < 0.10 m, port < 0.08 m, port against
     oracle < 0.10 m, keyframe counts within 1), except that the
     two-step port's ATE is held to 0.10 m (ROADMAP C12: the JAX
     package's two-step lands 0.093 m on that course);
  9. fleet batching at full width (models/batch.py, fleet_phase):
     config_for("vlp16", deskew=False) at the default capacities, 8
     sequences of 30 scans (sequence b: circle_trajectory(30, radius=12 +
     b / 2, arc=(0.35 + 0.02 b) pi) in default_world(0), 1 cm noise, seed
     1000 b + k; sequence 0 is the slice's course) through
     BatchPipeline(cfg, B, device="cuda").process_chunk in chunks of 10 at
     B = 1, 2, 4 and 8, vmap's per-example fallback an error: 0 host syncs
     a chunk, every kernel launched, and K1, K2, K3 and E1 launched as often
     a chunk at B = 8 as at B = 1 (K1 times its cooperative launches a call
     at B = 8, printed); each sequence at B = 8 against its own run through
     LegoLoamPipeline(cfg, "cuda").process_chunk: equal stats, did_map,
     loop flags and keyframes, fused and mapped poses within 1 cm / 0.1 deg
     (FLEET_POS_M says why not 1 mm), ATE under 0.15 m; each kernel's
     batched launch at B = 8 on the fleet's own inputs against its plain
     version a sequence at a time (K1, K2 exact; K3 distances to rtol
     1e-4 / atol 1e-3; E1 P within 1e-5), timed beside the batch's bound;
     the loop-on arm: the loop path's config at B = 2 over the out-and-back
     course and the same course in world seed 7, in chunks of 4: the same
     loops closed and stats as each sequence alone, at most one host sync
     a loop check in a chunk.  Prints aggregate scans/s, peak memory and
     syncs per B, each beside the card's name and power limit, and the
     phase's seconds;
  9b. the distributed back end (lego_loam_tpu_torch/parallel/) at world
     size 1 over NCCL (dist.init_process_group("nccl") on an in-process
     store; NCCL refuses two ranks on one device), each check failing the
     run: K3 against its plain version at knn_sharded's shard shapes over
     W = 1, 2, 4, 8 ranks (4096 x 32768 / W, the K3 phase's bounds);
     knn_sharded equal to a direct K3 call, its all-gather through NCCL
     or not; solve_pose_graph_sharded on the loop path's end state at
     full width within 1 mm / 0.01 deg of solve_pose_graph, equal over
     NCCL, with no host sync; ShardedBackend fed by the port's front end
     over the slice's 30 scans, every mapped pose within 1 mm / 0.01 deg
     of the slice's LegoLoamPipeline run with equal keyframes, every
     kernel launched, host syncs only the n_kf pull every
     compact_check_every solves, and the same run with every collective
     through NCCL equal; the loop course through ShardedBackend.loop_step:
     the pipeline's loop flags, fused poses within 1 mm and keyframes
     within 1 mm / 0.01 deg, one host sync a loop check.  Prints NCCL
     collectives a solve, ms a sharded solve against mapping_step and a
     sharded pose-graph solve against solve_pose_graph, K3 launches a
     solve and peak memory beside the card's name and power limit;
 9c. the drivers (lego_loam_tpu_torch/examples/, drivers_phase), each
     through its run() with every kernel's count set to 0 just before and
     read just after, each kernel launched in every run:
     run_synthetic at its own config (VLP-16, max_keyframes=256) over its
     30-frame circle with --loop, ATE under 0.15 m;
     run_rosbag --imu on the IMU phase's bag, its trajectory bit-equal to
     that phase's de-skew + IMU arm; run_kitti at its own config (HDL-64E,
     max_keyframes=4096) on the HDL-64E path's 9 scans written as a KITTI
     sequence (float32 x, y, z, r .bin files, KITTI-00's calibration,
     the course's poses), per scan and in chunks of 4 (the ragged tail
     per scan): ATE under 0.2 m, the two within 1 mm / 0.01 deg; the
     soak's run() at a cut depth (SOAK_CUT: a 0.545 m step, 2 laps, a
     pool of 128 keyframes, full widths otherwise), which must pass two
     of the soak's four checks (an n_kf fall seen at its samples, no
     overflow) and keep a finite trajectory; the other two (loop edges
     left, corrected ATE under 5 m) are printed: the ring road drifts
     metres a lap in both packages (ROADMAP C14), printing its
     JSON line, keyframes at each sample, compactions, host syncs a chunk,
     ms a loop check against the end pool, peak memory and seconds; and,
     last in the whole run (after phase 10: in a run that traced it
     before, phase 10's first K2 session saw no device work),
     run_synthetic --imu under utils/tracing.trace, held as the --loop
     run, whose Chrome trace must name the four kernels' custom ops
     (lego::label_prop, lego::label_features, lego::knn, lego::eig6);
 9d. robustness (robustness_phase; tests/test_robustness.py,
     tests/test_loop_robustness.py and tests/test_stress.py on the card,
     ROADMAP A20), each check failing the run: test_robustness.py's four
     courses (tests/torch_courses.robustness_course: an all-invalid scan,
     one point, 50 points; NaN and 1e8 m points; one scan four times; a
     burst of two empty scans between good ones) through process_scan at
     full width, at that test's config and (the sparse course) in
     FAITHFUL's order, every odometry, fused and keyframe pose finite, the
     repeated scan under 0.02 m, each kernel launched (counts set to 0
     just before, read just after); every kernel call of the full-width and
     FAITHFUL runs and of the corridor loop checks kept and held against
     its plain version: K1 (the empty and one-pixel images among them) and
     K2 in both pick orders (rings of 0 and of 1-11 kept cells) exact, K3
     (searches against an empty map, the loop checks' ICP and plane 5-NN,
     and built maps of 1-4 valid points in different splits of the
     mapping shape) with equal sentinel slots and indices (near ties
     counted) and distances within 1e-3, E1 at 6x6 and 3x3 (zero
     Hessians captured, zero / rank-one / rank-two ones built) as phase
     3 holds it; each timed on its most degenerate input beside its
     bound; the recovery course through process_chunk in chunks of 4 (the
     burst inside the first) within 1 mm / 0.01 deg of process_scan with
     equal stats; BatchPipeline at B = 2, the recovery course beside the
     slice course, each within 1 cm / 0.1 deg of its run alone with equal
     stats, did_map and loop flags; the recovery course at the test's
     config on the card against the CPU (C6); test_loop_robustness.py's
     corridor cases from the port's own state (tests/torch_courses.
     corridor_state) on the card and on the CPU, each held to that test's
     gates, the same decision on both and keyframes within 1 cm; and
     test_stress.py's fast-yaw (ATE and final bounds asserted) and
     corridor (finite and lateral under 0.15 m asserted; vertical and
     along printed: the JAX package misses all three, ROADMAP C2) at its
     config;
 10. torch.profiler, after every timed phase (a profiler session can leave
     the launch path slower for the rest of the process): the device
     kernels one K2 call runs (more than 2 fails), beside those of the
     tensor-op prep it replaced; 6 steady VLP-16 scans of a new pipeline:
     device events a scan, device busy ms a scan and the device's idle
     share; the same over one steady chunk of 10 scans (collect_stats=
     False); the same on the IMU course de-skewed with and without the
     IMU, whose difference is the IMU's device events a scan; 6 steady
     scans of the faithful configuration; and one steady fleet chunk of 6
     steps at B = 1 and B = 8 (device events a step).

K1 is also held against its plain version, and timed beside its bound, on
one synthetic scan of each other sensor preset (OS1-16, HDL-32E, OS1-64,
HDL-64E, VLS-128), with its block count; K2 on one scan of each of the six
presets and on the first scan of the HDL-64E path (64 x 1800, that path's
config), timed there as well.  K3's
shapes do not depend on the sensor: the map and scan capacities are not
ring-scaled.

deskew=False is the setting for motion-free scans: the raycaster casts
every scan from one pose; the IMU phase's swept scans run the default
deskew=True.  Every other knob is the default PipelineConfig.

Prints the slice's, the HDL-64E path's, the loop path's, the IMU phase's,
the chunk phases', the export's, the faithful path's, the oracle phase's,
the fleet's, the distributed back end's, the drivers' and the robustness
phase's numbers, the
card-against-CPU gaps, K1's at each preset,
K2's at HDL-64E (both orders) and E1's extras (6x6 and 3x3) as one JSON
line, then the kernel results as {"kernels": [...]}
(K1 at VLP-16's shape; K3 with its launches a loop check and its loop
shapes and its shard shapes (shard_shapes) and launches a sharded solve;
every kernel with its launches on the slice, inside the chunked run, on
the fleet's B = 8 run, on the sharded back end's run
(parallel_launches), in each run of the drivers (drivers_launches) and
on the degenerate courses (robustness_launches, with its checks and
times on the degenerate inputs under robustness),
and its batched launch at B = 8; K2's
sequential mode and E1's 3x3 form as rows of their own, launches from
the faithful path and its chunks), and
as the last line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
import warnings
from collections import Counter

import numpy as np

N_SCANS = 30
WARM_SCANS = 6          # scans before the timed window
SYNC_SCANS = 6          # scans at the end run under sync-debug counting
STAGE_SCANS = 12        # scans after the warm ones timed stage by stage
ATE_BOUND = 0.15        # m, the bound of tests/test_pipeline.py
# the HDL-64E path: KITTI's sensor, rows from elevation math (no ring
# channel), the course and bound of tests/test_hdl64e.py, 3 mapping solves
HDL_SCANS, HDL_WARM, HDL_SYNC = 9, 3, 1
HDL_ATE_BOUND = 0.2     # m, the bound of tests/test_hdl64e.py
# the IMU path: bench.py's fast-yaw de-skew course (4.3 deg of yaw a
# scan), its first IMU_SCANS scans replayed from a ROS bag: de-skew off /
# on / on with the IMU, and the IMU with de-skew off
IMU_SCANS, IMU_WARM, IMU_SYNC = 48, 6, 6
IMU_ATE_BOUND = 0.2     # m, the bound of tests/test_imu.py
# the card against a CPU run of the same scans (fused and keyframe poses)
C6_POS_M, C6_ROT_DEG = 0.01, 0.1
C6_IMU_SCANS = 8
K1_PRESETS = ("os1_16", "hdl32e", "os1_64", "hdl64e", "vls128")
K2_PRESETS = ("vlp16",) + K1_PRESETS
SLEEP_CYCLES = 40_000_000   # ~20 ms of device clock ahead of each timing
# H100 SXM peaks at 700 W (NVIDIA's H100 datasheet): HBM3 and float32
# outside the tensor cores; the kernels' 32-bit integer and compare work is
# counted against the same 32-bit lane rate
MEM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
FP64_OPS_PER_S = 34e12      # float64 outside the tensor cores (E1's Jacobi)
# chunked replay: the slice course in chunks of CHUNK_C scans, the loop
# course in chunks of LOOP_CHUNK_C, each held to its per-scan run on the card
CHUNK_C, LOOP_CHUNK_C = 10, 4
CHUNK_POS_M, CHUNK_ROT_DEG = 1e-3, 0.01
C6_CHUNK_C = 3
E1_TOL = 1e-5
# the oracle phase: tests/test_oracle_pipeline.py's bounds (m)
ORACLE_ATE, PORT_ATE, CROSS_ATE = 0.10, 0.08, 0.10
# fleet batching: FLEET_B sequences of N_SCANS scans run at B of
# FLEET_BATCHES through BatchPipeline in chunks of CHUNK_C, each sequence
# held to its own run through LegoLoamPipeline.process_chunk at B = FLEET_B
# with equal stats, did_map, keyframes and loop flags, and poses within
# FLEET_POS_M / FLEET_ROT_DEG: C6's bound for the same algorithm under other
# rounding.  A batched op rounds otherwise than its unbatched form (cuBLAS
# and the reductions pick their kernels by shape), and a course amplifies a
# last-bit change to millimetres: on an H100 the batch lands up to 7.1 mm /
# 0.043 deg from a sequence alone, the same with
# torch.use_deterministic_algorithms; two runs alone differed by up to 3.2
# mm / 0.011 deg while the voxel centroids summed with index_add atomics,
# and repeat bit for bit since their sums are exact (tests/fleet_gaps.py
# prints both).  The JAX package's
# tests/test_batch.py holds its batch to 2 cm for the same reason.
FLEET_B = 8
FLEET_POS_M, FLEET_ROT_DEG = C6_POS_M, C6_ROT_DEG
FLEET_BATCHES = (1, 2, 4, 8)
FLEET_LOOP_B = 2
VMAP_FALLBACK = "There is a performance drop"
# the drivers (lego_loam_tpu_torch/examples/): run_synthetic over its own 30
# frames, run_kitti per scan and in chunks of KITTI_CHUNK_C over the HDL-64E
# path's scans written as a KITTI sequence, and the soak at a cut depth: its
# own run() at full width (VLP-16, default map and keyframe-block caps,
# chunks of 64, loop closure on) with only the step, the laps and the pool
# cut for the run's time limit -- a 0.545 m step (576 scans a lap, a 1.64 m
# chord a mapping solve, so each solve inserts), 2 laps, and a pool of 128
# keyframes that fills in lap 1 (lap 2 revisits after the 30 s loop gap;
# the pose graph's block cyclic reduction takes a power-of-two pool)
DRIVER_FRAMES = 30
KITTI_CHUNK_C = 4
SOAK_CUT = dict(n_laps=2, chunk=64, step=0.545)
SOAK_CUT_KEYFRAMES = 128
TRACE_OPS = ("lego::label_prop", "lego::label_features", "lego::knn", "lego::eig6")
# the robustness phase: the recovery course in chunks of ROBUST_CHUNK_C (its
# burst inside the first) and beside the slice course in a fleet of
# ROBUST_FLEET_B
ROBUST_CHUNK_C, ROBUST_FLEET_B = 4, 2


class PhaseClock:
    """Seconds of each phase since the last call, printed as it ends (a
    time limit covers the whole run)."""

    def __init__(self):
        self.seconds: dict = {}
        self.name, self.t = "start, card, build, scans", time.perf_counter()

    def __call__(self, name) -> None:
        now = time.perf_counter()
        self.seconds[self.name] = round(now - self.t, 1)
        print(f"phase: {self.name} took {now - self.t:.1f} s", flush=True)
        self.name, self.t = name, now


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


def bound(n_bytes: int, ops: float, ops_per_s: float = FP32_OPS_PER_S):
    """(bound_ms, bound_by): the least time the card could take for work
    that moves `n_bytes` once and does `ops` operations (32-bit unless
    `ops_per_s` says otherwise)."""
    t_bytes = n_bytes / MEM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_wrappers():
    """The wrappers of the four kernels, each counting its launches."""
    from lego_loam_tpu_torch.ops import eig6, features, knn, segmentation

    return (segmentation.propagate_labels, features.label_features, knn.knn,
            eig6.eig6)


def mode_counts(zero: bool = False) -> dict:
    """The launches, inside their wrappers' totals, of K2 in the sequential
    order and of E1 on 3x3 matrices (set to 0 first with `zero`)."""
    from lego_loam_tpu_torch.ops import eig6, features

    if zero:
        features.label_features.launches_sequential = eig6.eig6.launches_3x3 = 0
    return {"label_features_sequential": features.label_features.launches_sequential,
            "eig6_3x3": eig6.eig6.launches_3x3}


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


def k2_bound(cfg, count, cells: int):
    """K2's bound over rings of `count` kept cells (any batch shape) and
    `cells` output cells: rng, valid, col, ground of each kept cell (10 B),
    labels and picked of every cell (5 B), count (4 B a ring); operations:
    the curvature stencil (13 a kept cell), then a compare and a select a
    kept cell for each pick step."""
    kept = int(count.clamp(0, cells // count.numel()).sum())
    steps = cfg.edge_feature_num_less + cfg.surf_feature_num
    return bound(10 * kept + 5 * cells + 4 * count.numel(), kept * (13 + 2 * steps))


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
    b_ms, b_by = k2_bound(cfg, packed.count, R * W)
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
    from torch.profiler import ProfilerActivity, profile

    from lego_loam_tpu_torch.ops import features as fops

    # a throwaway session first: the first profiler session of a process
    # can record no device activity while the tracer starts up (seen on
    # the H100 as an empty K2 count, once in four runs)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
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


def check_k2_sequential(torch, fcfg, imgs, bimgs, hcfg, himg, dev):
    """K2's sequential mode (the reference's sector-by-sector order, FAITHFUL's
    sector_parallel=False) against its plain version, bit for bit: the
    VLP-16 check scans, the HDL-64E path's first scan, one scan of each
    sensor preset, and the `bimgs` VLP-16 scans in one launch under
    torch.func.vmap against the plain version a scan at a time; and on
    tests/test_features.py's scan and config against the NumPy oracle of
    the C++ reference's order (tests/oracle_features.oracle_extract,
    labels).  Timed on the first VLP-16 scan and on the HDL-64E one."""
    from lego_loam_tpu_torch import config_for
    from lego_loam_tpu_torch.io import synthetic as syn
    from lego_loam_tpu_torch.ops import features as fops
    from lego_loam_tpu_torch.ops.compaction import segment_scan
    from lego_loam_tpu_torch.ops.projection import project_scan
    from tests import oracle_features as ofeat

    hcfg = hcfg.replace(sector_parallel=False)
    cases = [k2_case(torch, fcfg, img) for img in imgs]
    hcase = k2_case(torch, hcfg, himg)
    presets = {}
    for name in K2_PRESETS:
        pcfg, img = preset_image(torch, name, dev)
        presets[name] = k2_case(torch, pcfg.replace(sector_parallel=False), img,
                                need_features=False)[3]
    # the batch: one launch for every scan
    packed = [segment_scan(img, fcfg)[0] for img in bimgs]
    stacked = type(packed[0])(*(torch.stack(v) for v in zip(*packed)))
    n = fops.label_features.launches_sequential
    lab, pick = torch.func.vmap(lambda p: fops.label_features(p, fcfg))(stacked)
    if fops.label_features.launches_sequential != n + 1:
        fail("K2's sequential mode took more than one launch for a vmapped batch")
    for b, p in enumerate(packed):
        lp, pp = fops.label_features_plain(p, fcfg)
        if not (torch.equal(lab[b], lp) and torch.equal(pick[b], pp)):
            fail(f"K2's sequential batched launch differs from its plain version "
                 f"on scan {b}")
    # the C++ reference's order, in NumPy
    ocfg = config_for("vlp16", sector_parallel=False, edge_prominence=0.0)
    xyz, valid, ring = syn.raycast(syn.default_world(seed=5), np.eye(3),
                                   np.array([1.0, -2.0, 1.6]), ocfg.sensor, noise=0.01)
    opk = segment_scan(project_scan(*(torch.as_tensor(a, device=dev) for a in (
        xyz, valid)), ocfg, torch.as_tensor(ring, device=dev)), ocfg)[0]
    olab = fops.label_features(opk, ocfg)[0].cpu().numpy()
    oref = ofeat.oracle_extract(*(getattr(opk, f).cpu().numpy() for f in (
        "rng", "col", "ground", "valid", "count")), ocfg)[0]
    if not np.array_equal(olab, oref):
        fail(f"K2's sequential mode differs from the C++ reference's order "
             f"(oracle_extract) on {int((olab != oref).sum())} labels")
    rows = [("vlp16", fcfg, cases[0]), ("hdl64e", hcfg, hcase)]
    out = {tag: k2_timing(torch, c, *case[:3]) for tag, c, case in rows}
    for tag, c, case in rows:
        h = out[tag]
        print(f"  K2 sequential {tag} {'x'.join(map(str, case[1].shape))}: equal, "
              f"(sharp, flat) picks {case[3]}, kernel {h['ms']:.4f} ms (call "
              f"{h['call_ms']:.4f} ms), plain {h['plain_ms']:.4f} ms, bound "
              f"{h['bound_ms']:.5f} ms ({h['bound_by']}), "
              f"{100 * h['bound_ms'] / h['ms']:.2f} % of it")
    print(f"  K2 sequential presets: equal, (sharp, flat) picks {presets}; a batch "
          f"of {len(bimgs)} VLP-16 scans in one launch equal to the plain version "
          f"a scan at a time; the oracle scan's {int((olab != 0).sum())} labels "
          f"equal to oracle_extract's")
    return {
        "name": "label_features_sequential", "route": "cuda",
        "source": "lego_loam_tpu_torch/csrc/pick_features.cu",
        "replaces": "lego_loam_tpu/ops/features.py:222",
        "note": "no TPU kernel: the JAX package runs the sequential order as a "
                "loop of 144 XLA steps; a mode of K2 (pick_features_pallas, "
                "lego_loam_tpu/ops/features_pallas.py:87)",
        "max_abs_err": 0.0, "library_ms": None, "hdl64e": out["hdl64e"],
        **{k: out["vlp16"][k] for k in ("ms", "call_ms", "plain_ms",
                                        "bound_ms", "bound_by")},
    }


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
        r["inputs"] = (query.contiguous(), ref.contiguous(), ref_valid.contiguous())
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
        "_surf_inputs": s["inputs"],
    }, (f"ms/plain_ms at {cfg.max_scan_surf_ds}x{cfg.max_map_surf}; at "
        f"{cfg.max_scan_corner_ds}x{cfg.max_map_corner}: kernel {c['ms']:.4f} ms, "
        f"plain {c['plain_ms']:.4f} ms")


def feeder(dscans, stamps=None, imu=None):
    """feed(pipe, k): scan k's IMU samples through push_imu, then the scan
    through process_scan (at its stamp, or the default frame * period)."""
    def feed(pipe, k):
        for sample in (imu[k] if imu is not None else ()):
            pipe.push_imu(*sample)
        return pipe.process_scan(*dscans[k], t=None if stamps is None else stamps[k])
    return feed


def run_slice(torch, cfg, scans, poses, dev, n_warm=WARM_SCANS,
              n_sync=SYNC_SCANS, stamps=None, imu=None):
    """The main path through process_scan (with `imu`, each scan's IMU
    samples pushed before it): `n_warm` scans through a throwaway
    pipeline, then every scan through a new one, timed over all but the
    first `n_warm` and the last `n_sync` (which count host syncs, the IMU
    pushes included), and the first `n_warm` + STAGE_SCANS again with each
    stage synchronised (the stage ms over those STAGE_SCANS); returns its
    numbers."""
    from lego_loam_tpu_torch.models import pipeline as pl
    from tests.torch_courses import aligned_ate

    wrappers = kernel_wrappers()
    dscans = device_scans(torch, cfg, scans, dev)
    feed = feeder(dscans, stamps, imu)
    # a throwaway pipeline first: library handles, allocator pools and the
    # kernel library load are set-up, not part of the measured run
    warm = pl.LegoLoamPipeline(cfg, dev)
    for k in range(n_warm):
        feed(warm, k)
    del warm
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    pipe = pl.LegoLoamPipeline(cfg, dev)
    for w in wrappers:
        w.launches = 0
    mode_counts(zero=True)
    t_win = None
    syncs = []
    sync_sites = Counter()
    rows = []
    n_win = len(dscans) - n_warm - n_sync
    for k in range(len(dscans)):
        if k == n_warm:
            torch.cuda.synchronize()
            t_win = time.perf_counter()
        if k == n_warm + n_win:
            # process_scan ends in a host copy of the pose, so the window is
            # complete once the last scan of it returned
            t_win = time.perf_counter() - t_win
        if k >= n_warm + n_win:
            res, hits = catch_syncs(torch, lambda: feed(pipe, k))
            syncs.append(len(hits))
            sync_sites.update(hits)
        else:
            res = feed(pipe, k)
        rows.append(res)
    launches = {w.__name__: w.launches for w in wrappers}
    modes = mode_counts()
    peak = torch.cuda.max_memory_allocated(dev)

    R0, t0 = poses[0]
    errs = [np.linalg.norm(R0 @ p + t0 - t)
            for p, (_, t) in zip(pipe.trajectory, poses)]
    ate = float(np.sqrt(np.mean(np.square(errs))))
    ate_aligned = aligned_ate(pipe.trajectory, [t for _, t in poses])

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
        for k in range(min(len(dscans), n_warm + STAGE_SCANS)):
            if k == n_warm:
                del fe_ms[:]
                n_map0 = len(map_ms)
            feed(pipe2, k)
        del map_ms[:n_map0]
    finally:
        pl.frontend_step, pl.mp.mapping_step = orig_fe, orig_map
    return {
        "launches": launches, "mode_launches": modes,
        "ate_m": ate, "max_err_m": float(np.max(errs)),
        "ate_aligned_m": ate_aligned,
        "scans_per_s": n_win / t_win, "window_scans": n_win,
        "frontend_ms": float(np.mean(fe_ms)), "mapping_ms": float(np.mean(map_ms)),
        "host_syncs_per_scan": syncs, "sync_sites": dict(sync_sites),
        "peak_mem_bytes": int(peak),
        "n_kf": int(pipe.mstate.n_kf), "_rows": rows,
    }


def device_scans(torch, cfg, scans, dev):
    """Scans as tensors on `dev`; an elevation-math preset takes no ring."""
    return [(torch.as_tensor(xyz, device=dev), torch.as_tensor(valid, device=dev),
             torch.as_tensor(ring, device=dev) if cfg.sensor.use_ring else None)
            for xyz, valid, ring in scans]


def catch_syncs(torch, fn):
    """Runs fn() under the CUDA sync-debug mode; returns (its result, the
    call sites of the host syncs it made)."""
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return out, [f"{os.path.relpath(w.filename)}:{w.lineno}" for w in caught
                 if "synchroniz" in str(w.message)]


def run_loop_path(torch, cfg, scans, stamps, positions, every, dev):
    """The loop-closure path through process_scan at full width: a
    throwaway pipeline over the first scans (one loop check among them),
    then the course through a new one with the kernel counts set to 0
    (K3's launches and the host syncs of each loop check counted around
    it, the inputs of each check's ICP kept), then again with each part of
    a loop check synchronised and timed.  Returns its numbers."""
    from lego_loam_tpu_torch.models import loop as lc
    from lego_loam_tpu_torch.models import pipeline as pl
    from lego_loam_tpu_torch.ops import knn

    wrappers = kernel_wrappers()
    dscans = device_scans(torch, cfg, scans, dev)
    warm = pl.LegoLoamPipeline(cfg, dev, loop_check_every=every)
    for (xyz, valid, ring), t in list(zip(dscans, stamps))[:3]:
        warm.process_scan(xyz, valid, ring, t=t)
    del warm
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)

    checks, icp_inputs = [], []
    orig_step, orig_icp = pl.lc.loop_closure_step, lc.icp_align

    def counted_step(state, t, c):
        k0 = knn.knn.launches
        out, sites = catch_syncs(torch, lambda: orig_step(state, t, c))
        checks.append({"knn_launches": knn.knn.launches - k0, "syncs": sites})
        return out

    def kept_icp(src, src_val, dst, dst_val, *a, **kw):
        icp_inputs.append((src, src_val, dst, dst_val))
        return orig_icp(src, src_val, dst, dst_val, *a, **kw)

    pl.lc.loop_closure_step, lc.icp_align = counted_step, kept_icp
    try:
        pipe = pl.LegoLoamPipeline(cfg, dev, loop_check_every=every)
        for w in wrappers:
            w.launches = 0
        torch.cuda.synchronize()
        t_run = time.perf_counter()
        closed = [pipe.process_scan(xyz, valid, ring, t=t).loop_closed
                  for (xyz, valid, ring), t in zip(dscans, stamps)]
        t_run = time.perf_counter() - t_run
    finally:
        pl.lc.loop_closure_step, lc.icp_align = orig_step, orig_icp
    launches = {w.__name__: w.launches for w in wrappers}
    modes = mode_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    truth = [p - positions[0] for p in positions]
    errs = [float(np.linalg.norm(p - q)) for p, q in zip(pipe.trajectory, truth)]
    for c, closed_k in zip(checks, closed[::every]):
        c["closed"] = closed_k

    # the parts of a loop check, each synchronised (a second run)
    parts = {"gather_voxel": ("_keyframe_cloud", "voxel_downsample"),
             "icp": ("icp_align",), "plane_information": ("plane_information",),
             "solve_pose_graph": ("solve_pose_graph",)}
    timing, cur = [], {}

    def timed(fn, key):
        def wrapper(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            cur[key] = cur.get(key, 0.0) + (time.perf_counter() - t0) * 1e3
            return out
        return wrapper

    def timed_step(state, t, c):
        cur.clear()
        out = timed(orig_step, "total")(state, t, c)
        timing.append(dict(cur))
        return out

    saved = {name: getattr(lc, name) for names in parts.values() for name in names}
    for key, names in parts.items():
        for name in names:
            setattr(lc, name, timed(saved[name], key))
    pl.lc.loop_closure_step = timed_step
    try:
        pipe2 = pl.LegoLoamPipeline(cfg, dev, loop_check_every=every)
        for (xyz, valid, ring), t in zip(dscans, stamps):
            pipe2.process_scan(xyz, valid, ring, t=t)
    finally:
        pl.lc.loop_closure_step = orig_step
        for name, fn in saved.items():
            setattr(lc, name, fn)
    ms = {key: float(np.mean([c.get(key, 0.0) for c in timing]))
          for key in ("total",) + tuple(parts)}
    ms["other"] = ms["total"] - sum(ms[k] for k in parts)
    sites = Counter(s for c in checks for s in c["syncs"])
    last_closed = max((i for i, c in enumerate(checks) if c["closed"]), default=None)
    return {
        "launches": launches, "ate_m": float(np.sqrt(np.mean(np.square(errs)))),
        "final_err_m": errs[-1], "n_loops": int(pipe.mstate.n_loops),
        "n_kf": int(pipe.mstate.n_kf), "loop_closed": closed,
        "scans_per_s": len(dscans) / t_run, "loop_checks": len(checks),
        "knn_launches_per_check": [c["knn_launches"] for c in checks],
        "host_syncs_per_check": [len(c["syncs"]) for c in checks],
        "sync_sites": dict(sites), "check_ms": ms,
        "check_ms_each": [c.get("total", 0.0) for c in timing],
        "peak_mem_bytes": int(peak),
        "_icp": icp_inputs[last_closed] if last_closed is not None else None,
        "_mstate": pipe.mstate, "_traj": pipe.trajectory,
    }


def check_k3_loop(torch, icp_in):
    """K3 at the loop check's shapes, on the inputs of a loop check that
    closed on the card: k = 1 (each ICP iteration) and k = 5
    (plane_information) of the source cloud against the history submap,
    each held against knn_plain as check_k3 does."""
    from lego_loam_tpu_torch.ops import knn as knn_ops

    src, _, hist, hist_val = icp_in
    out = {}
    for k in (1, 5):
        r = knn_case(torch, src.contiguous(), hist.contiguous(),
                     hist_val.contiguous(), k)
        Q, N = src.shape[0], hist.shape[0]
        S = knn_ops.knn_splits(Q, N)
        tiles = -(-Q // knn_ops.QUERY_TILE)
        r.update(shape=f"{Q}x{N}", valid_refs=int(hist_val.sum()), splits=S,
                 blocks=tiles * S)
        out[f"k{k}"] = r
        print(f"  K3 knn loop k={k}: {Q} x {N} ({r['valid_refs']} valid "
              f"refs), S = {S} splits, {tiles * S} blocks: max|d2 err| "
              f"{r['err']:.3g}, kernel {r['ms']:.4f} ms (call "
              f"{r['call_ms']:.4f} ms), plain {r['plain_ms']:.4f} ms, bound "
              f"{r['bound_ms']:.5f} ms ({r['bound_by']}), "
              f"{100 * r['bound_ms'] / r['ms']:.2f} % of it, identical "
              f"indices {100 * r['same_idx']:.2f} %, bit-equal distances "
              f"{100 * r['same_d2']:.2f} %")
    return out


def bag_course(cfg, scans, stamps, imu, path):
    """A course written to a ROS bag at `path` and read back as a user
    replays one: the port's run_rosbag.decode_bag (BagSource events in file
    order, each cloud through pad_scan with its ring padded alike, each IMU
    orientation through quat_to_mat).  Returns the decoded (scans, stamps,
    IMU samples to push before each scan)."""
    from lego_loam_tpu_torch.examples.run_rosbag import decode_bag
    from tests.torch_courses import write_imu_bag

    write_imu_bag(path, scans, stamps, imu, cfg.sensor.scan_period)
    out_scans, out_stamps, out_imu, pending = [], [], [], []
    for kind, item in decode_bag(path, cfg):
        if kind == "imu":
            pending.append(item)
            continue
        xyz, valid, ring, t = item
        out_scans.append((xyz, valid, ring))
        out_stamps.append(t)
        out_imu.append(pending)
        pending = []
    return out_scans, out_stamps, out_imu


def same_pose(torch, a, b) -> bool:
    """Two poses (or two Nones) bit for bit."""
    if a is None or b is None:
        return a is b
    return torch.equal(a.R, b.R) and torch.equal(a.t, b.t)


def rot_gap_deg(Ra, Rb) -> float:
    d = np.asarray(Ra, np.float64).T @ np.asarray(Rb, np.float64)
    s = 0.5 * np.linalg.norm([d[2, 1] - d[1, 2], d[0, 2] - d[2, 0], d[1, 0] - d[0, 1]])
    return float(np.degrees(np.arcsin(min(s, 1.0))))


def to_cpu(x):
    """A state (NamedTuple of tensors) copied to the CPU."""
    from lego_loam_tpu_torch.utils.convert import state_from_numpy, state_to_numpy

    return state_from_numpy(state_to_numpy(x), "cpu")


def pose_gaps(Ra, ta, Rb, tb):
    """Largest translation (m) and rotation (deg) gap of two pose stacks."""
    Ra, ta, Rb, tb = (x.cpu().numpy().reshape(shape) for x, shape in (
        (Ra, (-1, 3, 3)), (ta, (-1, 3)), (Rb, (-1, 3, 3)), (tb, (-1, 3))))
    if not len(ta):
        return 0.0, 0.0
    return (float(np.abs(ta - tb).max()),
            max(rot_gap_deg(a, b) for a, b in zip(Ra, Rb)))


def card_against_cpu(torch, cfg, scans, stamps, every, dev, imu=None):
    """The same scans (and, with `imu`, the same IMU samples pushed before
    each) through LegoLoamPipeline(cfg, "cuda") and (cfg, "cpu"): on every
    scan the fused pose and every keyframe pose within C6_POS_M /
    C6_ROT_DEG, the packed stats and loop_closed equal.  Each of the card's
    mapping solves and loop checks is also run on the CPU from the card's
    own state: the loop check must land within the same bound and take the
    same decision; the solves' gaps are printed.  Returns the largest gaps
    and the list of faults."""
    from lego_loam_tpu_torch.models import pipeline as pl

    card = pl.LegoLoamPipeline(cfg, dev, loop_check_every=every)
    host = pl.LegoLoamPipeline(cfg, "cpu", loop_check_every=every)
    gap = {"fused_m": 0.0, "fused_deg": 0.0, "keyframe_m": 0.0, "keyframe_deg": 0.0,
           "same_state_solve_m": 0.0, "same_state_solve_deg": 0.0,
           "same_state_loop_m": 0.0, "same_state_loop_deg": 0.0}
    faults, closed = [], []
    orig_map, orig_loop = pl.mp.mapping_step, pl.lc.loop_closure_step

    def keep(prefix, m, deg):
        gap[prefix + "_m"] = max(gap[prefix + "_m"], m)
        gap[prefix + "_deg"] = max(gap[prefix + "_deg"], deg)

    def map_both(state, feats, opose, t, c, imu_buf=None, refresh=None):
        if state is not card.mstate:
            return orig_map(state, feats, opose, t, c, imu_buf=imu_buf,
                            refresh=refresh)
        _, T_cpu = orig_map(to_cpu(state), to_cpu(feats), to_cpu(opose), t, c,
                            imu_buf=to_cpu(imu_buf), refresh=refresh)
        out = orig_map(state, feats, opose, t, c, imu_buf=imu_buf, refresh=refresh)
        keep("same_state_solve", *pose_gaps(out[1].R, out[1].t, T_cpu.R, T_cpu.t))
        return out

    def loop_both(state, t, c):
        if state is not card.mstate:
            return orig_loop(state, t, c)
        s_cpu, r_cpu = orig_loop(to_cpu(state), t, c)
        out = orig_loop(state, t, c)
        if bool(out[1].closed) != bool(r_cpu.closed):
            faults.append(f"a loop check from one state decided {bool(out[1].closed)} "
                          f"on the card, {bool(r_cpu.closed)} on the CPU")
        n = int(s_cpu.n_kf)
        keep("same_state_loop", *pose_gaps(out[0].kf_R[:n], out[0].kf_t[:n],
                                           s_cpu.kf_R[:n], s_cpu.kf_t[:n]))
        return out

    pl.mp.mapping_step, pl.lc.loop_closure_step = map_both, loop_both
    try:
        for k, ((xyz, valid, ring), t) in enumerate(zip(scans, stamps)):
            ring = ring if cfg.sensor.use_ring else None
            for sample in (imu[k] if imu is not None else ()):
                card.push_imu(*sample)
                host.push_imu(*sample)
            rc = card.process_scan(xyz, valid, ring, t=t)
            rh = host.process_scan(xyz, valid, ring, t=t)
            _compare_scan(k, card, host, rc, rh, gap, faults, closed)
    finally:
        pl.mp.mapping_step, pl.lc.loop_closure_step = orig_map, orig_loop
    for what, bound_ in (("fused_m", C6_POS_M), ("keyframe_m", C6_POS_M),
                         ("same_state_loop_m", C6_POS_M), ("fused_deg", C6_ROT_DEG),
                         ("keyframe_deg", C6_ROT_DEG),
                         ("same_state_loop_deg", C6_ROT_DEG)):
        if gap[what] > bound_:
            faults.append(f"largest {what} gap {gap[what]:.5g} over {bound_}")
    return {"scans": len(scans), "loop_closed": closed, "gaps": gap}, faults


def _compare_scan(k, card, host, rc, rh, gap, faults, closed):
    """One scan of card_against_cpu: stats, loop_closed, fused pose and
    every keyframe pose of the two pipelines."""
    closed.append(rh.loop_closed)
    if rc.stats != rh.stats:
        faults.append(f"scan {k}: stats {rc.stats} != {rh.stats}")
    if rc.loop_closed != rh.loop_closed:
        faults.append(f"scan {k}: loop_closed {rc.loop_closed} != {rh.loop_closed}")
    m, deg = pose_gaps(rc.fused_pose.R, rc.fused_pose.t, rh.fused_pose.R, rh.fused_pose.t)
    gap["fused_m"], gap["fused_deg"] = max(gap["fused_m"], m), max(gap["fused_deg"], deg)
    n = int(host.mstate.n_kf)
    if int(card.mstate.n_kf) != n:
        faults.append(f"scan {k}: {int(card.mstate.n_kf)} keyframes != {n}")
        return
    m, deg = pose_gaps(card.mstate.kf_R[:n], card.mstate.kf_t[:n],
                       host.mstate.kf_R[:n], host.mstate.kf_t[:n])
    gap["keyframe_m"] = max(gap["keyframe_m"], m)
    gap["keyframe_deg"] = max(gap["keyframe_deg"], deg)


def profile_scans(torch, cfg, scans, dev, n_warm=3, n_prof=6, stamps=None,
                  imu=None):
    """Device activity of `n_prof` steady scans under torch.profiler (after
    `n_warm` through the same new pipeline; with `imu`, each scan's samples
    pushed first): see profile_window."""
    from lego_loam_tpu_torch.models import pipeline as pl

    pipe = pl.LegoLoamPipeline(cfg, dev)
    feed = feeder(device_scans(torch, cfg, scans[:n_warm + n_prof], dev), stamps, imu)
    for k in range(n_warm):
        feed(pipe, k)
    return profile_window(torch, lambda: [feed(pipe, k) for k in range(
        n_warm, n_warm + n_prof)], n_prof)


def profile_chunk(torch, cfg, scans, dev, C=CHUNK_C):
    """The same for one steady chunk of C scans through process_chunk with
    collect_stats=False (after one chunk through the same new pipeline)."""
    from lego_loam_tpu_torch.models import pipeline as pl

    pipe = pl.LegoLoamPipeline(cfg, dev, collect_stats=False)
    chunks = host_chunks(scans[:2 * C], C)
    pipe.process_chunk(*chunks[0])
    return profile_window(torch, lambda: pipe.process_chunk(*chunks[1]), C)


def profile_window(torch, fn, n_prof):
    """fn() (n_prof scans' work) under torch.profiler, synchronised: device
    events a scan, device busy ms a scan (the union of their intervals),
    host ms a scan under the profiler, and the device's idle share of that
    window, and the seconds the trace took to parse.  The profiler records
    device activity only: nothing here reads the host's op events, and
    recording them stretched each window to 2-4x a scan's unprofiled host
    time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
    t = time.perf_counter()
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    parse_s = time.perf_counter() - t
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
            "device_idle_share": 1.0 - busy / wall_us, "parse_s": parse_s}


def capture_eig6_inputs(torch, cfg, scans, dev):
    """The (H, thresh) of every degeneracy projection of the slice's first
    scans through a pipeline on the card: 5 odometry rounds a scan
    (odom_degen_eig_thresh) and 1 a mapping solve (map_degen_eig_thresh)."""
    from lego_loam_tpu_torch.models import odometry as odo
    from lego_loam_tpu_torch.models import pipeline as pl

    kept = []
    orig = odo.degeneracy_projection

    def keep(H, thresh):
        kept.append((H.detach().clone(), float(thresh)))
        return orig(H, thresh)

    odo.degeneracy_projection = keep
    try:
        pipe = pl.LegoLoamPipeline(cfg, dev)
        for xyz, valid, ring in device_scans(torch, cfg, scans, dev):
            pipe.process_scan(xyz, valid, ring)
    finally:
        odo.degeneracy_projection = orig
    return kept


def e1_bytes(n: int = 6) -> int:
    """E1's bytes for one n x n matrix: H read, P, lam and the sweep count
    written (316 B at 6x6, 88 B at 3x3)."""
    return 4 * (2 * n * n + n + 1)


E1_BYTES = e1_bytes()


def e1_ops(sweeps: int, n: int = 6) -> int:
    """E1's float64 operations for one n x n matrix: the symmetrisation
    (2 n^2), `sweeps` Jacobi sweeps of n (n - 1) / 2 rotations (angle ~10
    operations, then two rows and two columns of A and two columns of V,
    n x (4 mul + 2 add) each) with their off-diagonal sums (n (n - 1)),
    and P (n^2 entries of n terms, 3 operations each)."""
    return (2 * n * n + sweeps * (n * (n - 1) // 2 * (10 + 18 * n) + n * (n - 1))
            + 3 * n ** 3)


def e1_bound(sweeps: int, n: int = 6):
    """E1's bound for one n x n matrix, from e1_bytes and e1_ops."""
    return bound(e1_bytes(n), e1_ops(sweeps, n), FP64_OPS_PER_S)


def e1_compare(torch, H, th):
    """E1 on a (B, n, n) stack against its plain version at threshold th:
    P within E1_TOL, eigenvalues within E1_TOL of |H|, equal keep masks (a
    mask may differ only where an eigenvalue lies within E1_TOL |H| of the
    threshold, counted); fails otherwise.  Returns (max |dP| where the
    masks agree, max |dlam| / |H|, the masks that differ, most sweeps)."""
    from lego_loam_tpu_torch.ops import eig6

    n = H.shape[-1]
    P, lam, sw = eig6.eig6(H, th)
    P_ref, lam_ref = eig6.degeneracy_projection_plain(H, th)
    scale = H.abs().amax(dim=(1, 2)).clamp(min=1.0)
    d_p = (P - P_ref).abs().amax(dim=(1, 2))
    d_lam = (lam - lam_ref).abs().amax(dim=1) / scale
    same_mask = ((lam >= th) == (lam_ref >= th)).all(dim=1)
    at_thresh = ((lam_ref - th).abs() <= E1_TOL * scale[:, None]).any(dim=1)
    bad = (d_lam > E1_TOL) | (~same_mask & ~at_thresh) | (same_mask & (d_p > E1_TOL))
    if bool(bad.any()):
        i = int(bad.nonzero()[0, 0])
        fail(f"E1 eig6 ({n}x{n}) differs from its plain version at threshold "
             f"{th} on matrix {i}: |dP| {float(d_p[i]):.3g}, |dlam|/|H| "
             f"{float(d_lam[i]):.3g}, keep masks equal {bool(same_mask[i])}")
    return (float(d_p[same_mask].max()) if bool(same_mask.any()) else 0.0,
            float(d_lam.max()), int((~same_mask).sum()), int(sw.max()))


def check_e1(torch, cfg, captured, dev, n=6):
    """E1 against its plain version on the card, on n x n matrices: the
    captured H of real odometry rounds and mapping solves (6x6), or of the
    two-step odometry's phases (3x3), and the seeded spectra of
    tests/torch_courses.eig6_spectra, batched by threshold.  P within
    E1_TOL, eigenvalues within E1_TOL of |H|, equal keep masks; a mask may
    differ only where an eigenvalue lies within E1_TOL |H| of the threshold
    (float32 eigh against float64 Jacobi), which is counted and printed.
    Timed on one captured odometry H, the main path's call."""
    from lego_loam_tpu_torch.ops import eig6
    from tests.torch_courses import eig6_spectra

    captured = [c for c in captured if c[0].shape[-1] == n]
    groups = {}
    for H, th in captured:
        groups.setdefault(th, []).append(H)
    n_captured = {th: len(v) for th, v in groups.items()}
    for th in (cfg.odom_degen_eig_thresh, cfg.map_degen_eig_thresh):
        groups.setdefault(th, []).extend(
            torch.as_tensor(h, device=dev) for _, h in eig6_spectra(th, n=n))
    worst_p = worst_lam = 0.0
    near = sweeps_max = 0
    for th, items in groups.items():
        d_p, d_lam, flips, sw = e1_compare(torch, torch.stack(items).contiguous(), th)
        near += flips
        worst_p, worst_lam = max(worst_p, d_p), max(worst_lam, d_lam)
        sweeps_max = max(sweeps_max, sw)

    # timed on the first odometry round of the third scan (the first scan
    # has no references yet: its rounds see H = 0); the block odometry
    # projects 5 times a scan, the two-step 10
    per_scan = cfg.odom_outer_iters * (1 if n == 6 else 2)
    H1, th1 = [c for c in captured if c[1] == cfg.odom_degen_eig_thresh][2 * per_scan]
    kernel = lambda: eig6.degeneracy_projection(H1, th1)  # noqa: E731
    plain = lambda: eig6.degeneracy_projection_plain(H1, th1)  # noqa: E731

    def library():
        lam, V = torch.linalg.eigh(H1)
        return (V * (lam >= th1).to(H1.dtype)) @ V.T

    sweeps1 = int(eig6.eig6(H1[None], th1)[2][0])
    b_ms, b_by = e1_bound(sweeps1, n)
    out = {
        "name": "eig6" if n == 6 else f"eig6_{n}x{n}", "route": "cuda",
        "source": "lego_loam_tpu_torch/csrc/eig6.cu",
        "replaces": "lego_loam_tpu/models/odometry.py:340",
        "note": "no TPU kernel: _degeneracy_projection's jnp.linalg.eigh, which "
                "torch.linalg.eigh would run with a host sync"
                + ("" if n == 6 else "; the two-step odometry's 3x3 phases"),
        "max_abs_err": max(worst_p, worst_lam),
        "ms": cuda_ms(torch, kernel, 200), "call_ms": call_ms(torch, kernel, 200),
        "plain_ms": cuda_ms(torch, plain, 50), "library_ms": cuda_ms(torch, library, 50),
        "library_call_ms": call_ms(torch, library, 50),
        "bound_ms": b_ms, "bound_by": b_by, "sweeps": sweeps1,
        "matrices": {str(th): len(v) for th, v in groups.items()},
        "captured": {str(th): k for th, k in n_captured.items()},
        "near_threshold_flips": near, "max_sweeps": sweeps_max,
    }
    print(f"  E1 eig6 {n}x{n}: {sum(map(len, groups.values()))} matrices "
          f"({out['captured']} captured from odometry rounds / mapping solves "
          f"by threshold, the rest seeded spectra): max|dP| {worst_p:.3g}, "
          f"max|dlam|/|H| {worst_lam:.3g}, keep masks equal except "
          f"{near} at the threshold, at most {sweeps_max} sweeps; one {n}x{n} "
          f"({sweeps1} sweeps): kernel {out['ms']:.4f} ms (call "
          f"{out['call_ms']:.4f} ms), plain {out['plain_ms']:.4f} ms, "
          f"torch.linalg.eigh + projection {out['library_ms']:.4f} ms (call "
          f"{out['library_call_ms']:.4f} ms, a host sync each), bound "
          f"{b_ms:.7f} ms ({b_by}), {100 * b_ms / out['ms']:.3f} % of it")
    return out


def host_chunks(scans, C):
    """(xyz, valid, ring) host arrays of C scans each (the last may be
    shorter), as a replay hands them to process_chunk."""
    return [tuple(np.stack([s[i] for s in scans[k:k + C]]) for i in range(3))
            for k in range(0, len(scans), C)]


def run_chunks(torch, cfg, scans, dev, C, collect_stats=True, every=10):
    """The course through process_chunk in chunks of C host arrays: one
    chunk through a throwaway pipeline, then the course through a new one
    with the kernel counts set to 0 just before, each chunk under the
    sync-debug counting.  Returns the pipeline, the chunk results, the host
    syncs of each chunk and by call site, the launches and scans/s (the
    whole course, synchronised at its end)."""
    from lego_loam_tpu_torch.models import pipeline as pl

    chunks = host_chunks(scans, C)
    warm = pl.LegoLoamPipeline(cfg, dev, loop_check_every=every,
                               collect_stats=collect_stats)
    warm.process_chunk(*chunks[0])
    del warm
    torch.cuda.synchronize()
    pipe = pl.LegoLoamPipeline(cfg, dev, loop_check_every=every,
                               collect_stats=collect_stats)
    wrappers = kernel_wrappers()
    for w in wrappers:
        w.launches = 0
    mode_counts(zero=True)
    results, syncs, sites = [], [], Counter()
    t = time.perf_counter()
    for ch in chunks:
        res, hits = catch_syncs(torch, lambda: pipe.process_chunk(*ch))
        results.append(res)
        syncs.append(len(hits))
        sites.update(hits)
    torch.cuda.synchronize()
    t = time.perf_counter() - t
    return {"pipe": pipe, "results": results, "syncs_per_chunk": syncs,
            "sync_sites": dict(sites), "scans_per_s": len(scans) / t,
            "launches": {w.__name__: w.launches for w in wrappers},
            "mode_launches": mode_counts()}


def chunk_gaps(torch, results, rows):
    """Largest gaps of the stacked chunk results to per-scan FrameResults:
    fused and mapped poses (m, deg), and the scans whose did_map or stats
    differ."""
    from lego_loam_tpu_torch.models.pipeline import STAT_NAMES

    def cat(f):
        return torch.cat([f(r) for r in results])

    def stack(poses):
        poses = list(poses)
        return torch.stack([p.R for p in poses]), torch.stack([p.t for p in poses])

    did_map = cat(lambda r: r.did_map).tolist()
    stats = cat(lambda r: r.stats).tolist()
    ref_map = [r.mapped_pose is not None for r in rows]
    mk = [k for k, m in enumerate(ref_map) if m]
    fused = pose_gaps(cat(lambda r: r.fused_poses.R), cat(lambda r: r.fused_poses.t),
                      *stack(r.fused_pose for r in rows))
    mapped = pose_gaps(cat(lambda r: r.mapped_poses.R)[mk],
                       cat(lambda r: r.mapped_poses.t)[mk],
                       *stack(rows[k].mapped_pose for k in mk))
    bad = [k for k, r in enumerate(rows)
           if did_map[k] != ref_map[k] or (r.stats and stats[k] != [
               r.stats[n] for n in STAT_NAMES])]
    return {"fused_m": fused[0], "fused_deg": fused[1], "mapped_m": mapped[0],
            "mapped_deg": mapped[1], "mapped_scans": len(mk)}, bad


def check_export(torch, pipe, cfg, scan, n_valid, dev):
    """The map export of a chunked run: export_maps to a temporary
    directory, every file read back with load_pcd equal to global_map /
    keyframe_poses; dump_keyframe and dump_stages on the card (dump_stages'
    projected count must equal the scan's n_valid_px); the native reader
    built from this checkout and in use, its pad_scan_native equal to
    kitti.pad_scan on a real scan, and read_bin of that scan written as a
    KITTI .bin byte-equal to it."""
    from lego_loam_tpu_torch.io import kitti, pcd
    from lego_loam_tpu_torch.native import fast_io
    from lego_loam_tpu_torch.utils import debug

    out = {}
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        written = pcd.export_maps(pipe, d)
        out["export_s"] = time.perf_counter() - t0
        maps = {name: pipe.global_map(name) for name in ("corner", "surf", "outlier")}
        expect = {"cornerMap.pcd": maps["corner"], "surfaceMap.pcd": maps["surf"],
                  "trajectory.pcd": pipe.keyframe_poses(),
                  "finalCloud.pcd": np.concatenate([maps["corner"], maps["surf"],
                                                    maps["outlier"]])}
        for name, ref in expect.items():
            got = pcd.load_pcd(os.path.join(d, name))
            if got.shape != ref.shape or got.tobytes() != ref.astype(np.float32).tobytes():
                fail(f"{name} read back differs from what it was written from")
        out["points"] = {os.path.basename(p): n for p, n in written.items()}
        out["dump_keyframe"] = debug.dump_keyframe(pipe, int(pipe.mstate.n_kf) - 1, d)
        out["dump_stages"] = debug.dump_stages(cfg, *scan, out_dir=d, prefix="s0_",
                                               device=dev)
        if out["dump_stages"]["projected"] != n_valid:
            fail(f"dump_stages projected {out['dump_stages']['projected']} points, "
                 f"the pipeline's stats {n_valid}")
        if not fast_io.available():
            fail(f"the native reader did not build: {fast_io.build_info}")
        lib = fast_io.build_info["path"]
        if os.path.dirname(lib) != str(fast_io.BUILD_DIR):
            fail(f"the native reader in use is {lib}, not this checkout's build")
        xyz, valid, ring = scan
        pts = np.concatenate([xyz[valid], ring[valid, None].astype(np.float32)], 1)
        pts[::97, 1] = np.nan           # no-return beams, as sensors report them
        pts[::89, 0] = np.inf
        path = os.path.join(d, "000000.bin")
        pts.tofile(path)
        if kitti.read_bin(path).tobytes() != pts.tobytes():
            fail("kitti.read_bin through the native reader differs from the file")
        a_xyz, a_valid = kitti.pad_scan(pts, cfg)
        b_xyz, b_valid = fast_io.pad_scan_native(pts, a_xyz.shape[0])
        if a_xyz.tobytes() != b_xyz.tobytes() or not np.array_equal(a_valid, b_valid):
            fail("pad_scan_native differs from kitti.pad_scan on a real scan")
        out["native"] = {"library": os.path.relpath(lib), "points": int(len(pts)),
                         "invalid": int((~b_valid[:len(pts)]).sum())}
    return out


def card_against_cpu_chunks(torch, cfg, scans, dev, C=C6_CHUNK_C):
    """C6's chunk arm: the scans through process_chunk on the card (chunks of
    C) and process_scan on the CPU: every fused pose and, after each chunk,
    every keyframe pose within C6_POS_M / C6_ROT_DEG, stats and did_map
    equal.  Returns the largest gaps and the list of faults."""
    from lego_loam_tpu_torch.models import pipeline as pl

    card = pl.LegoLoamPipeline(cfg, dev)
    host = pl.LegoLoamPipeline(cfg, "cpu")
    faults, rows = [], []
    gap = {"keyframe_m": 0.0, "keyframe_deg": 0.0}
    results = []
    for k0, ch in zip(range(0, len(scans), C), host_chunks(scans, C)):
        results.append(card.process_chunk(*ch))
        rows.extend(host.process_scan(*s) for s in scans[k0:k0 + C])
        n = int(host.mstate.n_kf)
        if int(card.mstate.n_kf) != n:
            faults.append(f"after scan {k0 + C - 1}: {int(card.mstate.n_kf)} "
                          f"keyframes != {n}")
            continue
        m, deg = pose_gaps(card.mstate.kf_R[:n], card.mstate.kf_t[:n],
                           host.mstate.kf_R[:n], host.mstate.kf_t[:n])
        gap["keyframe_m"] = max(gap["keyframe_m"], m)
        gap["keyframe_deg"] = max(gap["keyframe_deg"], deg)
    g, bad = chunk_gaps(torch, results, rows)
    gap.update(g)
    if bad:
        faults.append(f"scans {bad}: did_map or stats differ")
    for what, lim in (("fused_m", C6_POS_M), ("keyframe_m", C6_POS_M),
                      ("fused_deg", C6_ROT_DEG), ("keyframe_deg", C6_ROT_DEG)):
        if gap[what] > lim:
            faults.append(f"largest {what} gap {gap[what]:.5g} over {lim}")
    return {"scans": len(scans), "chunk": C, "gaps": gap}, faults


# ------------------------------------------------- the faithful config

def faithful_phase(torch, fcfg, scans, poses, dev):
    """The reference-faithful configuration (tests/torch_courses.FAITHFUL)
    at full width over the slice's 30-scan course: run_slice (scans/s,
    stage ms, peak memory, 1 host sync a scan), 0 host syncs a scan with
    collect_stats=False, the course in chunks of CHUNK_C without stats (0
    syncs a chunk, poses within CHUNK_POS_M / CHUNK_ROT_DEG of process_scan,
    equal did_map and keyframes), ATE under ATE_BOUND, every kernel
    launched, K2 in the sequential order once a scan and E1 at 3x3 twice a
    round (two phases of odom_outer_iters rounds a scan); torch.linalg.eigh
    is never called.  Returns its numbers."""
    from lego_loam_tpu_torch.models import pipeline as pl

    eigh_calls = []
    orig_eigh = torch.linalg.eigh

    def eigh(*a, **kw):
        eigh_calls.append(1)
        return orig_eigh(*a, **kw)

    torch.linalg.eigh = eigh
    try:
        fl = run_slice(torch, fcfg, scans, poses, dev)
        rows = fl.pop("_rows")
        nopipe = pl.LegoLoamPipeline(fcfg, dev, collect_stats=False)
        fl["process_scan_no_stats_syncs"] = [
            len(catch_syncs(torch, lambda s=s: nopipe.process_scan(*s))[1])
            for s in device_scans(torch, fcfg, scans[:SYNC_SCANS], dev)]
        del nopipe
        ch = run_chunks(torch, fcfg, scans, dev, CHUNK_C, False)
    finally:
        torch.linalg.eigh = orig_eigh
    pipe_c, res_c = ch.pop("pipe"), ch.pop("results")
    ch["gaps"], bad = chunk_gaps(torch, res_c, rows)
    ch["n_kf"] = int(pipe_c.mstate.n_kf)
    fl["chunk"] = ch
    fl["torch_linalg_eigh_calls"] = len(eigh_calls)
    n = len(scans)
    want = {"label_features_sequential": n, "eig6_3x3": 2 * fcfg.odom_outer_iters * n}
    g = ch["gaps"]
    print(f"faithful: {n} scans, ATE {fl['ate_m']:.4f} m (max {fl['max_err_m']:.4f} "
          f"m), {fl['n_kf']} keyframes; {fl['scans_per_s']:.2f} scans/s over "
          f"{fl['window_scans']} scans; frontend_step {fl['frontend_ms']:.2f} ms, "
          f"mapping_step {fl['mapping_ms']:.2f} ms; peak memory "
          f"{fl['peak_mem_bytes'] / 2**20:.1f} MiB")
    print(f"faithful: host syncs per scan {fl['host_syncs_per_scan']} by site "
          f"{fl['sync_sites']}, with collect_stats=False "
          f"{fl['process_scan_no_stats_syncs']}; kernel launches {fl['launches']}, of "
          f"which {fl['mode_launches']}; torch.linalg.eigh calls "
          f"{len(eigh_calls)}")
    print(f"faithful chunks (no stats): {n} scans in chunks of {CHUNK_C}, "
          f"{ch['scans_per_s']:.2f} scans/s; against process_scan fused "
          f"{g['fused_m'] * 1e3:.4f} mm / {g['fused_deg']:.5f} deg, mapped "
          f"({g['mapped_scans']} solves) {g['mapped_m'] * 1e3:.4f} mm / "
          f"{g['mapped_deg']:.5f} deg; host syncs per chunk {ch['syncs_per_chunk']} "
          f"by site {ch['sync_sites']}; kernel launches {ch['launches']}, of which "
          f"{ch['mode_launches']}")
    if eigh_calls:
        fail(f"torch.linalg.eigh ran {len(eigh_calls)} times on the faithful path")
    for key, count in list(fl["launches"].items()) + list(ch["launches"].items()):
        if count == 0:
            fail(f"kernel {key} was not launched on the faithful path")
    for tag, got in (("process_scan", fl["mode_launches"]),
                     ("process_chunk", ch["mode_launches"])):
        if got != want:
            fail(f"faithful {tag}: launches of K2's sequential mode / E1 at 3x3 "
                 f"{got}, not {want}")
    if fl["host_syncs_per_scan"] != [1] * SYNC_SCANS:
        fail(f"faithful: host syncs per scan {fl['host_syncs_per_scan']}, not 1 "
             f"each ({fl['sync_sites']})")
    if any(fl["process_scan_no_stats_syncs"]):
        fail(f"faithful process_scan with collect_stats=False synced: "
             f"{fl['process_scan_no_stats_syncs']}")
    if any(ch["syncs_per_chunk"]):
        fail(f"faithful chunks: host syncs per chunk {ch['syncs_per_chunk']}, not 0 "
             f"({ch['sync_sites']})")
    if bad:
        fail(f"faithful chunks: did_map differs from process_scan on scans {bad}")
    if g["fused_m"] > CHUNK_POS_M or g["mapped_m"] > CHUNK_POS_M or \
            g["fused_deg"] > CHUNK_ROT_DEG or g["mapped_deg"] > CHUNK_ROT_DEG:
        fail(f"faithful chunk poses differ from process_scan by {g}")
    if ch["n_kf"] != fl["n_kf"]:
        fail(f"faithful chunks: {ch['n_kf']} keyframes against {fl['n_kf']}")
    if not np.isfinite(fl["ate_m"]) or fl["ate_m"] >= ATE_BOUND:
        fail(f"faithful ATE {fl['ate_m']:.4f} m is not under {ATE_BOUND} m")
    return fl


def _traj_ate(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.sqrt(np.mean(np.sum((a - b) ** 2, axis=1))))


def oracle_phase(torch, dev):
    """The port on the card against the NumPy oracle of the whole C++
    reference pipeline (tests/oracle_pipeline.OraclePipeline: the
    reference's sequential picks, two-step LM, 3-point planes) over
    tests/test_oracle_pipeline.py's 15-scan course, in that test's config
    (tests/torch_courses.ORACLE_CFG, whose odometry is the block schedule)
    and in it with odom_mode="two_step" (FAITHFUL's odometry).  Each arm
    is held to the test's bounds: the oracle's ATE under ORACLE_ATE, the
    port's under PORT_ATE, port against oracle under CROSS_ATE, keyframe
    counts within 1; in the two-step arm the port's ATE is held to
    ORACLE_ATE instead of PORT_ATE (ROADMAP C12: the JAX package's
    two-step lands 0.093 m on this course on the CPU, the port 0.093 m
    there, where the block schedule lands 0.033 m)."""
    from lego_loam_tpu_torch import config_for
    from lego_loam_tpu_torch.models import pipeline as pl
    from tests.oracle_pipeline import OraclePipeline
    from tests.torch_courses import ORACLE_CFG, oracle_course

    cfg = config_for("vlp16", **ORACLE_CFG)
    poses, scans = oracle_course(cfg.sensor)
    gt = np.asarray([t for _, t in poses]) - poses[0][1]
    orc = OraclePipeline(cfg)
    t = time.perf_counter()
    for sc in scans:
        orc.process_scan(*sc)
    out = {"oracle_s_per_scan": (time.perf_counter() - t) / len(scans),
           "oracle_ate_m": _traj_ate(orc.trajectory, gt), "oracle_n_kf": len(orc.kf_R)}
    faults = []
    for tag, over, port_bound in (("test_cfg", {}, PORT_ATE),
                                  ("two_step", dict(odom_mode="two_step"), ORACLE_ATE)):
        pcfg = cfg.replace(**over)
        pipe = pl.LegoLoamPipeline(pcfg, dev, collect_stats=False)
        for sc in device_scans(torch, pcfg, scans, dev):
            pipe.process_scan(*sc)
        traj = pipe.trajectory_numpy()
        arm = out[tag] = {"port_ate_m": _traj_ate(traj, gt),
                          "port_vs_oracle_m": _traj_ate(traj, orc.trajectory),
                          "n_kf": int(pipe.mstate.n_kf), "port_ate_bound_m": port_bound}
        print(f"oracle [{tag}, odom_mode={pcfg.odom_mode}]: {len(scans)} scans, "
              f"oracle ATE {out['oracle_ate_m']:.4f} m ({out['oracle_n_kf']} "
              f"keyframes, {out['oracle_s_per_scan']:.2f} s a scan on the host), "
              f"port ATE {arm['port_ate_m']:.4f} m ({arm['n_kf']} keyframes), port "
              f"against oracle {arm['port_vs_oracle_m']:.4f} m")
        if not arm["port_ate_m"] < port_bound:
            faults.append(f"{tag}: port ATE {arm['port_ate_m']:.4f} m over {port_bound}")
        if not arm["port_vs_oracle_m"] < CROSS_ATE:
            faults.append(f"{tag}: port against oracle {arm['port_vs_oracle_m']:.4f} m "
                          f"over {CROSS_ATE}")
        if abs(arm["n_kf"] - out["oracle_n_kf"]) > 1:
            faults.append(f"{tag}: {arm['n_kf']} keyframes against the oracle's "
                          f"{out['oracle_n_kf']}")
    if not out["oracle_ate_m"] < ORACLE_ATE:
        faults.append(f"oracle ATE {out['oracle_ate_m']:.4f} m over {ORACLE_ATE}")
    if faults:
        fail("the port against the C++ reference's oracle: " + "; ".join(faults))
    return out


# ---------------------------------------------------------------- fleet

def fleet_courses(cfg, scans0, poses0):
    """The fleet's FLEET_B sequences, tests/torch_courses.fleet_course(b):
    circle_trajectory(30, radius=12 + b / 2, arc=(0.35 + 0.02 b) pi) in
    default_world(0), 1 cm range noise, rng seed 1000 b + k; sequence 0 is
    the slice's own course (its scans are passed in).  (Radius 12 + b
    puts sequence 6 on an 18 m circle where process_scan loses track from
    scan 21 on: tests/fleet_gaps.py --radius-step 1.)"""
    from tests.torch_courses import fleet_course

    return [(poses0, scans0)] + [fleet_course(cfg.sensor, b, N_SCANS)
                                 for b in range(1, FLEET_B)]


def fleet_chunks(seqs, C):
    """(xyz, valid, ring) host arrays (B, C, ...) of the sequences' chunks."""
    per = [host_chunks(scans, C) for scans in seqs]
    return [tuple(np.stack([p[k][i] for p in per]) for i in range(3))
            for k in range(len(per[0]))]


def catch_fleet(torch, fn):
    """catch_syncs for the fleet phase, which also fails on vmap's
    per-example fallback (an op of the batch path without a batching rule
    would loop over the batch)."""
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    slow = {str(w.message)[:160] for w in caught if VMAP_FALLBACK in str(w.message)}
    if slow:
        fail(f"the fleet path fell back to vmap's per-example loop: {sorted(slow)}")
    return out, [f"{os.path.relpath(w.filename)}:{w.lineno}" for w in caught
                 if "synchroniz" in str(w.message)]


def run_fleet(torch, cfg, chunks, dev, B, every=10):
    """B sequences through BatchPipeline(cfg, B).process_chunk, the kernel
    counts set to 0 just before and read after each chunk, each chunk under
    the sync-debug counting and synchronised at its end.  Aggregate scans/s
    over the chunks after the first (which warms the allocator and the
    kernels' build), launches a chunk, syncs a chunk, peak memory."""
    from lego_loam_tpu_torch.models.batch import BatchPipeline

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    bp = BatchPipeline(cfg, B, loop_check_every=every, device=dev)
    wrappers = kernel_wrappers()
    for w in wrappers:
        w.launches = 0
    results, syncs, sites, secs, per_chunk = [], [], Counter(), [], []
    for ch in chunks:
        before = [w.launches for w in wrappers]
        t = time.perf_counter()
        res, hits = catch_fleet(torch, lambda: bp.process_chunk(*(a[:B] for a in ch)))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t)
        per_chunk.append({w.__name__: w.launches - n for w, n in zip(wrappers, before)})
        results.append(res)
        syncs.append(len(hits))
        sites.update(hits)
    steady = sum(r.did_map.shape[0] for r in results[1:])
    return {"bp": bp, "results": results, "syncs_per_chunk": syncs,
            "sync_sites": dict(sites), "chunk_s": secs,
            "scans_per_s": B * steady / sum(secs[1:]),
            "steps_per_s": steady / sum(secs[1:]),
            "launches": {w.__name__: w.launches for w in wrappers},
            "launches_per_chunk": per_chunk,
            "peak_mem_bytes": torch.cuda.max_memory_allocated() - base}


def fleet_gaps(torch, results, b, alone):
    """Sequence b of the batch's chunk results against its own run through
    LegoLoamPipeline.process_chunk: largest fused and mapped gaps, and
    whether stats, did_map and the loop flags are equal."""
    def cat(rs, f):
        return torch.cat([f(r) for r in rs])

    mk = cat(alone, lambda r: r.did_map)
    fused = pose_gaps(cat(results, lambda r: r.fused_poses.R[b]),
                      cat(results, lambda r: r.fused_poses.t[b]),
                      cat(alone, lambda r: r.fused_poses.R),
                      cat(alone, lambda r: r.fused_poses.t))
    mapped = pose_gaps(cat(results, lambda r: r.mapped_poses.R[b])[mk],
                       cat(results, lambda r: r.mapped_poses.t[b])[mk],
                       cat(alone, lambda r: r.mapped_poses.R)[mk],
                       cat(alone, lambda r: r.mapped_poses.t)[mk])
    same = (torch.equal(cat(results, lambda r: r.stats[b]), cat(alone, lambda r: r.stats))
            and torch.equal(cat(results, lambda r: r.did_map), mk)
            and torch.equal(cat(results, lambda r: r.loop_closed[b]),
                            cat(alone, lambda r: r.loop_closed)))
    return {"fused_m": fused[0], "fused_deg": fused[1], "mapped_m": mapped[0],
            "mapped_deg": mapped[1]}, same


def run_alone(torch, cfg, chunks, b, dev, every=10):
    """Sequence b of the fleet chunks through its own LegoLoamPipeline."""
    from lego_loam_tpu_torch.models import pipeline as pl

    pipe = pl.LegoLoamPipeline(cfg, dev, loop_check_every=every)
    return pipe, [pipe.process_chunk(*(a[b] for a in ch)) for ch in chunks]


def capture_batched(torch, fn, B):
    """Runs fn() with each kernel's launcher wrapped to keep a copy of the
    inputs of its last launch on a batch of B (by shape, and for E1 by
    threshold); returns {name: [args, ...]}."""
    from lego_loam_tpu_torch.ops import eig6, features, knn, segmentation

    kept = {}
    spots = ((segmentation, "_launch_label_prop", lambda a: a[0].dim() == 3),
             (features, "_launch_label_features", lambda a: a[0].dim() == 3),
             (knn, "_launch_knn", lambda a: a[0].dim() == 3),
             (eig6, "eig6", lambda a: a[0].shape[0] == B))
    origs = [getattr(mod, name) for mod, name, _ in spots]

    def keeper(name, orig, batched):
        def wrapped(*args):
            if batched(args):
                key = (tuple(args[0].shape), args[-1] if name == "eig6" else None)
                kept.setdefault(name, {})[key] = [
                    a.clone() if isinstance(a, torch.Tensor) else a for a in args]
            return orig(*args)
        # eig6 counts its launches on its module's name, which is this
        # wrapper while it stands in
        wrapped.launches = getattr(orig, "launches", 0)
        return wrapped

    for (mod, name, batched), orig in zip(spots, origs):
        setattr(mod, name, keeper(name, orig, batched))
    try:
        fn()
    finally:
        for (mod, name, _), orig in zip(spots, origs):
            if hasattr(orig, "launches"):
                orig.launches = getattr(mod, name).launches
            setattr(mod, name, orig)
    return {name: list(v.values()) for name, v in kept.items()}


def check_fleet_kernels(torch, cfg, captured, B):
    """Each kernel's batched launch against its plain version on every
    sequence of the captured B = 8 inputs: K1 and K2 exact, K3 distances
    to rtol 1e-4 / atol 1e-3 with equal sentinel slots, E1 P within E1_TOL
    (a keep-mask flip only at the threshold, as check_e1); timed with CUDA
    events beside the plain version over the batch and the batch's
    bound."""
    from types import SimpleNamespace

    from lego_loam_tpu_torch.ops import eig6, features, knn, segmentation
    from lego_loam_tpu_torch.types import SegmentedScan

    out = {}
    # K1: (B, R, H) labels and masks
    args = captured["_launch_label_prop"][-1]
    ms = cfg.label_prop_max_sweeps
    got = segmentation._launch_label_prop(*args)
    for b in range(B):
        if not torch.equal(got[b], segmentation.propagate_labels_plain(
                *(a[b] for a in args), ms)):
            fail(f"K1's batched launch differs from its plain version on sequence {b}")
    R, H = args[0].shape[1:]
    out["propagate_labels"] = dict(
        shape=f"{B}x{R}x{H}", max_abs_err=0.0,
        launches_per_call=segmentation.label_prop_launches(B, R, H, args[0].device),
        ms=cuda_ms(torch, lambda: segmentation._launch_label_prop(*args), 50),
        plain_ms=cuda_ms(torch, lambda: [segmentation.propagate_labels_plain(
            *(a[b] for a in args), ms) for b in range(B)], 3),
        **dict(zip(("bound_ms", "bound_by"), bound(nbytes(*args, got), 0))))
    # K2: (B, R, W) packed rows
    args = captured["_launch_label_features"][-1]
    lab, pick = features._launch_label_features(*args)
    pcfg = SimpleNamespace(**dict(zip(features._FLOAT_PARAMS + features._INT_PARAMS,
                                      args[5] + args[6])))
    for b in range(B):
        packed = SegmentedScan(None, args[0][b], args[2][b], None, args[3][b],
                               args[1][b], args[4][b], None, None)
        lp, pp = features.label_features_plain(packed, pcfg)
        if not (torch.equal(lab[b], lp) and torch.equal(pick[b], pp)):
            fail(f"K2's batched launch differs from its plain version on sequence {b}")
    out["label_features"] = dict(
        shape="x".join(map(str, args[0].shape)), max_abs_err=0.0,
        ms=cuda_ms(torch, lambda: features._launch_label_features(*args), 50),
        plain_ms=cuda_ms(torch, lambda: [features.label_features_plain(SegmentedScan(
            None, args[0][b], args[2][b], None, args[3][b], args[1][b], args[4][b],
            None, None), pcfg) for b in range(B)], 3),
        **dict(zip(("bound_ms", "bound_by"), k2_bound(cfg, args[4], lab.numel()))))
    # K3: every batched shape of the path (the mapping solve's corner and
    # surf searches); the largest is the kernels line's
    rows = []
    for args in captured["_launch_knn"]:
        q, r, v, k = args
        idx, d2 = knn._launch_knn(*args)
        err = 0.0
        for b in range(B):
            pidx, pd2 = knn.knn_plain(q[b], r[b], v[b], k)
            real = pd2 < 1e29
            if not torch.equal(real, d2[b] < 1e29) or not torch.allclose(
                    d2[b][real], pd2[real], rtol=1e-4, atol=1e-3):
                fail(f"K3's batched launch differs from its plain version on "
                     f"sequence {b} at {tuple(q.shape)} x {tuple(r.shape)}")
            if bool(real.any()):
                err = max(err, float((d2[b][real] - pd2[real]).abs().max()))
        b_ms, b_by = bound(nbytes(q, r, v, idx, d2),
                           8 * q.shape[1] * int(v.sum()))
        rows.append(dict(
            shape=f"{B}x{q.shape[1]}x{r.shape[1]} k={k}",
            splits=knn.knn_splits(q.shape[1], r.shape[1], B), max_abs_err=err,
            ms=cuda_ms(torch, lambda: knn._launch_knn(*args), 20),
            plain_ms=cuda_ms(torch, lambda: [knn.knn_plain(q[b], r[b], v[b], k)
                                             for b in range(B)], 2),
            bound_ms=b_ms, bound_by=b_by, q_n=q.shape[1] * r.shape[1]))
    rows.sort(key=lambda x: -x.pop("q_n"))
    out["knn"] = dict(rows[0], shapes=rows[1:])
    # E1: the odometry's and the mapping solve's (B, 6, 6), against the
    # plain version run in float64 (E1 diagonalises in float64; a mapping
    # solve's H can hold a kept and a dropped eigenvalue close enough that
    # float32 eigh's subspace is off by more than E1_TOL: that gap to the
    # float32 plain version is printed, not held)
    rows = []
    for H, th in captured["eig6"]:
        P, lam, sw = eig6.eig6(H, th)
        P64, lam64 = eig6.degeneracy_projection_plain(H.double(), th)
        scale = H.abs().amax(dim=(1, 2)).clamp(min=1.0)
        d_p = (P.double() - P64).abs().amax(dim=(1, 2))
        same = ((lam >= th) == (lam64 >= th)).all(dim=1)
        at_thresh = ((lam64 - th).abs() <= E1_TOL * scale[:, None]).any(dim=1)
        bad = (~same & ~at_thresh) | (same & (d_p > E1_TOL))
        if bool(bad.any()):
            i = int(bad.nonzero()[0, 0])
            fail(f"E1's batched launch differs from its plain version (float64) at "
                 f"threshold {th} on sequence {i}: |dP| {float(d_p[i]):.3g}, "
                 f"eigenvalues {lam[i].tolist()} against {lam64[i].tolist()}")
        d_p32 = (P - eig6.degeneracy_projection_plain(H, th)[0]).abs().amax(dim=(1, 2))
        ms_b, by = bound(E1_BYTES * B, sum(map(e1_ops, sw.tolist())), FP64_OPS_PER_S)
        rows.append(dict(shape=f"{B}x6x6", thresh=th,
                         max_abs_err=float(d_p[same].max()) if bool(same.any()) else 0.0,
                         float32_plain_max_abs_err=float(d_p32.max()),
                         near_threshold_flips=int((~same).sum()),
                         ms=cuda_ms(torch, lambda: eig6.eig6(H, th), 100),
                         plain_ms=cuda_ms(torch, lambda: eig6.degeneracy_projection_plain(
                             H, th), 20),
                         bound_ms=ms_b, bound_by=by))
    rows.sort(key=lambda x: x["thresh"])
    out["eig6"] = dict(rows[0], shapes=rows[1:])
    return out


def run_fleet_loop(torch, lccfg, dev):
    """The loop-on arm: lccfg (the loop path's full-width config, the
    course's 0.55 s stamps as the scan period) at B = 2 over the
    out-and-back course and the same course in world seed 7 (noise seed
    500 + k), in chunks of LOOP_CHUNK_C, against each sequence alone."""
    from lego_loam_tpu_torch.io import synthetic as syn
    from tests.torch_courses import LOOP_CHECK_EVERY, loop_course, loop_positions

    positions, scans0, _ = loop_course(lccfg.sensor)
    world = syn.default_world(seed=7)
    scans1 = [syn.raycast(world, np.eye(3), t, lccfg.sensor, noise=0.01,
                          rng=np.random.default_rng(500 + k))
              for k, t in enumerate(loop_positions())]
    chunks = fleet_chunks([scans0, scans1], LOOP_CHUNK_C)
    fl = run_fleet(torch, lccfg, chunks, dev, 2, LOOP_CHECK_EVERY)
    bp, res = fl.pop("bp"), fl.pop("results")
    n = len(scans0)
    fl["loop_checks_per_chunk"] = [
        sum(1 for f in range(k, min(k + LOOP_CHUNK_C, n)) if f % LOOP_CHECK_EVERY == 0)
        for k in range(0, n, LOOP_CHUNK_C)]
    fl["sequences"] = []
    for b in range(2):
        pipe, alone = run_alone(torch, lccfg, chunks, b, dev, LOOP_CHECK_EVERY)
        gaps, same = fleet_gaps(torch, res, b, alone)
        closed = torch.cat([r.loop_closed[b] for r in res]).tolist()
        fl["sequences"].append(dict(
            gaps=gaps, same=same, loops_closed_at=[k for k, c in enumerate(closed) if c],
            alone_closed_at=[k for k, c in enumerate(torch.cat(
                [r.loop_closed for r in alone]).tolist()) if c],
            n_kf=int(bp.mstate.n_kf[b]), alone_n_kf=int(pipe.mstate.n_kf)))
    seq0 = torch.cat([r.fused_poses.t[0] for r in res]).cpu().numpy()
    fl["final_err_m"] = float(np.linalg.norm(seq0[-1] - (positions[-1] - positions[0])))
    return fl


def profile_fleet(torch, cfg, chunks, dev, B):
    """Device activity of a steady chunk of 6 steps of the batch, scans 3-8
    (2 mapping solves, a third of the steps as in a chunk of 10), after
    scans 0-2 through the same new BatchPipeline: profile_window, a step
    being one scan of every sequence."""
    from lego_loam_tpu_torch.models.batch import BatchPipeline

    bp = BatchPipeline(cfg, B, device=dev)
    bp.process_chunk(*(a[:B, :3] for a in chunks[0]))
    return profile_window(
        torch, lambda: bp.process_chunk(*(a[:B, 3:9] for a in chunks[0])), 6)


def fleet_phase(torch, cfg, scans, poses, lccfg, results, card, dev):
    """Fleet batching at full width (models/batch.py): FLEET_B sequences of
    the slice's config (the slice's own course first), each step vmapped
    over the batch and every kernel one launch a call site for all of
    them, at B of FLEET_BATCHES; each sequence held to its own run; each
    kernel's batched launch against its plain version; the loop-on arm.
    vmap's per-example fallback is an error here.  Adds each kernel's
    fleet launches and batched timing to its row of `results`; returns
    (the phase's numbers, the fleet chunks for the profiler phase)."""
    warnings.filterwarnings("error", message=VMAP_FALLBACK)
    t_fleet = t0 = time.perf_counter()
    fseqs = fleet_courses(cfg, scans, poses)
    fchunks = fleet_chunks([s for _, s in fseqs], CHUNK_C)
    fleet = {"card": card, "runs": {}}
    print(f"fleet: {FLEET_B} VLP-16 sequences of {N_SCANS} scans (sequence b: "
          f"radius 12 + b / 2 m, arc (0.35 + 0.02 b) pi, noise seed 1000 b + k), "
          f"cast in {time.perf_counter() - t0:.1f} s")
    fb = fres = None
    for B in FLEET_BATCHES:
        fl = run_fleet(torch, cfg, fchunks, dev, B)
        if B == FLEET_B:
            fb, fres = fl["bp"], fl["results"]
        del fl["bp"], fl["results"]
        fleet["runs"][B] = fl
        print(f"fleet [{card}]: B = {B}: {fl['scans_per_s']:.2f} scans/s aggregate "
              f"({fl['steps_per_s']:.2f} steps/s) over chunks 2-3 of {CHUNK_C}; chunk "
              f"seconds {[round(x, 3) for x in fl['chunk_s']]}; peak memory "
              f"{fl['peak_mem_bytes'] / 2**20:.1f} MiB; host syncs per chunk "
              f"{fl['syncs_per_chunk']} by site {fl['sync_sites']}; launches a "
              f"chunk {fl['launches_per_chunk'][1]}")
        if any(fl["syncs_per_chunk"]):
            fail(f"fleet B = {B}: host syncs per chunk {fl['syncs_per_chunk']}, not 0 "
                 f"({fl['sync_sites']})")
        for key, count in fl["launches"].items():
            if count == 0:
                fail(f"kernel {key} was not launched on the fleet path at B = {B}")
    from lego_loam_tpu_torch.ops.segmentation import label_prop_launches
    k1_calls = label_prop_launches(FLEET_B, cfg.sensor.n_scan, cfg.sensor.horizon_scan, dev)
    fleet["k1_launches_per_call"] = k1_calls
    one, many = fleet["runs"][1]["launches_per_chunk"], fleet["runs"][FLEET_B]["launches_per_chunk"]
    for c, (a, b) in enumerate(zip(one, many)):
        for key in a:
            want = a[key] * (k1_calls if key == "propagate_labels" else 1)
            if b[key] != want:
                fail(f"fleet: {key} launched {b[key]} times in chunk {c} at B = "
                     f"{FLEET_B}, against {a[key]} at B = 1")
    print(f"fleet: launches a chunk at B = {FLEET_B} equal B = 1's for K2, K3 and "
          f"E1; K1 takes {k1_calls} cooperative launch(es) a call at B = {FLEET_B} "
          + ("(one: the batch's blocks are co-resident)" if k1_calls == 1 else
             "(split: the batch's blocks are not all co-resident)"))
    fleet["sequences"] = []
    for b, (fposes, _) in enumerate(fseqs):
        apipe, alone = run_alone(torch, cfg, fchunks, b, dev)
        gaps, same = fleet_gaps(torch, fres, b, alone)
        traj = torch.cat([t[b] for t in fb.trajectory]).cpu().numpy()
        R0, tr0 = fposes[0]
        ate = float(np.sqrt(np.mean([np.sum((R0 @ p + tr0 - t) ** 2)
                                     for p, (_, t) in zip(traj, fposes)])))
        row = dict(gaps=gaps, same=same, ate_m=ate, n_kf=int(fb.mstate.n_kf[b]),
                   alone_n_kf=int(apipe.mstate.n_kf))
        fleet["sequences"].append(row)
        print(f"fleet: sequence {b} at B = {FLEET_B} against its own process_chunk "
              f"run: fused {gaps['fused_m'] * 1e3:.4f} mm / {gaps['fused_deg']:.5f} "
              f"deg, mapped {gaps['mapped_m'] * 1e3:.4f} mm / "
              f"{gaps['mapped_deg']:.5f} deg; stats, did_map and loop flags "
              f"{'equal' if same else 'DIFFER'}; {row['n_kf']} keyframes "
              f"({row['alone_n_kf']} alone); ATE {ate:.4f} m")
        if not same or row["n_kf"] != row["alone_n_kf"]:
            fail(f"fleet sequence {b}: stats, did_map, loop flags or keyframes "
                 f"differ from its own run")
        if max(gaps["fused_m"], gaps["mapped_m"]) > FLEET_POS_M or \
                max(gaps["fused_deg"], gaps["mapped_deg"]) > FLEET_ROT_DEG:
            fail(f"fleet sequence {b}: poses differ from its own run by {gaps}")
        if not ate < ATE_BOUND:
            fail(f"fleet sequence {b}: ATE {ate:.4f} m is not under {ATE_BOUND} m")
        del apipe, alone
    del fb, fres
    # each kernel's batched launch at B = FLEET_B against its plain version,
    # on the inputs of the fleet path's first two chunks (the local map is
    # gathered from the keyframes at the 5th solve, scan 12, and kept for
    # the next 3: the last call of each shape sees a full map)
    from lego_loam_tpu_torch.models.batch import BatchPipeline

    def capture_run():
        bp = BatchPipeline(cfg, FLEET_B, device=dev)
        for ch in fchunks[:2]:
            bp.process_chunk(*ch)

    fk = check_fleet_kernels(torch, cfg, capture_batched(torch, capture_run, FLEET_B),
                             FLEET_B)
    for r, key in zip(results, ("propagate_labels", "label_features", "knn", "eig6")):
        r["fleet_launches"] = fleet["runs"][FLEET_B]["launches"][key]
        r["fleet"] = fk[key]
        k = fk[key]
        print(f"fleet [{card}]: {r['name']} batched at {k['shape']}: kernel "
              f"{k['ms']:.4f} ms, plain {k['plain_ms']:.4f} ms, max|err| "
              f"{k['max_abs_err']:.3g}, bound {k['bound_ms']:.6f} ms "
              f"({k['bound_by']}), {100 * k['bound_ms'] / k['ms']:.3f} % of it; "
              f"{r['fleet_launches']} launches on the B = {FLEET_B} run")
        for extra in [k] + k.get("shapes", []):
            if extra is not k:
                print(f"fleet [{card}]:   also at {extra['shape']}"
                      + (f" (threshold {extra['thresh']})" if "thresh" in extra else "")
                      + f": kernel {extra['ms']:.4f} ms, plain {extra['plain_ms']:.4f} "
                      f"ms, max|err| {extra['max_abs_err']:.3g}, bound "
                      f"{extra['bound_ms']:.6f} ms ({extra['bound_by']})")
            if "float32_plain_max_abs_err" in extra:
                print(f"fleet [{card}]:   E1 at threshold {extra['thresh']}: P against "
                      f"the float32 plain version within "
                      f"{extra['float32_plain_max_abs_err']:.3g}, keep-mask flips at "
                      f"the threshold {extra['near_threshold_flips']}")
    # the loop-on arm: the loop path's full-width config at B = 2
    fl = run_fleet_loop(torch, lccfg, dev)
    fleet["loop"] = fl
    print(f"fleet loop [{card}]: B = {FLEET_LOOP_B}, {fl['scans_per_s']:.2f} scans/s; "
          f"host syncs per chunk {fl['syncs_per_chunk']} (loop checks per chunk "
          f"{fl['loop_checks_per_chunk']}) by site {fl['sync_sites']}; "
          f"sequence 0's final pose {fl['final_err_m']:.4f} m from the truth; "
          + "; ".join(f"sequence {b}: loops closed at {q['loops_closed_at']} "
                      f"(alone {q['alone_closed_at']}), fused gap "
                      f"{q['gaps']['fused_m'] * 1e3:.4f} mm / {q['gaps']['fused_deg']:.5f} "
                      f"deg" for b, q in enumerate(fl["sequences"])))
    for b, q in enumerate(fl["sequences"]):
        if q["loops_closed_at"] != q["alone_closed_at"] or not q["same"]:
            fail(f"fleet loop arm: sequence {b} closed other loops (or made other "
                 f"stats) than alone")
    if not fl["sequences"][0]["loops_closed_at"]:
        fail("fleet loop arm: no loop closed on the out-and-back course")
    if any(s > c for s, c in zip(fl["syncs_per_chunk"], fl["loop_checks_per_chunk"])):
        fail(f"fleet loop arm: host syncs per chunk {fl['syncs_per_chunk']} over the "
             f"loop checks {fl['loop_checks_per_chunk']}")
    for key, count in fl["launches"].items():
        if count == 0:
            fail(f"kernel {key} was not launched on the fleet's loop arm")
    fleet["seconds"] = time.perf_counter() - t_fleet
    print(f"fleet: the phase took {fleet['seconds']:.1f} s")
    return fleet, fchunks


def parallel_phase(torch, cfg, scans, rows, n_kf, mapping_ms, lcfg, lscans, lstamps,
                   lp, results, card, dev):
    """The distributed back end (lego_loam_tpu_torch/parallel/) on the card
    at world size 1 over NCCL (NCCL refuses two ranks on one device):
    checks 1-6 of its contract, each failing the run.  Returns its numbers."""
    import torch.distributed as dist

    if not dist.is_nccl_available():
        fail("this torch has no NCCL: the parallel phase cannot run")
    # no network: NCCL's bootstrap stays on the loopback interface
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    try:
        return _parallel_checks(torch, cfg, scans, rows, n_kf, mapping_ms, lcfg,
                                lscans, lstamps, lp, results, card, dev)
    finally:
        dist.destroy_process_group()


def _timed_calls(torch, fn, acc):
    """fn, each call synchronised and its host-clock ms appended to acc."""
    def wrapper(*a, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn(*a, **kw)
        torch.cuda.synchronize()
        acc.append((time.perf_counter() - t) * 1e3)
        return out
    return wrapper


def _counted_calls(torch, fn, acc):
    """fn, the host syncs of each call appended to acc (catch_syncs)."""
    def wrapper(*a, **kw):
        out, sites = catch_syncs(torch, lambda: fn(*a, **kw))
        acc.append(sites)
        return out
    return wrapper


def _parallel_checks(torch, cfg, scans, rows, n_kf, mapping_ms, lcfg, lscans,
                     lstamps, lp, results, card, dev):
    import torch.distributed as dist

    from lego_loam_tpu_torch.models import mapping as mp
    from lego_loam_tpu_torch.models import posegraph as pg
    from lego_loam_tpu_torch.ops import knn as knn_ops
    from lego_loam_tpu_torch.parallel import backend_sharded as bs
    from lego_loam_tpu_torch.parallel.comm import Comm
    from lego_loam_tpu_torch.parallel.graph import solve_pose_graph_sharded
    from lego_loam_tpu_torch.parallel.map_sharded import knn_sharded
    from tests.torch_courses import LOOP_CHECK_EVERY
    from tests.torch_ranks import frontend_course, sharded_course

    solo = Comm()                    # world size 1: no collective
    nccl = Comm(always=True)         # the same world, every collective through NCCL
    if (solo.size, nccl.size) != (1, 1) or nccl.group is None:
        fail(f"the NCCL world has {solo.size} ranks, not 1")
    out = {"backend": str(dist.get_backend()), "world_size": solo.size}
    knn_row = results[2]
    query, ref, ref_valid = knn_row.pop("_surf_inputs")

    # 1. K3 at the shard shapes of knn_sharded over W ranks: each rank holds
    # max_map_surf / W of the map
    shapes = {}
    for W in (1, 2, 4, 8):
        n = ref.shape[0] // W
        r = knn_case(torch, query, ref[:n].contiguous(), ref_valid[:n].contiguous())
        S = knn_ops.knn_splits(query.shape[0], n)
        shapes[f"{query.shape[0]}x{n}"] = {
            "world": W, "max_abs_err": r["err"], "ms": r["ms"], "call_ms": r["call_ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "splits": S,
            "valid_refs": int(ref_valid[:n].sum())}
        print(f"  parallel: K3 at W = {W}'s shard, {query.shape[0]} x {n} "
              f"({shapes[f'{query.shape[0]}x{n}']['valid_refs']} valid refs, S = {S}): "
              f"max|d2 err| {r['err']:.3g}, kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.5f} ms "
              f"({r['bound_by']}), {100 * r['bound_ms'] / r['ms']:.2f} % of it")
    knn_row["shard_shapes"] = shapes
    knn_row["max_abs_err"] = max([knn_row["max_abs_err"]]
                                 + [v["max_abs_err"] for v in shapes.values()])

    # 2. knn_sharded at world size 1 is a direct K3 call, with the
    # all-gather through NCCL or not
    want = knn_ops.knn(query, ref, ref_valid, 5)
    for comm in (solo, nccl):
        got = knn_sharded(query, ref, ref_valid, 5, comm)
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
            fail(f"knn_sharded (always={comm.always}) differs from a direct K3 call")
    out["knn_sharded_nccl_collectives"] = nccl.calls

    # 3. the edge-sharded pose graph on the loop course's state at full width
    state, n = lp["_mstate"], int(lp["_mstate"].n_kf)
    ref_pg = pg.solve_pose_graph(state, lcfg)
    R1, t1 = solve_pose_graph_sharded(state, lcfg, solo)
    c0 = nccl.calls
    (Rn, tn), pg_syncs = catch_syncs(torch, lambda: solve_pose_graph_sharded(
        state, lcfg, nccl))
    out["pose_graph"] = pgr = {
        "keyframes": n, "max_keyframes": lcfg.max_keyframes,
        "nccl_collectives": nccl.calls - c0, "host_syncs": len(pg_syncs)}
    pgr["gap_m"], pgr["gap_deg"] = pose_gaps(R1[:n], t1[:n], ref_pg.kf_R[:n],
                                             ref_pg.kf_t[:n])
    pgr["nccl_equal"] = bool(torch.equal(R1, Rn) and torch.equal(t1, tn))
    pgr["ms"] = cuda_ms(torch, lambda: solve_pose_graph_sharded(state, lcfg, solo), 3, 1)
    pgr["solve_pose_graph_ms"] = cuda_ms(torch, lambda: pg.solve_pose_graph(state, lcfg),
                                         3, 1)
    print(f"parallel [{card}]: solve_pose_graph_sharded on the loop course's "
          f"{n} keyframes (max_keyframes {lcfg.max_keyframes}): {pgr['gap_m'] * 1e3:.4f} "
          f"mm / {pgr['gap_deg']:.5f} deg from solve_pose_graph, "
          f"{pgr['nccl_collectives']} NCCL collectives a solve (equal "
          f"{pgr['nccl_equal']}), {pgr['host_syncs']} host syncs; "
          f"{pgr['ms']:.2f} ms against solve_pose_graph {pgr['solve_pose_graph_ms']:.2f} ms")
    if pgr["gap_m"] > CHUNK_POS_M or pgr["gap_deg"] > CHUNK_ROT_DEG:
        fail(f"the sharded pose graph is {pgr['gap_m']} m / {pgr['gap_deg']} deg from "
             f"solve_pose_graph")
    if not pgr["nccl_equal"] or pgr["host_syncs"]:
        fail(f"the sharded pose graph over NCCL: equal {pgr['nccl_equal']}, "
             f"host syncs {pg_syncs}")

    # 4. ShardedBackend fed by the port's front end over the slice's scans
    # at full width, against the single-device LegoLoamPipeline's run
    wrappers = kernel_wrappers()
    dscans = device_scans(torch, cfg, scans, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    for w in wrappers:
        w.launches = 0
    fronts = frontend_course(cfg, dscans, dev)
    be = bs.ShardedBackend(mp.init_state(cfg, dev), cfg, solo)
    step_syncs, knn_per_step = [], []
    counted = _counted_calls(torch, be.step, step_syncs)

    def step(*a, **kw):
        k0 = knn_ops.knn.launches
        res = counted(*a, **kw)
        knn_per_step.append(knn_ops.knn.launches - k0)
        return res

    be.step = step
    mapped, fused, _ = sharded_course(be, cfg, fronts)
    launches = {w.__name__: w.launches for w in wrappers}
    every = cfg.mapping_process_every
    ref_mapped = [r.mapped_pose for r in rows[::every]]
    gm, gd = pose_gaps(torch.stack([T.R for T in mapped]),
                       torch.stack([T.t for T in mapped]),
                       torch.stack([T.R for T in ref_mapped]),
                       torch.stack([T.t for T in ref_mapped]))
    want_syncs = [int(i % be.compact_check_every == 0) for i in range(len(mapped))]
    out["slice"] = sl = {
        "solves": len(mapped), "gap_m": gm, "gap_deg": gd,
        "bit_equal": all(same_pose(torch, a, b) for a, b in zip(mapped, ref_mapped)),
        "n_kf": int(be.state.n_kf), "pipeline_n_kf": n_kf, "launches": launches,
        "knn_launches_per_solve": knn_per_step,
        "host_syncs_per_solve": [len(x) for x in step_syncs]}
    # the same course with every collective through NCCL, each solve timed
    be_n = bs.ShardedBackend(mp.init_state(cfg, dev), cfg, nccl)
    solve_ms, coll = [], []
    timed = _timed_calls(torch, be_n.step, solve_ms)

    def nccl_step(*a, **kw):
        c = nccl.calls
        res = timed(*a, **kw)
        coll.append(nccl.calls - c)
        return res

    be_n.step = nccl_step
    mapped_n, _, _ = sharded_course(be_n, cfg, fronts)
    sl["nccl_equal"] = all(same_pose(torch, a, b) for a, b in zip(mapped_n, mapped))
    sl["nccl_collectives_per_solve"] = coll
    sl["solve_ms"] = float(np.mean(solve_ms[1:]))
    sl["first_solve_ms"] = solve_ms[0]
    sl["mapping_step_ms"] = mapping_ms
    print(f"parallel [{card}]: ShardedBackend over the slice's {len(scans)} scans "
          f"({sl['solves']} solves) against LegoLoamPipeline: mapped poses within "
          f"{gm * 1e3:.4f} mm / {gd:.5f} deg (bit-equal {sl['bit_equal']}), "
          f"{sl['n_kf']} keyframes (pipeline {n_kf}); host syncs per solve "
          f"{sl['host_syncs_per_solve']}; K3 launches per solve {knn_per_step}; "
          f"kernel launches {launches}")
    print(f"parallel [{card}]: over NCCL, {coll[0]} collectives a solve, poses equal "
          f"{sl['nccl_equal']}; a sharded solve {sl['solve_ms']:.2f} ms (synchronised, "
          f"after the first's {sl['first_solve_ms']:.2f} ms) against mapping_step "
          f"{mapping_ms:.2f} ms (the slice's, scan clouds included)")
    for key, count in launches.items():
        if count == 0:
            fail(f"kernel {key} was not launched on the sharded back end's path")
    if gm > CHUNK_POS_M or gd > CHUNK_ROT_DEG or sl["n_kf"] != n_kf:
        fail(f"ShardedBackend is {gm} m / {gd} deg from the pipeline, "
             f"{sl['n_kf']} keyframes against {n_kf}")
    if sl["host_syncs_per_solve"] != want_syncs:
        fail(f"ShardedBackend host syncs per solve {sl['host_syncs_per_solve']}, not "
             f"{want_syncs} (one n_kf pull every {be.compact_check_every} solves): "
             f"{step_syncs}")
    if not sl["nccl_equal"] or min(coll) < 1:
        fail(f"the NCCL run: equal {sl['nccl_equal']}, collectives {coll}")

    # 5. the loop course: the sharded loop check against the pipeline's
    lfronts = frontend_course(lcfg, device_scans(torch, lcfg, lscans, dev), dev)
    lbe = bs.ShardedBackend(mp.init_state(lcfg, dev), lcfg, solo)
    loop_syncs = []
    lbe.loop_step = _counted_calls(torch, lbe.loop_step, loop_syncs)
    _, lfused, closed = sharded_course(lbe, lcfg, lfronts, lstamps, LOOP_CHECK_EVERY)
    want_closed = [bool(c) for c in lp["loop_closed"][::LOOP_CHECK_EVERY]]
    ref_st = lp["_mstate"]
    nk = int(lbe.state.n_kf)
    fused_gap = float(np.abs(np.stack([f.t.cpu().numpy() for f in lfused])
                             - np.stack(lp["_traj"])).max())
    kf_m, kf_deg = pose_gaps(lbe.state.kf_R[:nk], lbe.state.kf_t[:nk],
                             ref_st.kf_R[:nk], ref_st.kf_t[:nk])
    out["loop"] = lo = {
        "closed": closed, "pipeline_closed": want_closed, "fused_gap_m": fused_gap,
        "keyframe_gap_m": kf_m, "keyframe_gap_deg": kf_deg, "n_kf": nk,
        "n_loops": int(lbe.state.n_loops),
        "host_syncs_per_check": [len(x) for x in loop_syncs]}
    out["peak_mem_bytes"] = int(torch.cuda.max_memory_allocated(dev))
    print(f"parallel [{card}]: the loop course through ShardedBackend.loop_step: "
          f"closed {closed} (pipeline {want_closed}), {lo['n_loops']} loops, fused "
          f"poses within {fused_gap * 1e3:.4f} mm, keyframes within {kf_m * 1e3:.4f} mm "
          f"/ {kf_deg:.5f} deg; host syncs per loop check {lo['host_syncs_per_check']}; "
          f"peak memory {out['peak_mem_bytes'] / 2**20:.1f} MiB")
    if closed != want_closed or not any(closed):
        fail(f"the sharded loop checks closed {closed}, the pipeline's {want_closed}")
    if fused_gap > CHUNK_POS_M or kf_m > CHUNK_POS_M or kf_deg > CHUNK_ROT_DEG \
            or nk != int(ref_st.n_kf) or lo["n_loops"] != int(ref_st.n_loops):
        fail(f"the sharded loop course differs from the pipeline's: {lo}")
    # 6. a loop check reads its flag once; nothing else syncs
    if lo["host_syncs_per_check"] != [1] * len(closed):
        fail(f"host syncs per sharded loop check {loop_syncs}, not 1 each")

    for r, key in zip(results, ("propagate_labels", "label_features", "knn", "eig6")):
        r["parallel_launches"] = launches[key]
    knn_row["launches_per_sharded_solve"] = max(knn_per_step)
    return out


def counted(torch, fn):
    """fn() with every kernel's count set to 0 just before and read just
    after: (its result, launches by wrapper, seconds)."""
    wrappers = kernel_wrappers()
    for w in wrappers:
        w.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, {w.__name__: w.launches for w in wrappers}, time.perf_counter() - t0


def drivers_phase(torch, dev, card, work, bag_path, imu_traj, hscans, hposes):
    """The user entry points of lego_loam_tpu_torch/examples/ through their
    run(): run_synthetic at its own config over DRIVER_FRAMES frames with
    --loop (its --imu run is trace_phase's); run_rosbag --imu on the IMU phase's bag, whose
    trajectory must be bit-equal to that phase's de-skew + IMU arm;
    run_kitti on the HDL-64E path's scans written as a KITTI sequence
    (float32 x, y, z, r .bin files, KITTI-00's calibration, the course's
    poses), per scan and in chunks of KITTI_CHUNK_C, which must agree as
    chunks agree with process_scan; the soak at its cut depth (SOAK_CUT),
    which must fill and thin its pool in the pipeline without overflow
    (its loop-edge and ATE checks are printed: ROADMAP C14).  Every kernel
    must launch in every run.  (The traced run is trace_phase, last.)"""
    from lego_loam_tpu_torch import config_for
    from lego_loam_tpu_torch.examples import run_kitti, run_rosbag, run_synthetic, soak
    from tests.torch_courses import write_kitti_sequence

    out = {}

    def launched(tag, launches):
        print(f"drivers: {tag}: kernel launches {launches}")
        for key, count in launches.items():
            if count == 0:
                fail(f"kernel {key} was not launched by {tag}")

    def quiet(*_):
        pass

    # run_synthetic --loop (its --imu run is trace_phase's, last)
    tag = "run_synthetic --loop"
    cfg = run_synthetic.make_config("vlp16", True)
    res, launches, secs = counted(torch, lambda: run_synthetic.run(
        cfg, DRIVER_FRAMES, device=dev, log=quiet))
    out[tag] = synthetic_row(tag, res, launches, secs)

    # run_rosbag --imu on the IMU phase's bag: the arm it replays, bit for bit
    res, launches, secs = counted(torch, lambda: run_rosbag.run(
        bag_path, run_rosbag.make_config("vlp16", False), imu=True, device=dev,
        log=quiet))
    same = res["trajectory"].shape == imu_traj.shape and np.array_equal(
        res["trajectory"], imu_traj)
    out["run_rosbag --imu"] = {"n_scans": res["n_scans"], "bit_equal": same,
                               "launches": launches, "seconds": secs}
    print(f"drivers: run_rosbag --imu: {res['n_scans']} scans of the IMU phase's bag, "
          f"trajectory bit-equal to that phase's de-skew + IMU arm: {same}; {secs:.1f} s")
    launched("run_rosbag --imu", launches)
    if not same:
        fail("run_rosbag's trajectory differs from the IMU phase's arm on the same bag")

    # run_kitti on a KITTI sequence of the HDL-64E path's scans
    seq = os.path.join(work, "kitti_seq")
    poses_file = write_kitti_sequence(seq, hscans, hposes)
    kitti = {}
    for tag, C in (("per scan", 0), (f"--chunk {KITTI_CHUNK_C}", KITTI_CHUNK_C)):
        res, launches, secs = counted(torch, lambda: run_kitti.run(
            seq, run_kitti.make_config(), poses=poses_file, chunk=C, device=dev,
            log=quiet))
        kitti[tag] = res
        out[f"run_kitti {tag}"] = {"ate_m": res["ate_m"], "rpe_m": res["rpe_m"],
                                   "rpe_deg": float(np.degrees(res["rpe_rad"])),
                                   "launches": launches, "seconds": secs}
        print(f"drivers: run_kitti {tag}: {len(res['t'])} HDL-64E scans, ATE "
              f"{res['ate_m']:.4f} m, RPE@{res['rpe_delta']} {res['rpe_m']:.4f} m / "
              f"{np.degrees(res['rpe_rad']):.4f} deg, {secs:.1f} s")
        launched(f"run_kitti {tag}", launches)
        if not res["ate_m"] < HDL_ATE_BOUND:
            fail(f"run_kitti {tag}: ATE {res['ate_m']:.4f} m is not under {HDL_ATE_BOUND} m")
    a, b = kitti["per scan"], kitti[f"--chunk {KITTI_CHUNK_C}"]
    gap_m = float(np.abs(a["t"] - b["t"]).max())
    gap_deg = max(rot_gap_deg(x, y) for x, y in zip(a["R"], b["R"]))
    out["run_kitti_chunk_gap"] = {"m": gap_m, "deg": gap_deg}
    print(f"drivers: run_kitti --chunk {KITTI_CHUNK_C} against per scan: {gap_m * 1e3:.4f} mm "
          f"/ {gap_deg:.5f} deg (bound {CHUNK_POS_M * 1e3:.0f} mm / {CHUNK_ROT_DEG} deg)")
    if gap_m > CHUNK_POS_M or gap_deg > CHUNK_ROT_DEG:
        fail(f"run_kitti's chunks differ from its per-scan run by {gap_m} m / {gap_deg} deg")

    # the soak at its cut depth
    scfg = config_for("vlp16", deskew=False, loop_closure_enabled=True,
                      max_keyframes=SOAK_CUT_KEYFRAMES)
    torch.cuda.empty_cache()
    res, launches, secs = counted(torch, lambda: soak.run(
        cfg=scfg, device=dev, workers=min(8, os.cpu_count() or 1), log=quiet,
        **SOAK_CUT))
    rec, extra = res["record"], res["extra"]
    out["soak_cut"] = {"record": rec, "extra": extra, "launches": launches,
                       "seconds": secs, "cut": dict(SOAK_CUT, max_keyframes=SOAK_CUT_KEYFRAMES)}
    syncs = extra["syncs_per_chunk"]
    print(f"drivers: soak (cut: step {SOAK_CUT['step']} m, {SOAK_CUT['n_laps']} laps, "
          f"max_keyframes {SOAK_CUT_KEYFRAMES}; chunks of {SOAK_CUT['chunk']}) [{card}]:")
    print(json.dumps(rec))
    print(f"drivers: soak: keyframes at each sample {extra['n_kf_samples']}; "
          f"{extra['compactions_in_pipeline']} compactions in the pipeline (chunks "
          f"{extra['compaction_chunks']}); host syncs per chunk {syncs} by site "
          f"{extra['sync_sites']}; a loop check against the end pool "
          f"{extra['loop_check_ms_end']:.2f} ms; peak memory "
          f"{extra['peak_mem_bytes'] / 2**20:.1f} MiB; {secs:.1f} s")
    launched("the soak", launches)
    # held: the pool filled and the pipeline thinned it (a fall seen at the
    # samples), no overflow, a finite corrected trajectory.  Printed, not
    # held: the soak's loop-edge and 5 m ATE checks -- the ring road drifts
    # metres a lap at this step in both packages (ROADMAP C14), so no
    # revisit lands within the loop search radius
    unheld = soak.failures(rec, scfg)
    print(f"drivers: soak: its own checks that fail {unheld or 'none'} (the loop-edge "
          f"and ATE checks are not held: ROADMAP C14)")
    if rec["compactions_observed"] < 1 or extra["compactions_in_pipeline"] < 1:
        fail("the cut soak: compaction never fired in-pipeline")
    if rec["n_kf_final"] >= scfg.max_keyframes:
        fail("the cut soak: pool overflowed")
    if not np.isfinite(rec["ate_corrected_m"]):
        fail("the cut soak lost its trajectory")
    del res

    return out


def synthetic_row(tag, res, launches, secs) -> dict:
    """A run_synthetic run's numbers, printed and held: every kernel
    launched, a finite trajectory, ATE under ATE_BOUND."""
    print(f"drivers: {tag}: {DRIVER_FRAMES} frames, ATE {res['ate_m']:.4f} m, "
          f"{res['n_kf']} keyframes, {res['n_loops']} loop closures, kernel launches "
          f"{launches}, {secs:.1f} s")
    for key, count in launches.items():
        if count == 0:
            fail(f"kernel {key} was not launched by {tag}")
    if not np.isfinite(res["est"]).all() or not res["ate_m"] < ATE_BOUND:
        fail(f"{tag}: ATE {res['ate_m']:.4f} m is not under {ATE_BOUND} m")
    return {"ate_m": res["ate_m"], "n_kf": res["n_kf"], "n_loops": res["n_loops"],
            "launches": launches, "seconds": secs}


def trace_phase(torch, dev, work):
    """run_synthetic --imu over DRIVER_FRAMES frames under
    utils/tracing.trace, last in the run (a profiler session can leave the
    process's later launches slower, and in a run that traced it before the
    profiler phase, that phase's first K2 session saw no device work): held
    as the --loop run is, and its Chrome trace must name the four kernels'
    custom ops."""
    from lego_loam_tpu_torch.examples import run_synthetic
    from lego_loam_tpu_torch.utils.tracing import trace

    def quiet(*_):
        pass

    tdir = os.path.join(work, "trace")
    cfg = run_synthetic.make_config("vlp16", False)

    def traced():
        with trace(tdir):
            return run_synthetic.run(cfg, DRIVER_FRAMES, imu=True, device=dev, log=quiet)
    res, launches, secs = counted(torch, traced)
    row = synthetic_row("run_synthetic --imu, traced", res, launches, secs)
    files = [os.path.join(tdir, f) for f in os.listdir(tdir) if f.endswith(".json")]
    if len(files) != 1:
        fail(f"utils/tracing.trace wrote {len(files)} trace files, not 1")
    with open(files[0], "rb") as f:
        text = f.read()
    named = {op: text.count(f'"{op}"'.encode()) for op in TRACE_OPS}
    print(f"drivers: its Chrome trace {len(text) / 2**20:.1f} MiB, events of the "
          f"kernels' ops {named}")
    missing = [op for op, n in named.items() if n == 0]
    if missing:
        fail(f"the trace names no event of {missing}")
    return dict(row, trace_bytes=len(text), trace_op_events=named)


@contextlib.contextmanager
def capture_kernel_inputs(torch, dev):
    """Keeps a copy of the inputs of every kernel call on `dev` (a CPU run
    beside is left out) while the block runs: K1's label_inputs, K2's
    packed scan and config (extract_features), K3's search (the mapping
    solve's and the loop check's), E1's H and threshold.  Yields the dict
    of lists."""
    from lego_loam_tpu_torch.models import mapping as mp
    from lego_loam_tpu_torch.models import odometry as odo
    from lego_loam_tpu_torch.models import pipeline as pl
    from lego_loam_tpu_torch.ops import icp, segmentation

    kept = {"k1": [], "k2": [], "k3": [], "e1": []}

    def clone(x):
        return x.detach().clone() if isinstance(x, torch.Tensor) else x

    def on_card(*ts):
        return all(t.device.type == dev.type for t in ts if isinstance(t, torch.Tensor))

    orig = {"label_inputs": segmentation.label_inputs,
            "extract_features": pl.extract_features, "map_knn": mp.knn,
            "icp_knn": icp.knn, "degeneracy_projection": odo.degeneracy_projection}

    def label_inputs(*a):
        out = orig["label_inputs"](*a)
        if on_card(*out):
            kept["k1"].append(tuple(clone(t) for t in out))
        return out

    def extract_features(packed, outlier_s, cfg):
        if on_card(*packed):
            kept["k2"].append((type(packed)(*(clone(t) for t in packed)), cfg))
        return orig["extract_features"](packed, outlier_s, cfg)

    def knn_of(key):
        def knn(query, ref, ref_valid, k, query_tile=0):
            if on_card(query, ref, ref_valid):
                kept["k3"].append((clone(query), clone(ref), clone(ref_valid), int(k)))
            return orig[key](query, ref, ref_valid, k, query_tile)
        return knn

    def degeneracy_projection(H, thresh):
        if on_card(H):
            kept["e1"].append((clone(H), float(thresh)))
        return orig["degeneracy_projection"](H, thresh)

    segmentation.label_inputs = label_inputs
    pl.extract_features = extract_features
    mp.knn, icp.knn = knn_of("map_knn"), knn_of("icp_knn")
    odo.degeneracy_projection = degeneracy_projection
    try:
        yield kept
    finally:
        segmentation.label_inputs = orig["label_inputs"]
        pl.extract_features = orig["extract_features"]
        mp.knn, icp.knn = orig["map_knn"], orig["icp_knn"]
        odo.degeneracy_projection = orig["degeneracy_projection"]


def all_finite(torch, *ts) -> bool:
    return all(bool(torch.isfinite(t).all()) for t in ts)


def robust_courses(torch, cfg, courses, dev, tag):
    """tests/test_robustness.py's courses through LegoLoamPipeline(cfg, dev)
    .process_scan with the kernel counts set to 0 just before and read just
    after: every odometry, fused and keyframe pose finite, the repeated
    scan under IDENTICAL_BOUND.  Returns the launches, the identical
    course's displacement and each course's FrameResults."""
    from lego_loam_tpu_torch.models import pipeline as pl
    from tests.torch_courses import IDENTICAL_BOUND

    wrappers = kernel_wrappers()
    for w in wrappers:
        w.launches = 0
    mode_counts(zero=True)
    rows, moved = {}, None
    for name, scans in courses.items():
        pipe = pl.LegoLoamPipeline(cfg, dev)
        rows[name] = []
        for k, (xyz, valid, ring, t) in enumerate(scans):
            r = pipe.process_scan(xyz, valid, ring, t=t)
            if not all_finite(torch, r.odom_pose.t, r.fused_pose.t, r.odom_pose.R,
                              r.fused_pose.R, pipe.mstate.kf_t):
                fail(f"robustness ({tag}): {name} scan {k} left a non-finite pose")
            rows[name].append(r)
        if name == "identical_repeated":
            moved = float(torch.linalg.vector_norm(r.fused_pose.t))
            if not moved < IDENTICAL_BOUND:
                fail(f"robustness ({tag}): the repeated scan moved {moved:.4f} m, "
                     f"not under {IDENTICAL_BOUND} m")
    launches = {w.__name__: w.launches for w in wrappers}
    launches.update(mode_counts())
    for key in ("propagate_labels", "label_features", "knn", "eig6"):
        if launches[key] == 0:
            fail(f"robustness ({tag}): kernel {key} was not launched on the "
                 f"degenerate courses")
    return launches, moved, rows


def k3_degenerate(torch, query, ref, valid, k, exact=True):
    """K3 against knn_plain on one search: sentinel slots equal (index and
    1e30), real distances within atol 1e-3 / rtol 1e-4 (knn_case's scheme)
    plus 2 ulp of |q|^2 + |r|^2, the float32 rounding of the expansion for
    points far out (1 ulp at 100 m is 0.002 m^2), indices equal (with
    `exact`; else a differing index must be a near tie: its two distances
    within that tolerance).  Returns (max |d2 err| over real slots, indices
    that differ)."""
    from lego_loam_tpu_torch.ops import knn as knn_ops

    idx, d2 = knn_ops.knn(query, ref, valid, k)
    pidx, pd2 = knn_ops.knn_plain(query, ref, valid, k)
    real = pd2 < 1e29
    if not torch.equal(real, d2 < 1e29) or not torch.equal(idx[~real], pidx[~real]) \
            or not torch.equal(d2[~real], pd2[~real]):
        fail(f"K3 knn: sentinel slots differ from the plain version ({query.shape[0]} x "
             f"{ref.shape[0]}, {int(valid.sum())} valid, k = {k})")
    gap = (d2 - pd2).abs()
    mag = (query * query).sum(1)[:, None] + (ref[pidx.long()] ** 2).sum(-1)
    off = gap > 1e-3 + 1e-4 * pd2.abs() + 2 * 1.2e-7 * mag
    err = float(gap[real].max()) if bool(real.any()) else 0.0
    if bool(off[real].any()):
        fail(f"K3 knn distances differ from the plain version by {err:.3g} "
             f"({query.shape[0]} x {ref.shape[0]}, {int(valid.sum())} valid, k = {k})")
    diff = idx != pidx
    n_diff = int(diff.sum())
    if n_diff and (exact or bool(off[diff].any())):
        fail(f"K3 knn indices differ from the plain version at {n_diff} slots "
             f"({query.shape[0]} x {ref.shape[0]}, {int(valid.sum())} valid, k = {k})")
    return err, n_diff


def robust_kernel_checks(torch, cap, full, dev):
    """Each kernel against its plain version on the inputs captured from the
    degenerate courses and loop checks, and on a few built ones; each timed
    on its most degenerate input.  Returns one dict a kernel."""
    from lego_loam_tpu_torch.ops import eig6
    from lego_loam_tpu_torch.ops import features as fops
    from lego_loam_tpu_torch.ops import knn as knn_ops
    from lego_loam_tpu_torch.ops import segmentation as seg_ops
    from tests.torch_courses import eig6_spectra

    out = {}
    # K1: every captured image; the empty and the one-pixel images counted
    ms = full.label_prop_max_sweeps
    seeds = [int((a[0] < a[0].numel()).sum()) for a in cap["k1"]]
    for a in cap["k1"]:
        if not torch.equal(seg_ops.propagate_labels(*a, ms),
                           seg_ops.propagate_labels_plain(*a, ms)):
            fail("K1 label_prop differs from its plain version on a degenerate scan")
    empty = cap["k1"][seeds.index(0)] if 0 in seeds else None
    if empty is None or not any(n == 1 for n in seeds):
        fail(f"the degenerate courses gave K1 no empty or one-pixel image: {sorted(set(seeds))}")
    b_ms, b_by = bound(nbytes(*empty, empty[0]), 0)
    out["label_prop"] = {
        "images": len(cap["k1"]), "empty_images": seeds.count(0),
        "one_pixel_images": seeds.count(1), "max_abs_err": 0.0,
        "ms": cuda_ms(torch, lambda: seg_ops.propagate_labels(*empty, ms), 50),
        "plain_ms": cuda_ms(torch, lambda: seg_ops.propagate_labels_plain(*empty, ms), 5),
        "bound_ms": b_ms, "bound_by": b_by, "input": "the all-invalid scan"}
    # K2, both pick orders, on every captured packed scan
    zero = few = 0
    sparse = None
    for packed, cfg in cap["k2"]:
        W = packed.rng.shape[-1]
        counts = packed.count.clamp(0, W)
        zero += int((counts == 0).sum())
        n_few = int(((counts > 0) & (counts < 12)).sum())
        few += n_few
        if n_few and sparse is None:
            sparse = (packed, cfg)
        for c in (cfg, cfg.replace(sector_parallel=not cfg.sector_parallel)):
            lab, pick = fops.label_features(packed, c)
            lab_p, pick_p = fops.label_features_plain(packed, c)
            if not (torch.equal(lab, lab_p) and torch.equal(pick, pick_p)):
                fail(f"K2 label_features (sector_parallel={c.sector_parallel}) differs "
                     f"from its plain version on a degenerate scan")
    if not zero or sparse is None:
        fail(f"the degenerate courses gave K2 no ring of 0 ({zero}) or 1-11 kept cells")
    packed, cfg = sparse
    R, W = packed.rng.shape
    b_ms, b_by = k2_bound(cfg, packed.count, R * W)
    out["label_features"] = {
        "scans": len(cap["k2"]), "rings_empty": zero, "rings_under_12": few,
        "max_abs_err": 0.0, "modes": "parallel and sequential",
        "ms": cuda_ms(torch, lambda: fops.label_features(packed, cfg), 50),
        "plain_ms": cuda_ms(torch, lambda: fops.label_features_plain(packed, cfg), 5),
        "bound_ms": b_ms, "bound_by": b_by,
        "input": f"a scan with {int(packed.count.clamp(0, W).sum())} kept cells"}
    # K3: every captured search (mapping solves against empty and sparse
    # maps, the corridor loop checks' ICP and plane 5-NN), then a map of 1-4
    # valid points spread over the splits of the mapping shape
    err = 0.0
    near = n_empty = n_short = 0
    for q, r, v, k in cap["k3"]:
        nv = int(v.sum())
        n_empty += nv == 0
        n_short += 0 < nv < k
        e, d = k3_degenerate(torch, q, r, v, k, exact=nv <= k)
        err, near = max(err, e), near + d
    maps = [c for c in cap["k3"] if c[1].shape[0] == full.max_map_surf and c[3] == 5]
    if not n_empty or not maps:
        fail("the degenerate courses gave K3 no search against an empty map")
    q = maps[0][0]
    N = full.max_map_surf
    S = knn_ops.knn_splits(q.shape[0], N)
    split = -(-N // S)
    picks = (5, N // 3 + 7, 2 * N // 3 + 11, N - 3)
    spread = sorted({i // split for i in picks})
    ref = torch.zeros((N, 3), device=dev)
    gen = torch.Generator(device="cpu").manual_seed(13)
    for n_pts in (1, 2, 3, 4):
        valid = torch.zeros(N, dtype=torch.bool, device=dev)
        for i in picks[:n_pts]:
            ref[i] = (torch.rand(3, generator=gen) * 40 - 20).to(dev)
            valid[i] = True
        e, _ = k3_degenerate(torch, q, ref, valid, 5, exact=True)
        err = max(err, e)
    empty_v = torch.zeros(N, dtype=torch.bool, device=dev)
    b_ms, b_by = bound(nbytes(q, ref, empty_v) + q.shape[0] * 5 * 8, 0)
    out["knn"] = {
        "searches": len(cap["k3"]), "empty_maps": n_empty, "short_maps": n_short,
        "built_maps": f"1-4 valid points at {list(picks)} of {N}, splits {spread} of S = {S}",
        "near_tie_indices": near, "max_abs_err": err,
        "ms": cuda_ms(torch, lambda: knn_ops.knn(q, ref, empty_v, 5), 20),
        "plain_ms": cuda_ms(torch, lambda: knn_ops.knn_plain(q, ref, empty_v, 5), 3),
        "bound_ms": b_ms, "bound_by": b_by,
        "input": f"{q.shape[0]} x {N}, no valid reference (the first mapping solve)"}
    # E1: every captured H (odometry rounds and solves with no or few
    # constraints) and the seeded zero / rank-one / rank-two systems, 6x6 and 3x3
    groups = {}
    for H, th in cap["e1"]:
        groups.setdefault((H.shape[-1], th), []).append(H.reshape(-1, *H.shape[-2:]))
    n_zero = sum(int((torch.cat(v).abs().amax(dim=(1, 2)) == 0).sum())
                 for v in groups.values())
    for n in (6, 3):
        for th in (full.odom_degen_eig_thresh, full.map_degen_eig_thresh):
            rng = np.random.default_rng(n)
            J = rng.normal(size=(2, n))
            built = [h for name, h in eig6_spectra(th, n=n) if name in ("zero", "rank_one")]
            built.append((J.T @ J * th).astype(np.float32))
            groups.setdefault((n, th), []).append(torch.as_tensor(np.stack(built), device=dev))
    worst = 0.0
    flips = 0
    for (n, th), items in groups.items():
        d_p, d_lam, f, _ = e1_compare(torch, torch.cat(items).contiguous(), th)
        worst, flips = max(worst, d_p, d_lam), flips + f
    if not n_zero or not any(n == 3 for n, _ in groups):
        fail("the degenerate courses gave E1 no zero Hessian, or no 3x3 one")
    Hz = torch.zeros((1, 6, 6), device=dev)
    th = full.odom_degen_eig_thresh
    sweeps = int(eig6.eig6(Hz, th)[2][0])
    b_ms, b_by = e1_bound(sweeps)
    out["eig6"] = {
        "matrices": {f"{n}x{n} @ {th}": sum(len(x) for x in v)
                     for (n, th), v in groups.items()},
        "zero_captured": n_zero, "near_threshold_flips": flips, "max_abs_err": worst,
        "ms": cuda_ms(torch, lambda: eig6.degeneracy_projection(Hz, th), 200),
        "plain_ms": cuda_ms(torch, lambda: eig6.degeneracy_projection_plain(Hz, th), 50),
        "bound_ms": b_ms, "bound_by": b_by, "sweeps": sweeps, "input": "H = 0"}
    for key, row in out.items():
        print(f"  robustness: {key} on degenerate inputs: "
              + ", ".join(f"{k} {v:.4g}" if isinstance(v, float) else f"{k} {v}"
                          for k, v in row.items()))
    return out


def robustness_phase(torch, dev, card):
    """The JAX package's behaviour tests on the card (ROADMAP A20): its
    degenerate scans, loop false positives and stress courses through every
    entry path, and each kernel against its plain version on what they feed
    it.  Fails on any check; returns the phase's numbers."""
    from lego_loam_tpu_torch import config_for
    from lego_loam_tpu_torch.models import loop as lc
    from lego_loam_tpu_torch.models import pipeline as pl
    from lego_loam_tpu_torch.models.batch import BatchPipeline
    from lego_loam_tpu_torch.ops import knn as knn_ops
    from tests.torch_courses import (CORRIDOR_CASES, FAITHFUL, LOOP_CHECK_EVERY, ROBUST,
                                     ROBUST_COURSES, STRESS, STRESS_ALONG_FRAC,
                                     STRESS_CORRIDOR_N, STRESS_CORRIDOR_STEP,
                                     STRESS_LAT, STRESS_VERT, STRESS_YAW_ATE,
                                     STRESS_YAW_FINAL, corridor_clouds,
                                     corridor_gate_faults, corridor_out_and_back,
                                     corridor_state, corridor_world, loop_robust_cfg,
                                     robustness_course, slice_course, stress_corridor,
                                     stress_errors, stress_fast_yaw, stress_scans)

    t_phase = time.perf_counter()
    full = config_for("vlp16", deskew=False)
    small = config_for("vlp16", **ROBUST)
    courses = {name: robustness_course(name, full.sensor) for name in ROBUST_COURSES}
    out = {"launches": {}}
    # 1. the four courses through process_scan at full width (inputs kept),
    # at the test's config, and the sparse course in FAITHFUL's order
    with capture_kernel_inputs(torch, dev) as cap:
        out["launches"]["full"], moved, rows = robust_courses(torch, full, courses, dev,
                                                             "full width")
        fcfg = config_for("vlp16", **FAITHFUL)
        out["launches"]["faithful"] = robust_courses(
            torch, fcfg, {"empty_and_sparse": courses["empty_and_sparse"]}, dev,
            "faithful")[0]
        # 6. (run here so that their searches are kept too) the corridor
        # loop checks from the port's own state, on the card and the CPU
        loops = {}
        true_world = corridor_out_and_back(0.0)[0]
        clouds = {lm: corridor_clouds(full, corridor_world(lm), true_world)
                  for lm in (False, True)}
        for name, lm, drift, over in CORRIDOR_CASES:
            lcfg = config_for("vlp16", **loop_robust_cfg(**over))
            _, est, times = corridor_out_and_back(drift)
            n = len(times)
            runs = {}
            for where in (dev, "cpu"):
                st = corridor_state(lcfg, clouds[lm], est, times, where)
                before = st.kf_t.clone()
                k0 = knn_ops.knn.launches
                new, res = lc.loop_closure_step(st, times[-1], lcfg)
                launched = knn_ops.knn.launches - k0
                faults = corridor_gate_faults(name, lcfg, res, before, new, n)
                if faults:
                    fail(f"robustness: corridor loop check on {where}: " + "; ".join(faults))
                runs[str(where)] = (bool(res.closed), new.kf_t[:n].cpu().numpy(),
                                    float(res.fitness), float(res.drift),
                                    float(res.obs_ratio), launched)
            (cc, ck, cf, cd, co, cl), (hc, hk, *_rest) = runs[str(dev)], runs["cpu"]
            gap = float(np.abs(ck - hk).max())
            loops[name] = {"closed": cc, "fitness": cf, "drift": cd, "obs_ratio": co,
                           "knn_launches": cl, "kf_gap_to_cpu_m": gap}
            print(f"robustness: corridor {name}: closed {cc} (CPU {hc}), fitness {cf:.4f}, "
                  f"drift {cd:.3f} m, obs_ratio {co:.4f}, {cl} K3 launches, keyframes "
                  f"{gap * 1e3:.4f} mm from the CPU's")
            if cc != hc or gap > C6_POS_M:
                fail(f"robustness: corridor {name} on the card decided {cc}, on the CPU "
                     f"{hc}; keyframes {gap:.4g} m apart")
        out["loops"] = loops
    out["launches"]["tests_config"] = robust_courses(torch, small, courses, dev,
                                                     "the test's config")[0]
    out["identical_moved_m"] = moved
    print(f"robustness: the four degenerate courses ({sum(map(len, courses.values()))} "
          f"scans) finite at full width and at the test's config; the repeated scan "
          f"moved {moved:.5f} m; launches {out['launches']}")

    # 2. each kernel on what the courses fed it
    out["kernels"] = robust_kernel_checks(torch, cap, full, dev)
    del cap

    # 3. the garbage burst inside one process_chunk
    gscans = courses["garbage_then_recovery"]
    pipe = pl.LegoLoamPipeline(full, dev)
    res = []
    for c0 in range(0, len(gscans), ROBUST_CHUNK_C):
        part = gscans[c0:c0 + ROBUST_CHUNK_C]
        res.append(pipe.process_chunk(*(np.stack([s[i] for s in part]) for i in range(3)),
                                      t0=part[0][3]))
    gaps, bad = chunk_gaps(torch, res, rows["garbage_then_recovery"])
    out["chunk"] = gaps
    print(f"robustness: the garbage burst inside a chunk of {ROBUST_CHUNK_C}: fused "
          f"{gaps['fused_m'] * 1e3:.4f} mm / {gaps['fused_deg']:.5f} deg, mapped "
          f"{gaps['mapped_m'] * 1e3:.4f} mm / {gaps['mapped_deg']:.5f} deg from process_scan")
    if bad or gaps["fused_m"] > CHUNK_POS_M or gaps["mapped_m"] > CHUNK_POS_M or \
            gaps["fused_deg"] > CHUNK_ROT_DEG or gaps["mapped_deg"] > CHUNK_ROT_DEG:
        fail(f"robustness: the chunk differs from process_scan: {gaps}, scans {bad}")

    # 4. the fleet at B = 2: the recovery course beside the slice course
    _, sscans = slice_course(full.sensor, len(gscans))
    seqs = [[s[:3] for s in gscans], sscans]
    chunks = fleet_chunks(seqs, ROBUST_CHUNK_C)
    bp = BatchPipeline(full, ROBUST_FLEET_B, device=dev)
    wrappers = kernel_wrappers()
    for w in wrappers:
        w.launches = 0
    bres = [catch_fleet(torch, lambda ch=ch: bp.process_chunk(*ch))[0] for ch in chunks]
    out["launches"]["fleet_b2"] = {w.__name__: w.launches for w in wrappers}
    out["fleet"] = {}
    for b in range(ROBUST_FLEET_B):
        _, alone = run_alone(torch, full, chunks, b, dev)
        g, same = fleet_gaps(torch, bres, b, alone)
        out["fleet"][b] = g
        print(f"robustness: fleet B = 2, sequence {b} "
              f"({'garbage then recovery' if b == 0 else 'the slice course'}) against its "
              f"run alone: fused {g['fused_m'] * 1e3:.4f} mm / {g['fused_deg']:.5f} deg, "
              f"stats, did_map and loop flags equal {same}")
        if not same or g["fused_m"] > FLEET_POS_M or g["fused_deg"] > FLEET_ROT_DEG \
                or g["mapped_m"] > FLEET_POS_M or g["mapped_deg"] > FLEET_ROT_DEG:
            fail(f"robustness: fleet sequence {b} differs from its run alone: {g}")
    print(f"robustness: fleet B = 2 launches {out['launches']['fleet_b2']}")
    if 0 in out["launches"]["fleet_b2"].values():
        fail(f"robustness: a kernel did not launch in the fleet: {out['launches']['fleet_b2']}")

    # 5. the card against the CPU on the recovery course at the test's config
    c6, faults = card_against_cpu(torch, small, [s[:3] for s in gscans],
                                  [s[3] for s in gscans], LOOP_CHECK_EVERY, dev)
    out["card_vs_cpu"] = c6
    g = c6["gaps"]
    print(f"robustness: card vs cpu on the recovery course ({c6['scans']} scans): fused "
          f"{g['fused_m'] * 1e3:.4f} mm / {g['fused_deg']:.5f} deg, keyframes "
          f"{g['keyframe_m'] * 1e3:.4f} mm / {g['keyframe_deg']:.5f} deg")
    if faults:
        fail("robustness: the card differs from the CPU on the recovery course: "
             + "; ".join(faults))

    # 7. the stress courses at the test's config
    scfg = config_for("vlp16", **STRESS)
    out["stress"] = {}
    for name, course in (("fast_yaw", stress_fast_yaw), ("corridor", stress_corridor)):
        world, poses = course()
        scans = stress_scans(world, poses, scfg.sensor)
        pipe = pl.LegoLoamPipeline(scfg, dev, collect_stats=False)
        t0 = time.perf_counter()
        for k, s in enumerate(scans):
            pipe.process_scan(*s, t=0.1 * k)
        traj = pipe.trajectory_numpy()
        secs = time.perf_counter() - t0
        e = out["stress"][name] = dict(stress_errors(traj, poses), seconds=secs)
        print(f"robustness [{card}]: stress {name} ({len(scans)} scans, {secs:.1f} s): "
              + ", ".join(f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
                          for k, v in e.items()))
        if not e["finite"]:
            fail(f"robustness: the stress {name} trajectory is not finite")
    y = out["stress"]["fast_yaw"]
    if not (y["ate"] < STRESS_YAW_ATE and y["final"] < STRESS_YAW_FINAL):
        fail(f"robustness: fast-yaw ATE {y['ate']:.4f} m / final {y['final']:.4f} m over "
             f"{STRESS_YAW_ATE} / {STRESS_YAW_FINAL}")
    # the corridor: held to the one bound of test_stress.py the port meets on
    # the CPU; the JAX package misses all three (ROADMAP C2)
    c = out["stress"]["corridor"]
    path = STRESS_CORRIDOR_STEP * (STRESS_CORRIDOR_N - 1)
    print(f"robustness: corridor lateral {c['lat']:.4f} m (bound {STRESS_LAT}; the JAX "
          f"package 0.326 on the CPU, ROADMAP C2), vertical {c['vert']:.4f} m (bound "
          f"{STRESS_VERT}; 12.23), along {c['along']:.4f} m (bound "
          f"{STRESS_ALONG_FRAC * path:.2f}; 8.11)")
    if not c["lat"] < STRESS_LAT:
        fail(f"robustness: corridor lateral drift {c['lat']:.4f} m over {STRESS_LAT} m")
    out["seconds"] = time.perf_counter() - t_phase
    return out


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a card")
    from lego_loam_tpu_torch import config_for
    from lego_loam_tpu_torch.io import synthetic as syn
    from lego_loam_tpu_torch.kernels import build as kb
    from lego_loam_tpu_torch.models import pipeline as pl
    from lego_loam_tpu_torch.ops.projection import project_scan
    from tests.test_torch_sensor_rows import mid_row
    from tests.torch_courses import (FAITHFUL, LOOP, LOOP_CHECK_EVERY,
                                     LOOP_COURSE_KNOBS, LOOP_FINAL_BOUND,
                                     LOOP_SCAN_PERIOD, LOOP_SHORT_OUT, SMALL,
                                     fast_yaw_course, fast_yaw_imu, loop_course,
                                     slice_course)

    dev = torch.device("cuda:0")
    clock = PhaseClock()
    work = tempfile.TemporaryDirectory(prefix="chip_smoke_")
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
    clock("kernels against their plain versions")
    for r, note in (check_k1(torch, cfg, imgs, dev),
                    check_k2(torch, cfg, imgs, hcfg, himg, dev),
                    check_k3(torch, cfg, world, dev)):
        print(f"  {r['name']}: kernel {r['ms']:.4f} ms (call {r['call_ms']:.4f} "
              f"ms), plain {r['plain_ms']:.4f} ms, max|err| "
              f"{r['max_abs_err']:.3g}, bound {r['bound_ms']:.5f} ms "
              f"({r['bound_by']}), {100 * r['bound_ms'] / r['ms']:.2f} % of "
              f"bound ({note})")
        results.append(r)
    # E1 on the H of the slice's first 7 scans (35 odometry rounds, 3
    # mapping solves) and on seeded spectra
    results.append(check_e1(torch, cfg, capture_eig6_inputs(torch, cfg, scans[:7], dev),
                            dev))
    # the reference-faithful configuration's forms: K2 in the sequential
    # order, E1 at 3x3 on the H of the two-step odometry's phases over the
    # slice's first 7 scans (70 of them) and on seeded 3x3 spectra
    fcfg = config_for("vlp16", **FAITHFUL)
    bimgs = [project_scan(*(torch.as_tensor(a, device=dev) for a in scans[k][:2]),
                          fcfg, torch.as_tensor(scans[k][2], device=dev))
             for k in range(8)]
    results.append(check_k2_sequential(torch, fcfg, imgs, bimgs, hcfg, himg, dev))
    del bimgs
    results.append(check_e1(torch, fcfg, capture_eig6_inputs(torch, fcfg, scans[:7], dev),
                            dev, n=3))

    clock("the slice")
    sl = run_slice(torch, cfg, scans, poses, dev)
    rows = sl.pop("_rows")
    print(f"slice: {N_SCANS} scans, ATE {sl['ate_m']:.4f} m (max "
          f"{sl['max_err_m']:.4f} m), {sl['n_kf']} keyframes")
    print(f"slice: {sl['scans_per_s']:.2f} scans/s over {sl['window_scans']} "
          f"scans; frontend_step {sl['frontend_ms']:.2f} ms, mapping_step "
          f"{sl['mapping_ms']:.2f} ms; peak memory "
          f"{sl['peak_mem_bytes'] / 2**20:.1f} MiB")
    print(f"slice: host syncs per scan {sl['host_syncs_per_scan']}, by "
          f"call site over those scans: {sl['sync_sites']}")
    print(f"slice: kernel launches {sl['launches']}")
    for r, key in zip(results, ("propagate_labels", "label_features", "knn", "eig6")):
        r["launches"] = sl["launches"][key]
        if r["launches"] == 0:
            fail(f"kernel {r['name']} was not launched on the main path")
    if not np.isfinite(sl["ate_m"]) or sl["ate_m"] >= ATE_BOUND:
        fail(f"slice ATE {sl['ate_m']:.4f} m is not under {ATE_BOUND} m")
    # E1 took cuSOLVER's info read-back off the path: the one host copy of
    # process_scan is the only sync left, on a plain and on a mapping scan
    if sl["host_syncs_per_scan"] != [1] * SYNC_SCANS:
        fail(f"host syncs per scan {sl['host_syncs_per_scan']}, not 1 each "
             f"({sl['sync_sites']})")

    # chunked replay at full width: the slice course through process_chunk,
    # with and without collect_stats, held to the per-scan run above; a
    # second per-scan run first, whose gap to the first is the card's own
    # run-to-run variation, the yardstick of the chunk's gaps
    clock("the slice in chunks, the export")
    again = pl.LegoLoamPipeline(cfg, dev)
    again_rows = [again.process_scan(*s) for s in device_scans(torch, cfg, scans, dev)]
    chunk = {"process_scan_repeat": dict(zip(("fused_m", "fused_deg"), pose_gaps(
        torch.stack([r.fused_pose.R for r in again_rows]),
        torch.stack([r.fused_pose.t for r in again_rows]),
        torch.stack([r.fused_pose.R for r in rows]),
        torch.stack([r.fused_pose.t for r in rows]))))}
    # the card repeats itself bit for bit: no float atomic sum is left on the
    # path (the voxel centroids are exact fixed-point sums, the pose graph's
    # loop gradient a contraction)
    same = all(same_pose(torch, a.fused_pose, b.fused_pose)
               and same_pose(torch, a.mapped_pose, b.mapped_pose)
               for a, b in zip(again_rows, rows))
    chunk["process_scan_repeat"]["bit_equal"] = same
    print(f"slice again: a second process_scan run of the same scans lands "
          f"{chunk['process_scan_repeat']['fused_m'] * 1e3:.4f} mm / "
          f"{chunk['process_scan_repeat']['fused_deg']:.5f} deg from the first; "
          f"fused and mapped poses bit-equal: {same}")
    if not same:
        fail("two process_scan runs of the slice on the card differ")
    del again, again_rows
    for tag, stats in (("stats", True), ("no_stats", False)):
        ch = run_chunks(torch, cfg, scans, dev, CHUNK_C, stats)
        pipe_c = ch.pop("pipe")
        res_c = ch.pop("results")
        gaps, bad = chunk_gaps(torch, res_c, rows)
        traj = pipe_c.trajectory_numpy()
        R0, t0 = poses[0]
        ch.update(gaps=gaps, n_kf=int(pipe_c.mstate.n_kf), ate_m=float(np.sqrt(np.mean([
            np.sum((R0 @ p + t0 - t) ** 2) for p, (_, t) in zip(traj, poses)]))))
        chunk[tag] = ch
        print(f"chunk ({tag}): {N_SCANS} scans in chunks of {CHUNK_C}, "
              f"{ch['scans_per_s']:.2f} scans/s (process_scan {sl['scans_per_s']:.2f}); "
              f"against process_scan fused {gaps['fused_m'] * 1e3:.4f} mm / "
              f"{gaps['fused_deg']:.5f} deg, mapped ({gaps['mapped_scans']} solves) "
              f"{gaps['mapped_m'] * 1e3:.4f} mm / {gaps['mapped_deg']:.5f} deg; "
              f"ATE {ch['ate_m']:.4f} m, {ch['n_kf']} keyframes; host syncs per "
              f"chunk {ch['syncs_per_chunk']} by site {ch['sync_sites']}; kernel "
              f"launches {ch['launches']}")
        if bad:
            fail(f"chunk ({tag}): did_map or stats differ from process_scan on scans {bad}")
        if gaps["fused_m"] > CHUNK_POS_M or gaps["mapped_m"] > CHUNK_POS_M or \
                gaps["fused_deg"] > CHUNK_ROT_DEG or gaps["mapped_deg"] > CHUNK_ROT_DEG:
            fail(f"chunk ({tag}) poses differ from process_scan by {gaps}")
        if ch["n_kf"] != sl["n_kf"]:
            fail(f"chunk ({tag}): {ch['n_kf']} keyframes against {sl['n_kf']}")
        if not ch["ate_m"] < ATE_BOUND:
            fail(f"chunk ({tag}) ATE {ch['ate_m']:.4f} m is not under {ATE_BOUND} m")
        for key, count in ch["launches"].items():
            if count == 0:
                fail(f"kernel {key} was not launched inside process_chunk")
        want = 1 if stats else 0
        if ch["syncs_per_chunk"] != [want] * len(ch["syncs_per_chunk"]):
            fail(f"chunk ({tag}): host syncs per chunk {ch['syncs_per_chunk']}, "
                 f"not {want}")
        if stats:
            export = check_export(torch, pipe_c, cfg, scans[0], rows[0].stats["n_valid_px"],
                                  dev)
            print(f"export: {export['points']} points written and read back "
                  f"equal in {export['export_s']:.2f} s; dump_keyframe "
                  f"{export['dump_keyframe']}; dump_stages on the card "
                  f"{export['dump_stages']}; native reader {export['native']}")
        del pipe_c, res_c
    for r, key in zip(results, ("propagate_labels", "label_features", "knn", "eig6")):
        r["launches_in_chunks"] = chunk["stats"]["launches"][key]
    # collect_stats=False on process_scan: no host sync at all
    nopipe = pl.LegoLoamPipeline(cfg, dev, collect_stats=False)
    quiet = [len(catch_syncs(torch, lambda s=s: nopipe.process_scan(*s))[1])
             for s in device_scans(torch, cfg, scans[:SYNC_SCANS], dev)]
    print(f"slice, collect_stats=False: host syncs per scan {quiet}")
    if any(quiet):
        fail(f"process_scan with collect_stats=False synced: {quiet}")
    chunk["process_scan_no_stats_syncs"] = quiet
    del nopipe

    # the reference-faithful configuration at full width
    clock("the faithful path")
    faithful = faithful_phase(torch, fcfg, scans, poses, dev)
    for r in results[4:]:
        r["launches"] = faithful["mode_launches"][r["name"]]
        r["launches_in_chunks"] = faithful["chunk"]["mode_launches"][r["name"]]

    clock("the HDL-64E path")
    hl = run_slice(torch, hcfg, hscans, hposes, dev, HDL_WARM, HDL_SYNC)
    hl.pop("_rows")
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

    # the loop-closure path at full width: the default capacities, only the
    # out-and-back course's own knobs changed
    lcfg = config_for("vlp16", deskew=False, loop_closure_enabled=True,
                      **LOOP_COURSE_KNOBS)
    knobs = dict(LOOP_COURSE_KNOBS, loop_check_every=LOOP_CHECK_EVERY)
    print("loop: config_for('vlp16', deskew=False, loop_closure_enabled=True), "
          "the course's knobs " + ", ".join(f"{k}={v}" for k, v in knobs.items())
          + "; defaults " + ", ".join(f"{k}={getattr(lcfg, k)}" for k in (
              "max_keyframes", "max_map_surf", "kf_corner_cap", "kf_surf_cap",
              "kf_outlier_cap", "max_loop_edges", "pg_gn_iters",
              "loop_icp_iters", "history_keyframe_search_num")))
    positions, lscans, stamps = loop_course(lcfg.sensor)
    clock("the loop path")
    lp = run_loop_path(torch, lcfg, lscans, stamps, positions, LOOP_CHECK_EVERY, dev)
    icp_in = lp.pop("_icp")
    lp_end = {"_mstate": lp.pop("_mstate"), "_traj": lp.pop("_traj")}
    ms = lp["check_ms"]
    print(f"loop: {len(lscans)} scans out and back, {lp['n_loops']} loops closed "
          f"(scans {[k for k, c in enumerate(lp['loop_closed']) if c]}), "
          f"{lp['n_kf']} keyframes, ATE {lp['ate_m']:.4f} m, final pose "
          f"{lp['final_err_m']:.4f} m from the truth, {lp['scans_per_s']:.2f} "
          f"scans/s, peak memory {lp['peak_mem_bytes'] / 2**20:.1f} MiB")
    print(f"loop: {lp['loop_checks']} loop checks, "
          f"{ms['total']:.2f} ms a check (synchronised): gather + voxel "
          f"{ms['gather_voxel']:.2f}, ICP {ms['icp']:.2f}, plane_information "
          f"{ms['plane_information']:.2f}, solve_pose_graph "
          f"{ms['solve_pose_graph']:.2f}, other {ms['other']:.2f}; each "
          f"{[round(x, 2) for x in lp['check_ms_each']]}")
    print(f"loop: K3 launches per loop check {lp['knn_launches_per_check']}; "
          f"host syncs per loop check {lp['host_syncs_per_check']}, by call "
          f"site: {lp['sync_sites']}; kernel launches {lp['launches']}")
    for key, count in lp["launches"].items():
        if count == 0:
            fail(f"kernel {key} was not launched on the loop path")
    if min(lp["knn_launches_per_check"], default=0) == 0:
        fail("K3 was not launched inside a loop check")
    if lp["n_loops"] < 1 or icp_in is None:
        fail("no loop closed on the out-and-back course")
    if not np.isfinite(lp["ate_m"]) or lp["ate_m"] >= ATE_BOUND:
        fail(f"loop path ATE {lp['ate_m']:.4f} m is not under {ATE_BOUND} m")
    if not lp["final_err_m"] < LOOP_FINAL_BOUND:
        fail(f"loop path final pose {lp['final_err_m']:.4f} m from the truth, "
             f"not under {LOOP_FINAL_BOUND} m")
    knn_row = results[2]
    knn_row["loop_shapes"] = check_k3_loop(torch, icp_in)
    knn_row["max_abs_err"] = max([knn_row["max_abs_err"]] + [
        v["err"] for v in knn_row["loop_shapes"].values()])
    knn_row["launches_per_loop_check"] = max(lp["knn_launches_per_check"])

    # the loop course through process_chunk: the course's stamps, 0.55 s
    # apart, become the sensor's scan period (without an IMU and with
    # deskew=False the period enters nothing but the stamps)
    lccfg = lcfg.replace(sensor=dataclasses.replace(lcfg.sensor,
                                                    scan_period=LOOP_SCAN_PERIOD))
    clock("the loop path in chunks")
    lch = run_chunks(torch, lccfg, lscans, dev, LOOP_CHUNK_C, True, LOOP_CHECK_EVERY)
    lpipe, lres = lch.pop("pipe"), lch.pop("results")
    lch["loop_closed"] = torch.cat([r.loop_closed for r in lres]).tolist()
    lch["final_err_m"] = float(np.linalg.norm(
        lpipe.trajectory[-1] - (positions[-1] - positions[0])))
    lch["n_loops"] = int(lpipe.mstate.n_loops)
    # a chunk syncs once for its host copy and at most once more for each
    # loop check whose flag a later solve of the chunk must read
    n = len(lscans)
    checks = [sum(1 for f in range(k, min(k + LOOP_CHUNK_C, n))
                  if f % LOOP_CHECK_EVERY == 0) for k in range(0, n, LOOP_CHUNK_C)]
    print(f"loop chunks: {n} scans in chunks of {LOOP_CHUNK_C}, loops closed at "
          f"scans {[k for k, c in enumerate(lch['loop_closed']) if c]} (process_scan: "
          f"{[k for k, c in enumerate(lp['loop_closed']) if c]}), {lch['n_loops']} "
          f"loops, final pose {lch['final_err_m']:.4f} m from the truth, "
          f"{lch['scans_per_s']:.2f} scans/s; host syncs per chunk "
          f"{lch['syncs_per_chunk']} (loop checks per chunk {checks}) by site "
          f"{lch['sync_sites']}; kernel launches {lch['launches']}")
    if lch["loop_closed"] != [bool(c) for c in lp["loop_closed"]]:
        fail("the loop course through process_chunk closed other loops than "
             "through process_scan")
    if not lch["final_err_m"] < LOOP_FINAL_BOUND:
        fail(f"loop chunks: final pose {lch['final_err_m']:.4f} m from the truth")
    if any(sy > 1 + c for sy, c in zip(lch["syncs_per_chunk"], checks)):
        fail(f"loop chunks: host syncs per chunk {lch['syncs_per_chunk']} over 1 + "
             f"the loop checks {checks}")
    chunk["loop"] = lch
    del lpipe, lres

    # the IMU path at full width: the default PipelineConfig (deskew=True)
    icfg = config_for("vlp16")
    clock("the IMU path")
    t0 = time.perf_counter()
    iposes, iscans, istamps = fast_yaw_course(icfg.sensor, IMU_SCANS)
    iimu = [fast_yaw_imu(k, icfg.sensor.scan_period) for k in range(IMU_SCANS)]
    bag_path = os.path.join(work.name, "imu_course.bag")
    bscans, bstamps, bimu = bag_course(icfg, iscans, istamps, iimu, bag_path)
    print(f"imu: {IMU_SCANS} swept VLP-16 scans of the fast-yaw course, "
          f"{sum(map(len, bimu))} IMU samples, through a ROS bag and back in "
          f"{time.perf_counter() - t0:.1f} s")
    if len(bscans) != IMU_SCANS or [len(b) for b in bimu] != [len(i) for i in iimu]:
        fail("the IMU course did not come back whole from its bag")
    # every arm replays the bag's clouds; the IMU arms push its IMU
    # messages too (examples/run_rosbag.py's --imu)
    arms = {tag: run_slice(torch, icfg.replace(deskew=dsk), bscans, iposes, dev,
                           IMU_WARM, IMU_SYNC, bstamps, bimu if with_imu else None)
            for tag, dsk, with_imu in (("off", False, False), ("on", True, False),
                                       ("imu", True, True), ("imu_off", False, True))}
    print("imu: the de-skew trio (ATE after rigid alignment, bench.py's "
          "definition; raw in brackets): " + ", ".join(
              f"{tag} {arms[tag]['ate_aligned_m']:.4f} m ({arms[tag]['ate_m']:.4f})"
              for tag in ("off", "on", "imu"))
          + f"; the IMU with de-skew off {arms['imu_off']['ate_aligned_m']:.4f} m "
          f"({arms['imu_off']['ate_m']:.4f})")
    # the de-skew + IMU arm's trajectory, which run_rosbag must repeat
    imu_traj = np.stack([r.fused_pose.t.cpu().numpy() for r in arms["imu"]["_rows"]])
    for tag, a in arms.items():
        a.pop("_rows")
        print(f"imu: {tag} arm {a['scans_per_s']:.2f} scans/s over "
              f"{a['window_scans']} scans; frontend_step {a['frontend_ms']:.2f} "
              f"ms, mapping_step {a['mapping_ms']:.2f} ms; peak memory "
              f"{a['peak_mem_bytes'] / 2**20:.1f} MiB; host syncs per scan "
              f"{a['host_syncs_per_scan']} by site {a['sync_sites']}; kernel "
              f"launches {a['launches']}")
        for key, count in a["launches"].items():
            if count == 0:
                fail(f"kernel {key} was not launched on the IMU phase's {tag} arm")
        if not np.isfinite(a["ate_aligned_m"]):
            fail(f"the IMU phase's {tag} arm lost its trajectory")
    for tag, base in (("imu", "on"), ("imu_off", "off")):
        if arms[tag]["host_syncs_per_scan"] != arms[base]["host_syncs_per_scan"]:
            fail(f"the IMU adds host syncs: {arms[tag]['host_syncs_per_scan']} a "
                 f"scan against {arms[base]['host_syncs_per_scan']} without it")
    # bench.py's order (on below off, the IMU arm under 0.2 m) is not
    # asserted: the constant-velocity de-skew diverges on this course in
    # the JAX package too (ROADMAP C8, tests/deskew_trio.py); the stable
    # arms are held to their bounds
    if not arms["off"]["ate_aligned_m"] < ATE_BOUND:
        fail(f"de-skew off ATE {arms['off']['ate_aligned_m']:.4f} m is not under "
             f"{ATE_BOUND} m")
    if not arms["imu_off"]["ate_aligned_m"] < IMU_ATE_BOUND:
        fail(f"IMU arm (de-skew off) ATE {arms['imu_off']['ate_aligned_m']:.4f} m "
             f"is not under {IMU_ATE_BOUND} m")

    # the card against a CPU run: the main path, the loop path and the IMU
    # path (de-skew on, the fast-yaw course's first scans and IMU stream)
    clock("the card against a CPU run")
    c6 = {}
    poses6, scans6 = slice_course(cfg.sensor)
    lpos, lscans6, lstamps = loop_course(cfg.sensor, LOOP_SHORT_OUT)
    for tag, ccfg, cscans, cstamps, cimu in (
            ("main", config_for("vlp16", **SMALL), scans6, [None] * len(scans6), None),
            ("loop", config_for("vlp16", **LOOP), lscans6, lstamps, None),
            ("imu", config_for("vlp16", **dict(SMALL, deskew=True)),
             iscans[:C6_IMU_SCANS], istamps[:C6_IMU_SCANS], iimu[:C6_IMU_SCANS]),
            ("faithful", config_for("vlp16", **dict(SMALL, **FAITHFUL)), scans6,
             [None] * len(scans6), None)):
        c6[tag], faults = card_against_cpu(torch, ccfg, cscans, cstamps,
                                           LOOP_CHECK_EVERY, dev, cimu)
        g = c6[tag]["gaps"]
        print(f"card vs cpu, {tag} path ({c6[tag]['scans']} scans, loop_closed "
              f"{c6[tag]['loop_closed']}): largest gaps fused "
              f"{g['fused_m'] * 1e3:.3f} mm / {g['fused_deg']:.4f} deg, keyframes "
              f"{g['keyframe_m'] * 1e3:.3f} mm / {g['keyframe_deg']:.4f} deg "
              f"(bound {C6_POS_M * 1e3:.0f} mm / {C6_ROT_DEG} deg); stats and "
              f"loop_closed " + ("equal" if not faults else "checked")
              + f"; from the card's own state, a mapping solve on the CPU "
              f"within {g['same_state_solve_m'] * 1e3:.4f} mm / "
              f"{g['same_state_solve_deg']:.5f} deg, a loop check within "
              f"{g['same_state_loop_m'] * 1e3:.4f} mm / "
              f"{g['same_state_loop_deg']:.5f} deg")
        if faults:
            fail(f"the card's {tag} path differs from the CPU run: "
                 + "; ".join(faults))
    if not any(c6["loop"]["loop_closed"]):
        fail("no loop closed on the card-against-CPU loop course")
    c6["chunk"], faults = card_against_cpu_chunks(torch, config_for("vlp16", **SMALL),
                                                  scans6, dev)
    g = c6["chunk"]["gaps"]
    print(f"card vs cpu, chunk arm ({c6['chunk']['scans']} scans in chunks of "
          f"{C6_CHUNK_C} on the card, process_scan on the CPU): largest gaps fused "
          f"{g['fused_m'] * 1e3:.3f} mm / {g['fused_deg']:.4f} deg, mapped "
          f"{g['mapped_m'] * 1e3:.3f} mm / {g['mapped_deg']:.4f} deg, keyframes "
          f"{g['keyframe_m'] * 1e3:.3f} mm / {g['keyframe_deg']:.4f} deg (bound "
          f"{C6_POS_M * 1e3:.0f} mm / {C6_ROT_DEG} deg); stats and did_map "
          + ("equal" if not faults else "checked"))
    if faults:
        fail("the card's chunks differ from the CPU run: " + "; ".join(faults))

    # the C++ reference's NumPy oracle against the port on the card
    clock("the C++ reference's oracle")
    oracle = oracle_phase(torch, dev)

    # fleet batching at full width (models/batch.py)
    clock("fleet batching")
    fleet, fchunks = fleet_phase(torch, cfg, scans, poses, lccfg, results, card, dev)

    # the distributed back end at world size 1 over NCCL
    clock("the distributed back end")
    par = parallel_phase(torch, cfg, scans, rows, sl["n_kf"], sl["mapping_ms"], lcfg,
                         lscans, stamps, dict(lp, **lp_end), results, card, dev)
    del lp_end

    # the user entry points (lego_loam_tpu_torch/examples/)
    clock("the drivers")
    drivers = drivers_phase(torch, dev, card, work.name, bag_path, imu_traj, hscans,
                            hposes)

    # the JAX package's behaviour tests on the card: degenerate scans, loop
    # false positives, stress courses (ROADMAP A20)
    clock("robustness")
    rob = robustness_phase(torch, dev, card)
    for r, key in zip(results, ("propagate_labels", "label_features", "knn", "eig6")):
        r["robustness_launches"] = rob["launches"]["full"][key]
        r["robustness"] = rob["kernels"][r["name"]]
    for r in results[4:]:
        r["robustness_launches"] = rob["launches"]["faithful"][r["name"]]
    print(f"robustness [{card}]: the phase took {rob['seconds']:.1f} s")

    # profiler phases last: they must not slow the timed ones
    clock("the profiler")
    k2_device_kernels(torch, results[1])
    sl["profile"] = pr = profile_scans(torch, cfg, scans, dev)
    print(f"slice: torch.profiler over {pr['scans']} steady scans: "
          f"{pr['device_events_per_scan']:.0f} device events a scan, device "
          f"busy {pr['device_busy_ms_per_scan']:.2f} ms of "
          f"{pr['host_ms_per_scan']:.2f} ms a scan (host clock, under the "
          f"profiler): device idle {100 * pr['device_idle_share']:.1f} %")
    faithful["profile"] = pf = profile_scans(torch, fcfg, scans, dev)
    print(f"faithful: torch.profiler over {pf['scans']} steady scans: "
          f"{pf['device_events_per_scan']:.0f} device events a scan (the slice "
          f"{pr['device_events_per_scan']:.0f}), device busy "
          f"{pf['device_busy_ms_per_scan']:.2f} ms of {pf['host_ms_per_scan']:.2f} "
          f"ms a scan (host clock, under the profiler): device idle "
          f"{100 * pf['device_idle_share']:.1f} %")
    chunk["stats"]["profile"] = pc = profile_chunk(torch, cfg, scans, dev)
    print(f"chunk: torch.profiler over one steady chunk of {pc['scans']} scans "
          f"(collect_stats=False): {pc['device_events_per_scan']:.0f} device events "
          f"a scan, device busy {pc['device_busy_ms_per_scan']:.2f} ms of "
          f"{pc['host_ms_per_scan']:.2f} ms a scan: device idle "
          f"{100 * pc['device_idle_share']:.1f} %")
    arms["on"]["profile"] = pon = profile_scans(torch, icfg, bscans, dev,
                                                stamps=bstamps)
    arms["imu"]["profile"] = pimu = profile_scans(torch, icfg, bscans, dev,
                                                  stamps=bstamps, imu=bimu)
    print(f"imu: torch.profiler over {pimu['scans']} steady scans of the fast-yaw "
          f"course: de-skew on {pon['device_events_per_scan']:.0f} device events "
          f"a scan (busy {pon['device_busy_ms_per_scan']:.2f} ms, idle "
          f"{100 * pon['device_idle_share']:.1f} %), with the IMU "
          f"{pimu['device_events_per_scan']:.0f} (busy "
          f"{pimu['device_busy_ms_per_scan']:.2f} ms, idle "
          f"{100 * pimu['device_idle_share']:.1f} %): the IMU adds "
          f"{pimu['device_events_per_scan'] - pon['device_events_per_scan']:.0f} "
          f"device events a scan")
    for B in (1, FLEET_B):
        fleet["runs"][B]["profile"] = pf = profile_fleet(torch, cfg, fchunks, dev, B)
        print(f"fleet [{card}]: torch.profiler over a steady chunk of 6 at B = {B}: "
              f"{pf['device_events_per_scan']:.0f} device events a step "
              f"({pf['device_events_per_scan'] / B:.0f} a scan), device busy "
              f"{pf['device_busy_ms_per_scan']:.2f} ms of "
              f"{pf['host_ms_per_scan']:.2f} ms a step: device idle "
              f"{100 * pf['device_idle_share']:.1f} %")

    # last: a driver under utils/tracing.trace
    clock("the traced driver")
    drivers["run_synthetic --imu, traced"] = trace_phase(torch, dev, work.name)
    for r, key in zip(results, ("propagate_labels", "label_features", "knn", "eig6")):
        r["drivers_launches"] = {tag: d["launches"][key] for tag, d in drivers.items()
                                 if "launches" in d}

    clock(None)
    work.cleanup()
    print(json.dumps({"slice": sl, "hdl64e": hl, "loop": lp, "imu": arms,
                      "chunk": chunk, "export": export, "card_vs_cpu": c6,
                      "faithful": faithful, "oracle": oracle, "parallel": par,
                      "k2_sequential_hdl64e": results[4]["hdl64e"],
                      "e1_3x3": {k: results[5][k] for k in (
                          "call_ms", "library_call_ms", "sweeps", "matrices",
                          "captured", "near_threshold_flips", "max_sweeps")},
                      "fleet": fleet, "drivers": drivers, "robustness": rob,
                      "phase_s": clock.seconds,
                      "k1_presets": results[0]["presets"],
                      "k2_hdl64e": results[1]["hdl64e"],
                      "e1": {k: results[3][k] for k in (
                          "call_ms", "library_call_ms", "sweeps", "matrices",
                          "captured", "near_threshold_flips", "max_sweeps")},
                      "card": card}))
    print(json.dumps({"kernels": [
        {key: r[key] for key in ("name", "route", "source", "replaces",
                                 "launches", "max_abs_err", "ms", "call_ms",
                                 "plain_ms", "bound_ms", "bound_by", "library_ms",
                                 "launches_per_loop_check", "loop_shapes",
                                 "launches_in_chunks", "fleet_launches",
                                 "fleet", "shard_shapes", "parallel_launches",
                                 "launches_per_sharded_solve", "drivers_launches",
                                 "robustness_launches", "robustness", "note")
         if key in r}
        for r in results]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
