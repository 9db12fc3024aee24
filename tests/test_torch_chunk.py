"""Chunked replay in the port (LegoLoamPipeline.process_chunk, the JAX
package's chunk_steps as a host loop over the per-scan step) on the CPU.

  * tests/torch_courses.py's SMALL config over its 6-scan course through
    process_chunk with C = 3 and with C = 4 (chunk boundaries in different
    places: 3 + 3 and 4 + 2, as tests/test_chunk.py checks it in the JAX
    package), each against the port's own process_scan: every odometry,
    fused and mapped pose within 1e-5 m / 1e-4 deg, did_map, the packed
    stats and the keyframe count equal.  The C = 4 run takes
    collect_stats=False and finishes its last 2 scans through process_scan
    in that mode: nothing comes to the host (device poses and loop flags,
    stats {}), and the state still advances exactly as the per-scan run's.
  * the C = 3 chunks against the JAX package's process_scan over the same
    scans, at tests/test_torch_pipeline.py's 1 cm / 0.1 deg with equal
    stats and mapping cadence.  No JAX chunk_steps program is built: cold,
    tests/test_chunk.py alone takes ~15 minutes on a CPU.
  * one IMU chunk: SMALL with deskew=True over the fast-yaw course's first
    4 scans, every IMU sample of the chunk pushed before it, against
    process_scan with the samples up to each sweep's end pushed before the
    scan, at the same 1e-5 m / 1e-4 deg.

The loop course is not run here (its JAX side takes ~6 s a scan on a
CPU); chip_smoke.py drives it through process_chunk on the card.
"""

import numpy as np
import pytest
import torch

from lego_loam_tpu import config_for as jconfig_for
from lego_loam_tpu.models.pipeline import LegoLoamPipeline as JaxPipeline
from lego_loam_tpu_torch import config_for
from lego_loam_tpu_torch.models.pipeline import STAT_NAMES, LegoLoamPipeline

from tests.test_torch_backend import _rot_err_deg
from tests.torch_courses import SMALL, fast_yaw_course, fast_yaw_imu, slice_course

SAME_M, SAME_DEG = 1e-5, 1e-4        # chunked against per-scan, one package
JAX_M, JAX_DEG = 1e-2, 0.1           # the port against the JAX package
IMU_SCANS = 4


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Several workers share the host; one torch thread each (as
    tests/test_torch_hdl64e.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _stack(scans):
    return tuple(np.stack([s[i] for s in scans]) for i in range(3))


def _per_scan(cfg, scans, imu=None):
    """process_scan over the scans (with `imu`, a list of IMU samples for
    each scan pushed before it): (pipeline, rows of (odom, fused, mapped or
    None, stats))."""
    pipe = LegoLoamPipeline(cfg, "cpu")
    rows = []
    for k, scan in enumerate(scans):
        for sample in (imu[k] if imu is not None else ()):
            pipe.push_imu(*sample)
        r = pipe.process_scan(*scan)
        rows.append((r.odom_pose, r.fused_pose, r.mapped_pose,
                     [r.stats[n] for n in STAT_NAMES]))
    return pipe, rows


def _assert_pose(R, t, ref, tol_m, tol_deg, what):
    np.testing.assert_allclose(t.numpy(), ref.t.numpy(), atol=tol_m, err_msg=what)
    assert _rot_err_deg(ref.R.numpy(), R.numpy()) < tol_deg, what


def _assert_chunks_match(results, rows):
    """Stacked chunk results against the per-scan rows, scan by scan."""
    k = 0
    for res in results:
        for j in range(res.did_map.shape[0]):
            odom, fused, mapped, stats = rows[k]
            _assert_pose(res.odom_poses.R[j], res.odom_poses.t[j], odom,
                         SAME_M, SAME_DEG, f"odom {k}")
            _assert_pose(res.fused_poses.R[j], res.fused_poses.t[j], fused,
                         SAME_M, SAME_DEG, f"fused {k}")
            assert bool(res.did_map[j]) == (mapped is not None), k
            if mapped is not None:
                _assert_pose(res.mapped_poses.R[j], res.mapped_poses.t[j], mapped,
                             SAME_M, SAME_DEG, f"mapped {k}")
            assert res.stats[j].tolist() == stats, k
            assert not bool(res.loop_closed[j])
            k += 1
    assert k == len(rows)


@pytest.fixture(scope="module")
def course():
    cfg = config_for("vlp16", **SMALL)
    _, scans = slice_course(cfg.sensor)
    return cfg, scans


@pytest.fixture(scope="module")
def per_scan(course):
    return _per_scan(*course)


@pytest.fixture(scope="module")
def chunk3(course):
    cfg, scans = course
    pipe = LegoLoamPipeline(cfg, "cpu")
    return pipe, [pipe.process_chunk(*_stack(scans[k:k + 3])) for k in (0, 3)]


def test_chunks_of_three_match_process_scan(course, per_scan, chunk3):
    ref, rows = per_scan
    pipe, results = chunk3
    assert [len(r.did_map) for r in results] == [3, 3]
    _assert_chunks_match(results, rows)
    assert pipe.frame == ref.frame == 6
    assert int(pipe.mstate.n_kf) == int(ref.mstate.n_kf)
    np.testing.assert_allclose(pipe.keyframe_poses(), ref.keyframe_poses(), atol=SAME_M)
    # collect_stats: one host copy a chunk brought the trajectory back
    assert all(isinstance(p, np.ndarray) for p in pipe.trajectory)
    np.testing.assert_allclose(np.stack(pipe.trajectory), np.stack(ref.trajectory),
                               atol=SAME_M)


def test_chunk_of_four_then_scans_without_stats(course, per_scan):
    cfg, scans = course
    ref, rows = per_scan
    pipe = LegoLoamPipeline(cfg, "cpu", collect_stats=False)
    res = pipe.process_chunk(*_stack(scans[:4]))
    _assert_chunks_match([res], rows[:4])
    for k in (4, 5):
        r = pipe.process_scan(*scans[k])
        odom, fused, mapped, _ = rows[k]
        assert r.stats == {}
        assert isinstance(r.loop_closed, torch.Tensor) and not bool(r.loop_closed)
        assert (r.mapped_pose is None) == (mapped is None)
        _assert_pose(r.fused_pose.R, r.fused_pose.t, fused, SAME_M, SAME_DEG, f"fused {k}")
        _assert_pose(r.odom_pose.R, r.odom_pose.t, odom, SAME_M, SAME_DEG, f"odom {k}")
    # the trajectory stayed on the device side: a (4, 3) block, then rows
    assert all(isinstance(p, torch.Tensor) for p in pipe.trajectory)
    assert [tuple(p.shape) for p in pipe.trajectory] == [(4, 3), (3,), (3,)]
    np.testing.assert_allclose(pipe.trajectory_numpy(), np.stack(ref.trajectory),
                               atol=SAME_M)
    assert int(pipe.mstate.n_kf) == int(ref.mstate.n_kf)


def test_chunks_match_jax_process_scan(course, chunk3):
    cfg, scans = course
    _, results = chunk3
    jpipe = JaxPipeline(jconfig_for("vlp16", **SMALL))
    jrows = [jpipe.process_scan(*s) for s in scans]
    fused_R = torch.cat([r.fused_poses.R for r in results]).numpy()
    fused_t = torch.cat([r.fused_poses.t for r in results]).numpy()
    stats = torch.cat([r.stats for r in results]).tolist()
    did_map = torch.cat([r.did_map for r in results]).tolist()
    for k, jr in enumerate(jrows):
        assert stats[k] == [jr.stats[n] for n in STAT_NAMES], k
        assert did_map[k] == (jr.mapped_pose is not None), k
        np.testing.assert_allclose(fused_t[k], np.asarray(jr.fused_pose.t), atol=JAX_M)
        assert _rot_err_deg(np.asarray(jr.fused_pose.R), fused_R[k]) < JAX_DEG, k
    np.testing.assert_allclose(chunk3[0].keyframe_poses(), jpipe.keyframe_poses(),
                               atol=JAX_M)


def test_imu_chunk_matches_process_scan():
    """The offline-replay contract (tests/test_chunk.py's IMU case): the
    chunk's buffer holds the whole stream up front, the per-scan run's
    every sample up to its sweep's end, which is the next sweep's first."""
    cfg = config_for("vlp16", **dict(SMALL, deskew=True))
    period = cfg.sensor.scan_period
    _, scans, stamps = fast_yaw_course(cfg.sensor, IMU_SCANS)
    stream = [s for k in range(IMU_SCANS + 1) for s in fast_yaw_imu(k, period)]
    upto = [sum(1 for s in stream if s[0] <= t + period + 1e-9) for t in stamps]
    imu = [stream[a:b] for a, b in zip([0] + upto[:-1], upto)]
    ref, rows = _per_scan(cfg, scans, imu)
    pipe = LegoLoamPipeline(cfg, "cpu")
    for sample in stream[:upto[-1]]:
        pipe.push_imu(*sample)
    xyz, valid, ring = _stack(scans)
    res = pipe.process_chunk(xyz, valid, ring, t0=stamps[0])
    _assert_chunks_match([res], rows)
    assert int(pipe.mstate.n_kf) == int(ref.mstate.n_kf)


def test_pending_loop_flag_settles_map_stale():
    """A loop check's flag waits on the device until the host reads it: in
    the next host copy, or just before the next solve (sync_map_stale).  An
    accepted loop marks the cached local map stale; a rejected one does
    not, and a flag is read once."""
    cfg = config_for("vlp16", **SMALL)
    pipe = LegoLoamPipeline(cfg, "cpu", collect_stats=False)
    pipe.mstate = pipe.mstate._replace(map_stale=False)
    pipe._loop_flag = torch.tensor(False) | torch.tensor(False)
    pipe.sync_map_stale()
    assert pipe._loop_flag is None and pipe.mstate.map_stale is False
    pipe._loop_flag = torch.tensor(False) | torch.tensor(True)
    pipe.sync_map_stale()
    assert pipe._loop_flag is None and pipe.mstate.map_stale is True
    pipe.mstate = pipe.mstate._replace(map_stale=False)
    pipe.sync_map_stale()                     # nothing pending: no change
    assert pipe.mstate.map_stale is False
    # the host copy carries a pending flag along and settles it
    pipe._loop_flag = torch.tensor(True)
    vals = pipe._copy_to_host(torch.tensor([1.5, 2.5]), torch.tensor([7], dtype=torch.int32))
    assert vals == [1.5, 2.5, 7.0]
    assert pipe._loop_flag is None and pipe.mstate.map_stale is True
