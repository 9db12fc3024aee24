"""The port's utils/metrics.py and utils/tracing.py against the JAX
package's: the same seeded numpy inputs through both, equal to float64
round-off (1e-12); StageTimer under one patched clock; trace() writes its
file on the CPU."""

from __future__ import annotations

import glob
import json
import time

import numpy as np
import pytest
import torch

from lego_loam_tpu.utils import metrics as jm
from lego_loam_tpu.utils import tracing as jt
from lego_loam_tpu_torch.utils import metrics as tm
from lego_loam_tpu_torch.utils import tracing as tt

TOL = 1e-12


def _rotations(rng, n):
    q, _ = np.linalg.qr(rng.standard_normal((n, 3, 3)))
    return q * np.sign(np.linalg.det(q))[:, None, None]


def _trajectory(seed, n=40):
    """(true positions, estimated positions, true poses, estimated poses):
    a seeded random walk and a rotated, shifted, noisy estimate of it."""
    rng = np.random.default_rng(seed)
    gt = np.cumsum(rng.normal(0.0, 0.5, (n, 3)), axis=0)
    R = _rotations(rng, 1)[0]
    est = gt @ R.T + rng.normal(0.0, 2.0, 3) + rng.normal(0.0, 0.05, (n, 3))
    gt_T = jm.poses_to_mat(_rotations(rng, n), gt)
    est_T = jm.poses_to_mat(_rotations(rng, n), est)
    return gt, est, gt_T, est_T


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("align", [True, False])
def test_ate_rmse(seed, align):
    gt, est, _, _ = _trajectory(seed)
    a = jm.ate_rmse(est, gt, align=align)
    b = tm.ate_rmse(est, gt, align=align)
    assert abs(a - b) <= TOL * max(1.0, abs(a))


@pytest.mark.parametrize("with_scale", [False, True])
def test_umeyama_reflected_case(with_scale):
    """A mirrored estimate: the SVD's determinant test flips the last
    axis (the reflection fix), in both packages alike."""
    rng = np.random.default_rng(5)
    gt = rng.normal(0.0, 3.0, (30, 3))
    est = gt * np.array([1.0, 1.0, -1.0]) + rng.normal(0.0, 0.01, (30, 3))
    C = (gt - gt.mean(0)).T @ (est - est.mean(0)) / len(gt)
    U, _, Vt = np.linalg.svd(C)
    assert np.linalg.det(U) * np.linalg.det(Vt) < 0      # the fix applies
    Ra, ta, sa = jm.umeyama_alignment(est, gt, with_scale)
    Rb, tb, sb = tm.umeyama_alignment(est, gt, with_scale)
    np.testing.assert_allclose(Rb, Ra, rtol=0, atol=TOL)
    np.testing.assert_allclose(tb, ta, rtol=0, atol=TOL)
    assert abs(sa - sb) <= TOL
    assert np.linalg.det(Rb) > 0


@pytest.mark.parametrize("delta", [1, 3])
def test_rpe(delta):
    _, _, gt_T, est_T = _trajectory(1)
    a = jm.rpe(est_T, gt_T, delta=delta)
    b = tm.rpe(est_T, gt_T, delta=delta)
    np.testing.assert_allclose(b, a, rtol=TOL, atol=TOL)


def test_poses_to_mat():
    rng = np.random.default_rng(2)
    Rs, ts = _rotations(rng, 7), rng.normal(size=(7, 3))
    np.testing.assert_array_equal(tm.poses_to_mat(Rs, ts), jm.poses_to_mat(Rs, ts))


def test_metrics_recorder_summary():
    rng = np.random.default_rng(4)
    a, b = jm.MetricsRecorder(), tm.MetricsRecorder()
    assert a.summary() == b.summary() == {}
    for k in range(25):
        kw = dict(frame=k, ms=float(rng.gamma(2.0, 10.0)), n_sharp=int(rng.integers(50, 200)),
                  tag="x")
        a.add(**kw)
        b.add(**kw)
    sa, sb = a.summary(), b.summary()
    assert sa.keys() == sb.keys() and "tag" not in sb
    for key in sa:
        for stat in ("mean", "p50", "p95"):
            assert abs(sa[key][stat] - sb[key][stat]) <= TOL * max(1.0, abs(sa[key][stat]))


def test_stage_timer_summary(monkeypatch):
    """Both timers on the same patched time.perf_counter ticks: equal
    summaries."""
    clock = np.cumsum(np.random.default_rng(6).gamma(2.0, 0.004, 200))
    timers = (jt.StageTimer(), tt.StageTimer())
    for timer in timers:
        ticks = iter(clock)
        monkeypatch.setattr(time, "perf_counter", lambda: float(next(ticks)))
        for name in ("front", "map", "front", "loop", "front", "map"):
            with timer.stage(name):
                pass
    sa, sb = (t.summary() for t in timers)
    assert sa.keys() == sb.keys() == {"front", "map", "loop"}
    for name in sa:
        assert sa[name]["n"] == sb[name]["n"]
        for stat in ("mean_ms", "p50_ms", "p95_ms"):
            assert abs(sa[name][stat] - sb[name][stat]) <= TOL * max(1.0, abs(sa[name][stat]))


def test_trace_writes_a_chrome_trace(tmp_path):
    """trace() on the CPU: one Chrome trace file in the directory, naming
    the ops that ran under it."""
    x = torch.arange(12.0).reshape(3, 4)
    with tt.trace(str(tmp_path / "tr")):
        torch.mm(x, x.T).sum()
    files = glob.glob(str(tmp_path / "tr" / "trace_*.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "aten::mm" for e in events)


def test_courses_aligned_ate_is_ate_rmse():
    """tests/torch_courses.aligned_ate (bench.py's aligned ATE, which
    chip_smoke.py reports) is the JAX package's ate_rmse."""
    from tests.torch_courses import aligned_ate

    for seed in (0, 3):
        gt, est, _, _ = _trajectory(seed)
        a = jm.ate_rmse(est, gt)
        assert abs(aligned_ate(est, gt) - a) <= TOL * max(1.0, a)
        assert abs(aligned_ate(est.astype(np.float32), gt) -
                   jm.ate_rmse(est.astype(np.float32), gt)) <= TOL
