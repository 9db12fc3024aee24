"""The port at the shipping capacity (max_keyframes=4096), the counterpart
of tests/test_scale.py: the port's solve_pose_graph, compact_keyframes and
a solve after compaction, on the same drifted two-lap chain state that
test builds (converted with utils/convert.state_from_numpy), held to that
test's own assertions.  The solve is also held against the JAX package's
solve of the same state (~7 s from a cold .jax_cache_cpu, and the same
program as tests/test_scale.py's): the port must correct at least as much.
The chain's measurements are exact, so the graph's optimum is the truth;
the JAX package's solve stops at a mean error of 6.18 m whatever
pg_gn_iters (10, 20 or 40), the port's reaches 0.0028 m (ROADMAP C13).
torch runs on one thread."""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch

from lego_loam_tpu.models import posegraph as jpg
from lego_loam_tpu_torch import config_for
from lego_loam_tpu_torch.models import mapping as tmp
from lego_loam_tpu_torch.models import posegraph as tpg
from lego_loam_tpu_torch.utils.convert import state_from_numpy
from tests.test_scale import CFG4K, _add_loop, _two_lap_chain

TCFG = config_for("vlp16", **{f.name: getattr(CFG4K, f.name)
                              for f in dataclasses.fields(CFG4K) if f.name != "sensor"})


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_state(state):
    return state_from_numpy(jax.device_get(state), "cpu")


def test_config_is_test_scales():
    assert dataclasses.asdict(TCFG) == dataclasses.asdict(CFG4K) | {
        "sensor": dataclasses.asdict(TCFG.sensor)}
    assert TCFG.max_keyframes == 4096


def test_solve_at_default_capacity():
    """n_kf = 4000 of 4096, loop edges from lap 2 to lap 1, no warm start:
    >= 90 % of the end drift and >= 60 % of the mean corrected."""
    n = 4000
    state, trues = _two_lap_chain(n, CFG4K)
    gt = np.asarray([p[1] for p in trues])
    errs_before = np.linalg.norm(np.asarray(state.kf_t)[:n] - gt, axis=1)
    assert errs_before[-1] > 2.0
    half = n // 2
    for s, i in enumerate(range(half, n, 400)):
        state = _add_loop(state, i, i - half, trues, slot=s)

    solved = tpg.solve_pose_graph(_port_state(state), TCFG)
    kf_t = solved.kf_t.numpy()
    errs_after = np.linalg.norm(kf_t[:n] - gt, axis=1)
    end_corr = 1.0 - errs_after[-1] / errs_before[-1]
    mean_corr = 1.0 - errs_after.mean() / errs_before.mean()
    assert end_corr >= 0.90, f"end corrected {end_corr:.1%}"
    assert mean_corr >= 0.60, f"mean corrected {mean_corr:.1%}"
    np.testing.assert_array_equal(kf_t[n:], 0.0)
    assert np.isfinite(kf_t[:n]).all()
    # the JAX package's solve of the same state corrects no more
    jsolved = jpg.solve_pose_graph(state, CFG4K)
    jerrs = np.linalg.norm(np.asarray(jsolved.kf_t)[:n] - gt, axis=1)
    assert errs_after[-1] <= jerrs[-1] + 1e-3
    assert errs_after.mean() <= jerrs.mean() + 1e-3


def test_compaction_at_default_capacity():
    """The pool at K-1 compacted: the kept keyframes, the recomposed chain,
    the remapped loop edges, map_stale, and a solve of the thinned graph."""
    K = TCFG.max_keyframes
    n = K - 1
    state, trues = _two_lap_chain(n, CFG4K)
    half_lap = n // 2
    for s, i in enumerate(range(half_lap, n, 900)):
        state = _add_loop(state, i, i - half_lap, trues, slot=s)
    n_loops_before = int(state.n_loops)
    li_before = np.asarray(state.loop_i)[:n_loops_before]
    lj_before = np.asarray(state.loop_j)[:n_loops_before]
    kf_t_before = np.asarray(state.kf_t).copy()

    out = tmp.compact_keyframes(_port_state(state), TCFG)

    half = n // 2
    expect_kept = [i for i in range(half) if i % 2 == 0] + list(range(half, n))
    assert int(out.n_kf) == len(expect_kept)
    for new_i in range(0, len(expect_kept), 321):
        np.testing.assert_allclose(out.kf_t[new_i].numpy(),
                                   kf_t_before[expect_kept[new_i]], atol=1e-6)
    kf_R, kf_t = out.kf_R.numpy(), out.kf_t.numpy()
    meas_R, meas_t = out.kf_meas_R.numpy(), out.kf_meas_t.numpy()
    for start in (1, 1234, 2345, len(expect_kept) - 40):
        for i in range(start, min(start + 30, len(expect_kept))):
            np.testing.assert_allclose(kf_t[i - 1] + kf_R[i - 1] @ meas_t[i],
                                       kf_t[i], atol=2e-2)
            np.testing.assert_allclose(kf_R[i - 1] @ meas_R[i], kf_R[i], atol=5e-4)
    kept_pos = {old: new for new, old in enumerate(expect_kept)}
    expected_edges = [(kept_pos[i], kept_pos[j])
                      for i, j in zip(li_before, lj_before)
                      if i in kept_pos and j in kept_pos]
    assert int(out.n_loops) == len(expected_edges)
    got = list(zip(out.loop_i[:int(out.n_loops)].tolist(),
                   out.loop_j[:int(out.n_loops)].tolist()))
    assert got == expected_edges
    assert out.map_stale is True

    trues_kept = [trues[i] for i in expect_kept]
    last = len(expect_kept) - 1
    errs_before = np.linalg.norm(kf_t[last] - trues_kept[-1][1])
    solved = tpg.solve_pose_graph(out, TCFG)
    errs_after = np.linalg.norm(solved.kf_t[last].numpy() - trues_kept[-1][1])
    assert errs_after <= errs_before + 1e-3
    assert np.isfinite(solved.kf_t[:len(expect_kept)].numpy()).all()
