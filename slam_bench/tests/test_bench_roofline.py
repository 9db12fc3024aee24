"""The benchmark's roofline arithmetic reproduces the port's smoke run's
counts (chip_smoke.py) for K1, K2, K3 and E1."""

import sys
from pathlib import Path

import pytest
import torch

from lego_loam_tpu_torch import config_for
from slam_bench import roofline as rf

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
import chip_smoke as cs  # noqa: E402

PEAKS = rf.PEAKS["NVIDIA H100 80GB HBM3"]


def test_peaks_are_the_smoke_runs():
    assert PEAKS["bytes_per_s"] == cs.MEM_BYTES_PER_S
    assert PEAKS["fp32_per_s"] == cs.FP32_OPS_PER_S
    assert PEAKS["fp64_per_s"] == cs.FP64_OPS_PER_S


@pytest.mark.parametrize("shape", [(16, 1800), (8, 64, 1800)])
def test_k1_is_twelve_bytes_a_pixel(shape):
    labels = torch.zeros(shape, dtype=torch.int32)
    masks = [torch.zeros(shape, dtype=torch.bool)] * 4
    want = cs.nbytes(labels, *masks, labels)
    assert rf.k1_work(labels.numel()) == (want, 0)
    assert rf.bound_s(*rf.k1_work(labels.numel()), PEAKS) * 1e3 == pytest.approx(
        cs.bound(want, 0)[0])


@pytest.mark.parametrize("sensor", ["vlp16", "hdl64e"])
def test_k2_matches_the_smoke_runs_bound(sensor):
    cfg = config_for(sensor)
    R, W = cfg.sensor.n_scan, cfg.sensor.horizon_scan
    g = torch.Generator().manual_seed(0)
    count = torch.randint(0, W + 50, (3, R), generator=g, dtype=torch.int32)
    kept = int(count.clamp(0, W).sum())
    steps = cfg.edge_feature_num_less + cfg.surf_feature_num
    got = rf.bound_s(*rf.k2_work(kept, count.numel() * W, count.numel(), steps), PEAKS)
    assert got * 1e3 == pytest.approx(cs.k2_bound(cfg, count, count.numel() * W)[0])


def test_k3_matches_the_smoke_runs_bound():
    B, Q, N, k = 2, 4096, 32768, 5
    q = torch.zeros(Q, 3)
    r = torch.zeros(N, 3)
    valid = torch.rand(N, generator=torch.Generator().manual_seed(1)) < 0.6
    idx = torch.zeros(Q, k, dtype=torch.int32)
    d2 = torch.zeros(Q, k)
    n_bytes, ops = rf.k3_work(1, Q, N, k, int(valid.sum()))
    assert n_bytes == cs.nbytes(q, r, valid, idx, d2)
    assert ops == 8 * Q * int(valid.sum())
    assert rf.bound_s(n_bytes, ops, PEAKS) * 1e3 == pytest.approx(
        cs.bound(n_bytes, ops)[0])
    assert rf.k3_work(B, Q, N, k, 2 * int(valid.sum())) == (2 * n_bytes, 2 * ops)


@pytest.mark.parametrize("n", [3, 6])
@pytest.mark.parametrize("sweeps", [0, 1, 4])
def test_e1_matches_the_smoke_runs_counts(n, sweeps):
    assert rf.e1_bytes(n) == cs.e1_bytes(n)
    assert rf.e1_ops(sweeps, n) == cs.e1_ops(sweeps, n)
    assert rf.bound_s(rf.e1_bytes(n), rf.e1_ops(sweeps, n), PEAKS,
                      "fp64_per_s") * 1e3 == pytest.approx(cs.e1_bound(sweeps, n)[0])
