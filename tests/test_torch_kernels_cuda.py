"""The three CUDA kernels against their plain PyTorch versions, on the card.

Skipped without a CUDA device (the `cuda` marker; decided inside the
fixture).  Run on a machine with an H100:

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -q

K1 (label propagation) and K2 (feature picks) must match exactly; K3 (k-NN)
to rtol 1e-4 / atol 1e-3 on distances with every returned index a valid
point at its distance (tests/test_knn_pallas.py's scheme), on shapes that
exercise its split / merge passes: ragged and single splits, partial query
blocks, k = 1 and 8, sentinel slots, and a duplicate point across splits
(the lower index first, as in the plain version).  chip_smoke.py
runs the same checks at the main path's full shapes.
"""

import numpy as np
import pytest
import torch

from lego_loam_tpu_torch import config_for
from lego_loam_tpu_torch.io import synthetic as syn
from lego_loam_tpu_torch.ops import features, knn, segmentation
from lego_loam_tpu_torch.ops.compaction import segment_scan
from lego_loam_tpu_torch.ops.ground import mark_ground
from lego_loam_tpu_torch.ops.projection import project_scan

pytestmark = pytest.mark.cuda
CFG = config_for("vlp16")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")


@pytest.fixture
def img(dev):
    xyz, valid, ring = syn.raycast(syn.default_world(3), np.eye(3),
                                   np.array([1.0, -2.0, 1.6]), CFG.sensor,
                                   noise=0.01, rng=np.random.default_rng(11))
    return project_scan(*(torch.as_tensor(a, device=dev) for a in (xyz, valid)),
                        CFG, torch.as_tensor(ring, device=dev))


def test_label_prop_kernel_matches_plain(img):
    ground = mark_ground(img, CFG)
    args = segmentation.label_inputs(*segmentation.build_edges(img, ground, CFG))
    n = segmentation.propagate_labels.launches
    got = segmentation.propagate_labels(*args, CFG.label_prop_max_sweeps)
    assert segmentation.propagate_labels.launches == n + 1
    ref = segmentation.propagate_labels_plain(*args, CFG.label_prop_max_sweeps)
    assert torch.equal(got, ref)
    assert 0 < int(segmentation.propagate_labels.last_sweeps) < CFG.label_prop_max_sweeps


def test_pick_kernel_matches_plain(img):
    packed = segment_scan(img, CFG)[0]
    args = features.pick_inputs(packed, CFG) + (
        CFG.sections_total, CFG.edge_feature_num_less, CFG.edge_feature_num,
        CFG.surf_feature_num)
    n = features.pick_features.launches
    lab, pick = features.pick_features(*args)
    assert features.pick_features.launches == n + 1
    lab_p, pick_p = features.pick_features_plain(*args)
    assert torch.equal(lab, lab_p) and torch.equal(pick, pick_p)
    assert int((lab == 2).sum()) > 0 and int((lab == -1).sum()) > 0


@pytest.mark.parametrize("q_n,r_n,k,n_valid,dup", [
    (100, 300, 5, None, False), (512, 513, 8, None, False),
    (1024, 8192, 5, None, False), (4096, 32768, 5, None, False),
    (300, 1000, 5, None, False),    # N not a multiple of the split
    (200, 100, 5, None, False),     # N within one split: S = 1, no merge pass
    (37, 1000, 5, None, False),     # Q under one block of 128 queries
    (37, 1000, 1, None, False), (300, 4000, 8, None, False),
    (100, 1000, 5, 3, False),       # fewer valid references than k
    (100, 1000, 5, 0, False),       # no valid reference
    (256, 4096, 5, None, True),     # one point at indices 5 and N - 3
])
def test_knn_kernel_matches_plain(dev, q_n, r_n, k, n_valid, dup):
    rng = np.random.default_rng(q_n + k)
    qn = (rng.standard_normal((q_n, 3)) * 20).astype(np.float32)
    rn = (rng.standard_normal((r_n, 3)) * 20).astype(np.float32)
    if n_valid is None:
        vn = rng.random(r_n) > 0.2
    else:
        vn = np.zeros(r_n, dtype=bool)
        vn[rng.choice(r_n, n_valid, replace=False)] = True
    S = knn.knn_splits(q_n, r_n)
    if dup:
        # the duplicate sits in the first and the last split, alone within
        # 4 m, and half the queries lie within centimetres of it
        split = -(-r_n // S)
        assert S > 1 and 5 // split != (r_n - 3) // split
        p = np.array([3.0, -2.0, 1.0], dtype=np.float32)
        off = rn - p
        dist = np.linalg.norm(off, axis=1, keepdims=True)
        rn = np.where(dist < 4.0, p + off / np.maximum(dist, 1e-3) * 4.0, rn)
        rn[[5, r_n - 3]] = p
        vn[[5, r_n - 3]] = True
        qn[: q_n // 2] = p + rng.standard_normal((q_n // 2, 3)) * 0.05
    q, r, valid = (torch.as_tensor(a, device=dev) for a in
                   (qn, rn.astype(np.float32), vn))
    n = knn.knn.launches
    idx, d2 = knn.knn(q, r, valid, k)
    assert knn.knn.launches == n + 1
    pidx, pd2 = knn.knn_plain(q, r, valid, k)
    torch.testing.assert_close(d2, pd2, rtol=1e-4, atol=1e-3)
    real = pd2 < 1e29                     # slots with a valid neighbour
    assert torch.equal(real, d2 < 1e29)
    assert bool((real.sum(1) == min(k, int(vn.sum()))).all())
    # sentinel slots: the lowest-index invalid references, as in plain
    assert torch.equal(idx[~real], pidx[~real])
    il = idx.long()
    assert bool(valid[il[real]].all())
    d_true = ((q[:, None, :] - r[il]) ** 2).sum(-1)
    torch.testing.assert_close(d_true[real], d2[real], rtol=1e-4, atol=1e-3)
    if dup:
        near = slice(0, q_n // 2)
        expect = torch.tensor([5, r_n - 3], dtype=torch.int32, device=dev)
        assert bool((idx[near, :2] == expect).all())
        assert torch.equal(idx[near, :2], pidx[near, :2])
        assert torch.equal(d2[near, 0], d2[near, 1])


def test_wrappers_reject_bad_inputs(dev):
    q = torch.zeros((8, 3), device=dev)
    r = torch.zeros((16, 3), device=dev)
    with pytest.raises(ValueError):
        knn.knn(q.double(), r.double(), torch.ones(16, dtype=torch.bool, device=dev), 5)
    with pytest.raises(ValueError):
        knn.knn(q, r, torch.ones(16, dtype=torch.bool, device=dev), 9)
    big = torch.zeros((128, 1800), dtype=torch.int32, device=dev)
    m = torch.zeros((128, 1800), dtype=torch.bool, device=dev)
    with pytest.raises(ValueError):       # VLS-128 does not fit one block
        segmentation.propagate_labels(big, m, m, m, m)
