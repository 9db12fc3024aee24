"""The three CUDA kernels against their plain PyTorch versions, on the card.

Skipped without a CUDA device (the `cuda` marker; decided inside the
fixture).  Run on a machine with an H100:

    python -m pytest tests/test_torch_kernels_cuda.py -q

K1 (label propagation) and K2 (feature picks) must match exactly; K3 (k-NN)
to rtol 1e-4 / atol 1e-3 on distances with every returned index a valid
point at its distance (tests/test_knn_pallas.py's scheme).  chip_smoke.py
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


@pytest.mark.parametrize("q_n,r_n,k", [(100, 300, 5), (512, 513, 8),
                                       (1024, 8192, 5), (4096, 32768, 5)])
def test_knn_kernel_matches_plain(dev, q_n, r_n, k):
    rng = np.random.default_rng(q_n + k)
    q = torch.as_tensor((rng.standard_normal((q_n, 3)) * 20).astype(np.float32), device=dev)
    r = torch.as_tensor((rng.standard_normal((r_n, 3)) * 20).astype(np.float32), device=dev)
    valid = torch.as_tensor(rng.random(r_n) > 0.2, device=dev)
    n = knn.knn.launches
    idx, d2 = knn.knn(q, r, valid, k)
    assert knn.knn.launches == n + 1
    pidx, pd2 = knn.knn_plain(q, r, valid, k)
    torch.testing.assert_close(d2, pd2, rtol=1e-4, atol=1e-3)
    il = idx.long()
    assert bool(valid[il].all())
    d_true = ((q[:, None, :] - r[il]) ** 2).sum(-1)
    torch.testing.assert_close(d_true, d2, rtol=1e-4, atol=1e-3)


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
