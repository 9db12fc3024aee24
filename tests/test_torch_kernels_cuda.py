"""The three CUDA kernels against their plain PyTorch versions, on the card.

Skipped without a CUDA device (the `cuda` marker; decided inside the
fixture).  Run on a machine with an H100:

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -q

K1 (label propagation) and K2 (feature picks) must match exactly; K1 at
every sensor preset's grid (one synthetic scan each) and on the built masks
of tests/test_torch_label_prop.py (a serpentine through every tile border,
a join across the column seam, full and empty grids, masks near the site
and bond percolation thresholds, one column through all rows), on the
VLS-128 grid and on ragged ones, where it must also equal a scipy
reference; K2 on a VLP-16 scan and on an HDL-64E one (64 x 1800, rows from
elevation math); K3 (k-NN)
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

from tests.test_torch_label_prop import (CASES, SHAPES, label_args,
                                         label_case, reference_labels)
from tests.test_torch_sensor_rows import mid_row

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


def _k1_matches_plain(args, max_sweeps):
    n = segmentation.propagate_labels.launches
    got = segmentation.propagate_labels(*args, max_sweeps)
    assert segmentation.propagate_labels.launches == n + 1
    ref = segmentation.propagate_labels_plain(*args, max_sweeps)
    assert torch.equal(got, ref)
    return got


def test_label_prop_kernel_matches_plain(img):
    ground = mark_ground(img, CFG)
    seg, edge_h, edge_v = segmentation.build_edges(img, ground, CFG)
    _k1_matches_plain(segmentation.label_inputs(seg, edge_h, edge_v),
                      CFG.label_prop_max_sweeps)


@pytest.mark.parametrize("preset", ["vlp16", "os1_16", "hdl32e", "os1_64",
                                    "hdl64e", "vls128"])
def test_label_prop_kernel_matches_plain_at_preset(dev, preset):
    cfg = config_for(preset)
    xyz, valid, ring = syn.raycast(syn.default_world(5), np.eye(3),
                                   np.array([2.0, 1.0, 1.7]), cfg.sensor,
                                   noise=0.01, rng=np.random.default_rng(3))
    im = project_scan(*(torch.as_tensor(a, device=dev) for a in (xyz, valid)),
                      cfg, torch.as_tensor(ring, device=dev)
                      if cfg.sensor.use_ring else None)
    edges = segmentation.build_edges(im, mark_ground(im, cfg), cfg)
    labels = _k1_matches_plain(segmentation.label_inputs(*edges),
                               cfg.label_prop_max_sweeps)
    assert labels.shape == (cfg.sensor.n_scan, cfg.sensor.horizon_scan)
    assert int(edges[0].sum()) > 1000


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("name,seed", [(c, 0) for c in CASES]
                         + [("site", 1), ("bond", 1), ("site", 2)])
def test_label_prop_kernel_on_built_masks(dev, name, seed, shape):
    R, H = shape
    masks = label_case(name, R, H, seed)
    # a budget of R*H sweeps lets the plain loop reach the fixpoint
    got = _k1_matches_plain(label_args(*masks, device=dev), R * H)
    np.testing.assert_array_equal(got.cpu().numpy(), reference_labels(*masks))


@pytest.mark.parametrize("preset", ["vlp16", "hdl64e"])
def test_pick_kernel_matches_plain(dev, img, preset):
    cfg = config_for(preset, deskew=False)
    if cfg.sensor.use_ring:
        im = img
    else:
        # the HDL-64E path of chip_smoke.py: rows from elevation math
        xyz, valid, _ = syn.raycast(syn.default_world(9), np.eye(3),
                                    np.array([1.0, 2.0, 1.7]), cfg.sensor,
                                    noise=0.02, rng=np.random.default_rng(4))
        im = project_scan(torch.as_tensor(mid_row(xyz, cfg.sensor), device=dev),
                          torch.as_tensor(valid, device=dev), cfg, None)
    packed = segment_scan(im, cfg)[0]
    args = features.pick_inputs(packed, cfg) + (
        cfg.sections_total, cfg.edge_feature_num_less, cfg.edge_feature_num,
        cfg.surf_feature_num)
    n = features.pick_features.launches
    lab, pick = features.pick_features(*args)
    assert features.pick_features.launches == n + 1
    lab_p, pick_p = features.pick_features_plain(*args)
    assert torch.equal(lab, lab_p) and torch.equal(pick, pick_p)
    assert lab.shape[0] == cfg.sensor.n_scan
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
    lab = torch.zeros((16, 1800), dtype=torch.int32, device=dev)
    m = torch.zeros((16, 1800), dtype=torch.bool, device=dev)
    with pytest.raises(ValueError):
        segmentation.propagate_labels(lab.long(), m, m, m, m)
    with pytest.raises(ValueError):
        segmentation.propagate_labels(lab, m, m.t().contiguous().t(), m, m)
    # 512 x 64 tiles of 8 x 64 pixels: more blocks than the card holds at
    # once, which a cooperative launch cannot take
    big = torch.zeros((4096, 4096), dtype=torch.int32, device=dev)
    bm = torch.zeros((4096, 4096), dtype=torch.bool, device=dev)
    n = segmentation.propagate_labels.launches
    with pytest.raises(ValueError, match="co-resident"):
        segmentation.propagate_labels(big, bm, bm, bm, bm)
    assert segmentation.propagate_labels.launches == n
