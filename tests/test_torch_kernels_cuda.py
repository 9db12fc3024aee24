"""The five CUDA kernels against their plain PyTorch versions, on the card.

Skipped without a CUDA device (the `cuda` marker; decided inside the
fixture).  Run on a machine with an H100:

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -q

K1 (label propagation) and K2 (the whole feature-label step) must match
exactly; K1 at every sensor preset's grid (one synthetic scan each) and on
the built masks of tests/test_torch_label_prop.py (a serpentine through
every tile border, a join across the column seam, full and empty grids,
masks near the site and bond percolation thresholds, one column through
all rows), on the VLS-128 grid and on ragged ones, where it must also
equal a scipy reference; K2 (one launch a call) at every sensor preset
(one synthetic scan each; HDL-64E with rows from elevation math) and on
the built and random rows of tests/test_torch_feature_rows.py under 13
configs (each threshold at, and one ulp either side of, a value the rows
hold; edge_prominence 0, 1 and 4), in either pick order (sector_parallel
and the reference's sequential order); K3 (k-NN)
to rtol 1e-4 / atol 1e-3 on distances with every returned index a valid
point at its distance (tests/test_knn_pallas.py's scheme), on shapes that
exercise its split / merge passes: ragged and single splits, partial query
blocks, k = 1 and 8, sentinel slots, and a duplicate point across splits
(the lower index first, as in the plain version); E1 (the 6x6 and 3x3
degeneracy projection) on tests/torch_courses.eig6_spectra at both
pipeline thresholds, one matrix a call and all in one batch: P within
1e-5, eigenvalues within 1e-5 of |H|, the keep mask equal, no host sync.
Each kernel's batched launch, as fleet batching (models/batch.py) makes it
through its custom op's vmap rule, is held against its plain version a
sequence at a time: K1 on batches of VLP-16 (8 scans, one cooperative
launch), HDL-64E (8) and VLS-128 (3) scans, the last two beyond one
launch's co-resident blocks (the fewest launches that fit); K2 on 8
VLP-16 and 3 HDL-64E scans in one launch, in either pick order; K3 on 8
searches at the mapping
and loop shapes in one launch, each equal to its own launch bit for bit;
E1 on 4 stacks of spectra in one launch without a host sync.
K4 (the odometry's correspondence search, ops/assoc.py) in each kind
(corner; tri and knn with the class gate off and on) on
tests/torch_courses.assoc_case's searches (16 and 64 rings, an empty
category, a category of one, duplicate points, invalid and all-invalid
references, NaN query rows, Q and N off the block and tile sizes) and at
the pipelines' shapes (256 x 2048, 512 x 4096, 1024 x 4096, 2048 x
8192, and HDL-64E's own 1024 x 8192 and 2048 x 16384): where the plain
path's best and second best in a slot lie more than 1e-4 apart the
indices are equal, elsewhere each pick satisfies its
slot's predicate (from the kernel's own earlier picks) within rtol 1e-4 /
atol 1e-3 of the category's minimum, a duplicate never wins over its
lower index, an empty category gives (0, 1e30), a NaN row the plain
path's picks; 2 to 32 lanes a query (a single sequence's search) equal
one lane bit for bit on those searches and at 512 x 4096; one vmapped
call of 8 sequences is one launch, equal to 8 launches bit for bit, and
allocates no (B, Q, N) matrix.
chip_smoke.py runs the same checks at the main path's full shapes.

Beside the kernels: the voxel centroids (ops/voxel.py's fixed-point sums)
repeat bit for bit on the card and equal the CPU's.
"""

import numpy as np
import pytest
import torch

from lego_loam_tpu_torch import config_for
from lego_loam_tpu_torch.io import synthetic as syn
from lego_loam_tpu_torch.ops import assoc, eig6, features, knn, segmentation
from lego_loam_tpu_torch.ops.compaction import segment_scan
from lego_loam_tpu_torch.ops.ground import mark_ground
from lego_loam_tpu_torch.ops.projection import project_scan
from lego_loam_tpu_torch.ops.voxel import voxel_downsample

from tests.test_torch_feature_rows import (THRESHOLD_CFGS, built_rows,
                                           packed_from, random_rows)
from tests.test_torch_label_prop import (CASES, SHAPES, label_args,
                                         label_case, reference_labels)
from tests.test_torch_sensor_rows import mid_row
from tests.torch_courses import (ASSOC_CASES, assoc_case, assoc_cloud, assoc_faults,
                                 eig6_spectra)

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


def _k2_matches_plain(packed, cfg):
    n = features.label_features.launches
    lab, pick = features.label_features(packed, cfg)
    assert features.label_features.launches == n + 1
    lab_p, pick_p = features.label_features_plain(packed, cfg)
    assert torch.equal(lab, lab_p) and torch.equal(pick, pick_p)
    return lab, pick


PRESETS = ["vlp16", "os1_16", "hdl32e", "os1_64", "hdl64e", "vls128"]


@pytest.mark.parametrize("preset", PRESETS)
def test_pick_kernel_matches_plain(dev, img, preset):
    """The fused K2 against its plain version on one synthetic scan of each
    sensor preset (HDL-64E as chip_smoke.py's path: rows from elevation
    math, each point moved into the middle of its row)."""
    _pick_kernel_at_preset(dev, img, config_for(preset, deskew=False))


@pytest.mark.parametrize("preset", PRESETS)
def test_pick_kernel_sequential_matches_plain(dev, img, preset):
    """K2's sequential mode (sector_parallel=False, the reference's order)
    against its plain version on the same scans."""
    cfg = config_for(preset, deskew=False, sector_parallel=False)
    lab = _pick_kernel_at_preset(dev, img, cfg)
    lab_par, _ = features.label_features_plain(
        segment_scan(_preset_image(dev, img, cfg), cfg)[0],
        cfg.replace(sector_parallel=True))
    assert not torch.equal(lab, lab_par)     # the order shows on these scans


def _preset_image(dev, img, cfg):
    if cfg.sensor.name == "vlp16":
        return img
    else:
        xyz, valid, ring = syn.raycast(syn.default_world(9), np.eye(3),
                                       np.array([1.0, 2.0, 1.7]), cfg.sensor,
                                       noise=0.02, rng=np.random.default_rng(4))
        if cfg.sensor.use_ring:
            ring = torch.as_tensor(ring, device=dev)
        else:
            xyz, ring = mid_row(xyz, cfg.sensor), None
        return project_scan(torch.as_tensor(xyz, device=dev),
                            torch.as_tensor(valid, device=dev), cfg, ring)


def _pick_kernel_at_preset(dev, img, cfg):
    lab, _ = _k2_matches_plain(segment_scan(_preset_image(dev, img, cfg), cfg)[0],
                               cfg)
    assert lab.shape == (cfg.sensor.n_scan, cfg.sensor.horizon_scan)
    assert int((lab == 2).sum()) > 0 and int((lab == -1).sum()) > 0
    return lab


@pytest.mark.parametrize("variant", ["default", *THRESHOLD_CFGS])
@pytest.mark.parametrize("rows", ["built_1800", "built_2048", "random_1800",
                                  "random_1024"])
def test_label_features_kernel_on_built_rows(dev, rows, variant):
    """The fused K2 against its plain version on the built rows of
    tests/test_torch_feature_rows.py (ties within and across lanes, bands
    across sector boundaries, reach cut by column gaps, count < 12, = 12,
    = W, n_ok 0 / 1 / even / odd) and on seeded random rows, under the
    default config and with each threshold at, and one ulp either side
    of, a value the rows hold."""
    kind, W = rows.split("_")
    arrays = (built_rows(int(W)) if kind == "built"
              else random_rows(int(W), R=64, W=int(W)))
    cfg = config_for("vlp16", **THRESHOLD_CFGS.get(variant, {}))
    _k2_matches_plain(packed_from(*arrays, device=dev), cfg)


@pytest.mark.parametrize("variant", ["default", *THRESHOLD_CFGS])
@pytest.mark.parametrize("rows", ["built_1800", "built_2048", "random_1800",
                                  "random_1024"])
def test_label_features_sequential_on_built_rows(dev, rows, variant):
    """K2's sequential mode on the same rows and configs: its bands cross
    into the next sector, and on the short rows (count < 40) past it."""
    kind, W = rows.split("_")
    arrays = (built_rows(int(W)) if kind == "built"
              else random_rows(int(W), R=64, W=int(W)))
    cfg = config_for("vlp16", sector_parallel=False,
                     **THRESHOLD_CFGS.get(variant, {}))
    _k2_matches_plain(packed_from(*arrays, device=dev), cfg)


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


@pytest.mark.parametrize("thresh", [10.0, 100.0])
def test_eig6_kernel_matches_plain(dev, thresh):
    names, Hs = zip(*eig6_spectra(thresh, seed=2))
    H = torch.as_tensor(np.stack(Hs), device=dev)
    scale = H.abs().amax(dim=(1, 2)).clamp(min=1.0)
    n = eig6.eig6.launches
    torch.cuda.set_sync_debug_mode("error")   # a host sync would raise
    try:
        P, lam, sweeps = eig6.eig6(H, thresh)
        singles = [eig6.degeneracy_projection(H[i], thresh) for i in range(len(Hs))]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert eig6.eig6.launches == n + 1 + len(Hs)
    P_ref, lam_ref = eig6.degeneracy_projection_plain(H, thresh)
    for i, name in enumerate(names):
        assert (P[i] - P_ref[i]).abs().max().item() <= 1e-5, name
        assert torch.equal(singles[i][0], P[i]), name
        assert ((lam[i] - lam_ref[i]).abs().max() / scale[i]).item() <= 1e-5, name
        assert torch.equal(lam[i] >= thresh, lam_ref[i] >= thresh), name
        assert 0 <= int(sweeps[i]) <= 8, name
    assert int(sweeps[names.index("zero")]) == 0


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
    # K2: a wrong dtype, and a ring wider than the pick warps' registers
    # hold (a sector of more than 32 x 16 cells), raise before any launch
    rows = built_rows()
    n = features.label_features.launches
    packed = packed_from(*rows, device=dev)
    with pytest.raises(ValueError):
        features.label_features(packed._replace(rng=packed.rng.double()), CFG)
    with pytest.raises(ValueError):
        features.label_features(packed._replace(count=packed.count.long()), CFG)
    wide = packed_from(*(np.tile(a, 2) if a.ndim == 2 else a for a in rows),
                       device=dev)
    assert wide.rng.shape == (16, 3600)
    with pytest.raises(ValueError, match="do not fit"):
        features.label_features(wide, CFG)
    assert features.label_features.launches == n
    # E1: float32 (B, n, n) with n = 3 or 6 only, before any launch
    n = eig6.eig6.launches
    with pytest.raises(ValueError):
        eig6.eig6(torch.zeros((2, 6, 6), dtype=torch.float64, device=dev), 10.0)
    with pytest.raises(ValueError):
        eig6.eig6(torch.zeros((2, 5, 5), device=dev), 10.0)
    assert eig6.eig6.launches == n


# ------------------------------------------- batched launches (vmap rules)

def _preset_images(dev, preset, B):
    """B synthetic scans of a preset from B poses of world seed 5 (HDL-64E
    as chip_smoke.py's path: rows from elevation math)."""
    cfg = config_for(preset, deskew=False)
    ims = []
    for b in range(B):
        xyz, valid, ring = syn.raycast(syn.default_world(5), np.eye(3),
                                       np.array([2.0 - 0.7 * b, 1.0, 1.7]),
                                       cfg.sensor, noise=0.01,
                                       rng=np.random.default_rng(b))
        if cfg.sensor.use_ring:
            ring = torch.as_tensor(ring, device=dev)
        else:
            xyz, ring = mid_row(xyz, cfg.sensor), None
        ims.append(project_scan(torch.as_tensor(xyz, device=dev),
                                torch.as_tensor(valid, device=dev), cfg, ring))
    return cfg, ims


@pytest.mark.parametrize("preset,B", [("vlp16", 8), ("hdl64e", 8), ("vls128", 3)])
def test_label_prop_batched_launches(dev, preset, B):
    """K1 under torch.func.vmap: the fewest cooperative launches whose
    blocks are co-resident (one a VLP-16 batch of 8; more than one for
    HDL-64E at 8 and VLS-128 at 3, beyond one launch's blocks), each scan
    equal to the plain version."""
    cfg, ims = _preset_images(dev, preset, B)
    per = [segmentation.label_inputs(*segmentation.build_edges(
        im, mark_ground(im, cfg), cfg)) for im in ims]
    R, H = cfg.sensor.n_scan, cfg.sensor.horizon_scan
    want = segmentation.label_prop_launches(B, R, H, dev)
    assert (want > 1) == (preset != "vlp16")
    n = segmentation.propagate_labels.launches
    got = torch.func.vmap(segmentation.propagate_labels)(
        *(torch.stack(a) for a in zip(*per)))
    assert segmentation.propagate_labels.launches == n + want
    for b in range(B):
        assert torch.equal(got[b], segmentation.propagate_labels_plain(
            *per[b], cfg.label_prop_max_sweeps)), b


@pytest.mark.parametrize("preset,B,sector_parallel", [
    ("vlp16", 8, True), ("hdl64e", 3, True), ("vlp16", 8, False),
    ("hdl64e", 3, False)])
def test_label_features_batched_launch(dev, preset, B, sector_parallel):
    """K2 under torch.func.vmap, in either pick order: one launch of B x R
    rings, each scan bit for bit the plain version's."""
    cfg, ims = _preset_images(dev, preset, B)
    cfg = cfg.replace(sector_parallel=sector_parallel)
    packed = [segment_scan(im, cfg)[0] for im in ims]
    stacked = type(packed[0])(*(torch.stack(v) for v in zip(*packed)))
    n = features.label_features.launches
    lab, pick = torch.func.vmap(lambda p: features.label_features(p, cfg))(stacked)
    assert features.label_features.launches == n + 1
    for b, p in enumerate(packed):
        lab_p, pick_p = features.label_features_plain(p, cfg)
        assert torch.equal(lab[b], lab_p) and torch.equal(pick[b], pick_p), b


@pytest.mark.parametrize("q_n,r_n,k", [(4096, 32768, 5), (1024, 8192, 5),
                                       (2560, 32768, 1), (300, 200, 5)])
def test_knn_batched_launch(dev, q_n, r_n, k):
    """K3 under torch.func.vmap, B = 8 searches (the splits chosen for the
    batch, S = 1 for the short reference set): one launch, each search
    equal to its own launch bit for bit and to the plain version to
    rtol 1e-4 / atol 1e-3 on distances."""
    B = 8
    rng = np.random.default_rng(q_n + k)
    q = torch.as_tensor((rng.standard_normal((B, q_n, 3)) * 20).astype(np.float32),
                        device=dev)
    r = torch.as_tensor((rng.standard_normal((B, r_n, 3)) * 20).astype(np.float32),
                        device=dev)
    valid = torch.as_tensor(rng.random((B, r_n)) > 0.2, device=dev)
    n = knn.knn.launches
    idx, d2 = torch.func.vmap(lambda a, b, c: knn.knn(a, b, c, k))(q, r, valid)
    assert knn.knn.launches == n + 1
    for b in range(B):
        i1, d1 = knn.knn(q[b], r[b], valid[b], k)
        assert torch.equal(idx[b], i1) and torch.equal(d2[b], d1), b
        _, pd2 = knn.knn_plain(q[b], r[b], valid[b], k)
        torch.testing.assert_close(d2[b], pd2, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("thresh", [10.0, 100.0])
def test_eig6_kernel_at_3x3_matches_plain(dev, thresh):
    """E1 at 3x3 (the two-step odometry's systems) on the 3x3 spectra of
    tests/torch_courses.eig6_spectra, batched, one matrix a call and under
    torch.func.vmap (one launch), with no host sync: P within 1e-5,
    eigenvalues within 1e-5 of |H|, keep masks equal."""
    names, Hs = zip(*eig6_spectra(thresh, seed=2, n=3))
    H = torch.as_tensor(np.stack(Hs), device=dev)
    scale = H.abs().amax(dim=(1, 2)).clamp(min=1.0)
    n = eig6.eig6.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        P, lam, sweeps = eig6.eig6(H, thresh)
        singles = [eig6.degeneracy_projection(H[i], thresh) for i in range(len(Hs))]
        P_v, lam_v = torch.func.vmap(lambda h: eig6.degeneracy_projection(h, thresh))(
            H.reshape(len(Hs), 1, 3, 3))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert eig6.eig6.launches == n + 2 + len(Hs)
    assert torch.equal(P_v[:, 0], P) and torch.equal(lam_v[:, 0], lam)
    P_ref, lam_ref = eig6.degeneracy_projection_plain(H, thresh)
    for i, name in enumerate(names):
        assert (P[i] - P_ref[i]).abs().max().item() <= 1e-5, name
        assert torch.equal(singles[i][0], P[i]), name
        assert ((lam[i] - lam_ref[i]).abs().max() / scale[i]).item() <= 1e-5, name
        assert torch.equal(lam[i] >= thresh, lam_ref[i] >= thresh), name
        assert 0 <= int(sweeps[i]) <= 8, name
    assert int(sweeps[names.index("zero")]) == 0


def test_eig6_batched_launch(dev):
    """E1 under torch.func.vmap: one launch for every matrix of the batch,
    no host sync, each P equal to its own launch's."""
    Hs = [H for t in (10.0, 100.0) for _, H in eig6_spectra(t, seed=3)]
    n_per = len(Hs) // 4
    H = torch.as_tensor(np.stack(Hs[:4 * n_per]), device=dev).reshape(4, n_per, 6, 6)
    n = eig6.eig6.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        P, lam = torch.func.vmap(lambda h: eig6.degeneracy_projection(h, 10.0))(H)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert eig6.eig6.launches == n + 1
    for b in range(4):
        P1, lam1 = eig6.degeneracy_projection(H[b], 10.0)
        assert torch.equal(P[b], P1) and torch.equal(lam[b], lam1), b


@pytest.mark.parametrize("spread", [5.0, 20.0])
def test_voxel_centroids_repeat_bit_for_bit(dev, spread):
    """The centroid sums are exact integer sums, so two runs on the card
    give the same bits (float atomics did not), and so does the CPU: 150k
    points at the local map's leaf and cap, many or few to a voxel."""
    g = torch.Generator().manual_seed(int(spread))
    xyz = torch.randn(150_000, 3, generator=g) * spread
    valid = torch.rand(150_000, generator=g) > 0.2
    runs = [voxel_downsample(xyz.to(dev), valid.to(dev), 0.4, 32768) for _ in range(2)]
    host = voxel_downsample(xyz, valid, 0.4, 32768)
    for a in runs:
        assert torch.equal(a[0].cpu(), host[0]) and torch.equal(a[1].cpu(), host[1])
    assert int(host[1].sum()) > 1000


# ---------------------------------------------------------------- K4

# kinds and class gates the odometry runs: the corner search never gated
ASSOC_KINDS = [("corner", False), ("tri", False), ("tri", True), ("knn", False),
               ("knn", True)]
# (Q, N, rings) of the pipelines' searches: VLP-16 corner and surf, and
# HDL-64E's at 16 rings' capacities and at its own (4x, config_for)
ASSOC_SHAPES = [(256, 2048, 16), (512, 4096, 16), (1024, 4096, 64), (2048, 8192, 64),
                (1024, 8192, 64), (2048, 16384, 64)]


def _assoc_matches_plain(dev, arrays, kind, gate):
    search = [torch.as_tensor(a, device=dev) for a in arrays]
    if not gate:
        search[4:] = None, None
    n = assoc.assoc.launches
    idx, d2 = assoc.assoc(*search[:4], kind, *search[4:])
    assert assoc.assoc.launches == n + 1
    faults, _, dup = assoc_faults(search, kind, idx, d2)
    assert not faults, faults
    return dup


@pytest.mark.parametrize("kind,gate", ASSOC_KINDS,
                         ids=[f"{k}-{'gated' if g else 'ungated'}" for k, g in ASSOC_KINDS])
@pytest.mark.parametrize("case", ASSOC_CASES)
def test_assoc_kernel_matches_plain(dev, case, kind, gate):
    dup = _assoc_matches_plain(dev, assoc_case(case, seed=3), kind, gate)
    assert bool(dup) == (case == "duplicates")


@pytest.mark.parametrize("kind,gate", ASSOC_KINDS,
                         ids=[f"{k}-{'gated' if g else 'ungated'}" for k, g in ASSOC_KINDS])
@pytest.mark.parametrize("q_n,r_n,rings", ASSOC_SHAPES,
                         ids=[f"{q}x{n}" for q, n, _ in ASSOC_SHAPES])
def test_assoc_kernel_at_pipeline_shapes(dev, q_n, r_n, rings, kind, gate):
    _assoc_matches_plain(dev, assoc_cloud(rings, r_n // rings, q_n, seed=q_n + r_n),
                         kind, gate)


@pytest.mark.parametrize("split", [2, 4, 8, 16, 32])
@pytest.mark.parametrize("case", ASSOC_CASES + ("512x4096",))
def test_assoc_lanes_a_query_agree(dev, case, split):
    """K4 with `split` lanes a query (the lanes' picks merged by shuffles,
    as a single sequence's search runs) equals one lane a query bit for bit,
    in every kind the odometry runs."""
    arrays = (assoc_cloud(16, 256, 512, seed=5) if case == "512x4096"
              else assoc_case(case, seed=3))
    search = [torch.as_tensor(a, device=dev) for a in arrays]
    for kind, gate in ASSOC_KINDS:
        s = search if gate else search[:4] + [None, None]
        i1, v1 = assoc._launch_assoc(*s, kind, split=1)
        i2, v2 = assoc._launch_assoc(*s, kind, split=split)
        assert torch.equal(i1, i2), (kind, gate)
        assert torch.equal(v1.nan_to_num(-1.0), v2.nan_to_num(-1.0)), (kind, gate)


@pytest.mark.parametrize("kind,gate", [("corner", False), ("knn", True)])
def test_assoc_batched_launch(dev, kind, gate):
    """K4 under torch.func.vmap, B = 8 searches at the HDL-64E surf shape
    (2048 x 16384): one launch, each search equal to its own launch bit for
    bit, and no (B, Q, N) or (Q, N) matrix: the peak grows by far less than
    one 8 x 2048 x 8192 float matrix (512 MB)."""
    B, (q_n, r_n, rings) = 8, ASSOC_SHAPES[-1]
    cases = [assoc_cloud(rings, r_n // rings, q_n, seed=b) for b in range(B)]
    q, r, v, ring, qg, rg = (torch.as_tensor(np.stack(a), device=dev)
                             for a in zip(*cases))
    if not gate:
        qg = rg = None
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    n = assoc.assoc.launches
    if gate:
        idx, d2 = torch.func.vmap(lambda *a: assoc.assoc(*a[:4], kind, *a[4:]))(
            q, r, v, ring, qg, rg)
    else:
        idx, d2 = torch.func.vmap(lambda *a: assoc.assoc(*a, kind))(q, r, v, ring)
    torch.cuda.synchronize()
    grew = torch.cuda.max_memory_allocated(dev) - base
    assert assoc.assoc.launches == n + 1
    assert grew < 16 * 2**20, grew
    for b in range(B):
        i1, v1 = assoc.assoc(q[b], r[b], v[b], ring[b], kind,
                             *((qg[b], rg[b]) if gate else ()))
        assert torch.equal(idx[b], i1) and torch.equal(d2[b], v1), b


def test_assoc_wrapper_rejects_bad_inputs(dev):
    q, r, v, ring, qg, rg = (torch.as_tensor(a, device=dev)
                             for a in assoc_case("rings16"))
    with pytest.raises(ValueError, match="ref_ring"):
        assoc.assoc(q, r, v, ring.long(), "tri")
    with pytest.raises(ValueError, match="query"):
        assoc.assoc(q.double(), r, v, ring, "tri")
    with pytest.raises(ValueError, match="Q, N"):
        assoc.assoc(q[:0], r, v, ring, "knn")
    with pytest.raises(ValueError, match="ground"):
        assoc.assoc(q, r, v, ring, "knn", qg.int(), rg)
