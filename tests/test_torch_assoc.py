"""The odometry's correspondence search (ops/assoc.py, the custom op
lego::odom_assoc) on the CPU.

  * Its plain path against the JAX package's chain of sq_dist_matrix and
    masked_argmin calls, as lego_loam_tpu/models/odometry.py takes the
    picks, for each kind with the class gate off and on: indices equal,
    values to test_torch_knn.py::test_masked_argmin_matches_jnp's
    tolerance, the slots a kind does not search at (0, 1e30).
  * The odometry's three association functions (models/odometry.py's
    _assoc_corner, _assoc_surf and _assoc_surf_knn) against the dense
    searches they ran before the op, kept below, bit for bit: on
    tests/torch_courses.assoc_case's clouds and on the features of two
    synthetic VLP-16 scans.
  * The op under torch.func.vmap equal to one call a sequence, and its
    input errors.

K4, the kernel behind the op on a CUDA tensor, is held to the same plain
path on the card in tests/test_torch_kernels_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lego_loam_tpu.ops.knn import masked_argmin as jmasked_argmin
from lego_loam_tpu.ops.knn import sq_dist_matrix as jsq_dist_matrix
from lego_loam_tpu_torch import config_for
from lego_loam_tpu_torch.io import synthetic as syn
from lego_loam_tpu_torch.models import odometry as todo
from lego_loam_tpu_torch.models.mapping import _fit_planes
from lego_loam_tpu_torch.ops import assoc as tas
from lego_loam_tpu_torch.ops.compaction import segment_scan
from lego_loam_tpu_torch.ops.features import extract_features
from lego_loam_tpu_torch.ops.knn import masked_argmin, sq_dist_matrix
from lego_loam_tpu_torch.ops.projection import project_scan
from lego_loam_tpu_torch.types import FeatureCloud
from lego_loam_tpu_torch.utils.math3d import Pose, so3_exp

from tests.torch_courses import ASSOC_CASES, SMALL, assoc_case, slice_course

# the slots each kind searches
READ = {"corner": (0, 3), "tri": (0, 1, 3), "knn": (0, 1, 2, 3, 4)}


def _jax_picks(q, r, v, ring, qg, rg, kind):
    """The picks of the JAX package's associations (its _assoc_surf_knn's
    chain, whose gate masks the matrix first; the other two read a subset
    of its slots): {slot: (idx, val)}."""
    d2 = jsq_dist_matrix(jnp.asarray(q), jnp.asarray(r), jnp.asarray(v))
    if qg is not None:
        d2 = jnp.where(jnp.asarray(rg)[None, :] == jnp.asarray(qg)[:, None], d2,
                       jnp.float32(1e30))
    ring = jnp.asarray(ring)
    cols = jnp.arange(d2.shape[1])[None, :]
    i1, v1 = jmasked_argmin(d2)
    dr = ring[None, :] - ring[i1][:, None]
    same_ring = (dr == 0) & (cols != i1[:, None])
    adj_ring = (dr != 0) & (jnp.abs(dr) <= 2)
    i2, v2 = jmasked_argmin(d2, same_ring)
    i5, v5 = jmasked_argmin(d2, same_ring & (cols != i2[:, None]))
    i3, v3 = jmasked_argmin(d2, adj_ring)
    i4, v4 = jmasked_argmin(d2, adj_ring & (cols != i3[:, None]))
    return {0: (i1, v1), 1: (i2, v2), 2: (i5, v5), 3: (i3, v3), 4: (i4, v4)}


@pytest.mark.parametrize("gate", [False, True], ids=["ungated", "gated"])
@pytest.mark.parametrize("kind", list(tas.KINDS))
@pytest.mark.parametrize("case", ASSOC_CASES)
def test_plain_path_matches_jax_chain(case, kind, gate):
    q, r, v, ring, qg, rg = assoc_case(case)
    if not gate:
        qg = rg = None
    idx, d2 = tas.assoc(*(None if a is None else torch.from_numpy(a)
                          for a in (q, r, v, ring)), kind,
                        *(None if a is None else torch.from_numpy(a) for a in (qg, rg)))
    assert idx.dtype == torch.int32 and idx.shape == d2.shape == (q.shape[0], tas.SLOTS)
    want = _jax_picks(q, r, v, ring, qg, rg, kind)
    for s in range(tas.SLOTS):
        if s in READ[kind]:
            ji, jv = want[s]
            np.testing.assert_array_equal(idx[:, s].numpy(), np.asarray(ji))
            np.testing.assert_allclose(d2[:, s].numpy(), np.asarray(jv),
                                       rtol=1e-5, atol=1e-3)
        else:
            assert not idx[:, s].any() and bool((d2[:, s] == 1e30).all())


# ------------------------------------------- the dense searches replaced

def _old_assoc_corner(rel, sharp, ref, cfg):
    q = todo.warp_to_start(rel, sharp.xyz, sharp.s)
    d2 = sq_dist_matrix(q, ref.xyz, ref.valid)
    i1, v1 = masked_argmin(d2)
    dr = ref.ring[None, :] - ref.ring[i1][:, None]
    i2, v2 = masked_argmin(d2, (dr != 0) & (dr.abs() <= 2))
    thr = cfg.nearest_feature_search_sq_dist
    return i1, i2, sharp.valid & (v1 < thr) & (v2 < thr)


def _old_assoc_surf(rel, flat, ref, cfg):
    q = todo.warp_to_start(rel, flat.xyz, flat.s)
    d2 = sq_dist_matrix(q, ref.xyz, ref.valid)
    same = None
    if cfg.odom_class_gate and flat.ground is not None and ref.ground is not None:
        same = ref.ground[None, :] == flat.ground[:, None]
    i1, v1 = masked_argmin(d2, same)
    dr = ref.ring[None, :] - ref.ring[i1][:, None]
    cols = torch.arange(d2.shape[1], device=d2.device)[None, :]
    m2 = (dr == 0) & (cols != i1[:, None])
    m3 = (dr != 0) & (dr.abs() <= 2)
    if same is not None:
        m2, m3 = m2 & same, m3 & same
    i2, v2 = masked_argmin(d2, m2)
    i3, v3 = masked_argmin(d2, m3)
    thr = cfg.nearest_feature_search_sq_dist
    return i1, i2, i3, flat.valid & (v1 < thr) & (v2 < thr) & (v3 < thr)


def _old_assoc_surf_knn(rel, flat, ref, cfg):
    q = todo.warp_to_start(rel, flat.xyz, flat.s)
    d2 = sq_dist_matrix(q, ref.xyz, ref.valid)
    if cfg.odom_class_gate and flat.ground is not None and ref.ground is not None:
        d2 = torch.where(ref.ground[None, :] == flat.ground[:, None], d2, 1e30)
    cols = torch.arange(d2.shape[1], device=d2.device)[None, :]
    i1, v1 = masked_argmin(d2)
    dr = ref.ring[None, :] - ref.ring[i1][:, None]
    same_ring = dr == 0
    adj_ring = (dr != 0) & (dr.abs() <= 2)
    not1 = cols != i1[:, None]
    i2, v2 = masked_argmin(d2, same_ring & not1)
    i5, v5 = masked_argmin(d2, same_ring & not1 & (cols != i2[:, None]))
    i3, v3 = masked_argmin(d2, adj_ring)
    i4, v4 = masked_argmin(d2, adj_ring & (cols != i3[:, None]))
    thr = cfg.nearest_feature_search_sq_dist
    ok = flat.valid & (v1 < thr) & (v2 < thr) & (v3 < thr)
    i4 = torch.where(v4 < thr, i4, i3)
    i5 = torch.where(v5 < thr, i5, i2)
    nn = ref.xyz[torch.stack([i1, i2, i3, i4, i5], dim=1)]
    return _fit_planes(nn, ok, cfg)


ASSOC_FNS = {"corner": (todo._assoc_corner, _old_assoc_corner),
             "tri": (todo._assoc_surf, _old_assoc_surf),
             "knn": (todo._assoc_surf_knn, _old_assoc_surf_knn)}


def _same_bits(got, want):
    for g, w in zip(got, want):
        if w.dtype == torch.int64:          # the dense search's indices
            g = g.long()
        torch.testing.assert_close(g, w, rtol=0, atol=0, equal_nan=True)


def _rel():
    return Pose(so3_exp(torch.tensor([0.01, -0.02, 0.05])),
                torch.tensor([0.3, -0.1, 0.02]))


def _clouds(case):
    """(query cloud, reference cloud) of an assoc_case search: the queries
    with sweep fractions and a third of them invalid."""
    q, r, v, ring, qg, rg = (torch.from_numpy(a) for a in assoc_case(case))
    g = torch.Generator().manual_seed(len(case))
    qv = torch.rand(q.shape[0], generator=g) > 0.3
    query = FeatureCloud(q, torch.zeros_like(qv, dtype=torch.int32),
                         torch.rand(q.shape[0], generator=g), qv, qg)
    ref = FeatureCloud(r, ring, torch.rand(r.shape[0], generator=g), v, rg)
    return query, ref


@pytest.mark.parametrize("gate", [False, True], ids=["ungated", "gated"])
@pytest.mark.parametrize("kind", list(ASSOC_FNS))
@pytest.mark.parametrize("case", ASSOC_CASES)
def test_associations_equal_the_dense_search(case, kind, gate):
    query, ref = _clouds(case)
    cfg = config_for("vlp16", odom_class_gate=gate)
    new, old = ASSOC_FNS[kind]
    _same_bits(new(_rel(), query, ref, cfg), old(_rel(), query, ref, cfg))


@pytest.fixture(scope="module")
def scan_features():
    """The port's features of the first two scans of the 6-scan slice
    course at SMALL's capacities."""
    cfg = config_for("vlp16", **SMALL)
    _, scans = slice_course(cfg.sensor, 2)
    out = []
    for xyz, valid, ring in scans:
        img = project_scan(torch.from_numpy(xyz), torch.from_numpy(valid), cfg,
                           torch.from_numpy(ring))
        packed, o_rel, _, _ = segment_scan(img, cfg)
        out.append(extract_features(packed, o_rel, cfg))
    return out


@pytest.mark.parametrize("gate", [False, True], ids=["ungated", "gated"])
@pytest.mark.parametrize("kind", list(ASSOC_FNS))
def test_associations_on_scan_features(scan_features, kind, gate):
    prev, cur = scan_features
    cfg = config_for("vlp16", **dict(SMALL, odom_class_gate=gate))
    query, ref = ((cur.sharp, prev.less_sharp) if kind == "corner"
                  else (cur.flat, prev.less_flat))
    assert int(query.valid.sum()) > 20 and int(ref.valid.sum()) > 100
    new, old = ASSOC_FNS[kind]
    got = new(_rel(), query, ref, cfg)
    _same_bits(got, old(_rel(), query, ref, cfg))
    assert bool(got[-1].any())            # some associations pass their gates


@pytest.mark.parametrize("kind", list(tas.KINDS))
def test_vmapped_op_equals_one_call_a_sequence(kind):
    """A batch of 3 searches (queries and labels batched, the reference
    cloud shared) under torch.func.vmap, one op call, equal to 3 calls."""
    cases = [assoc_case("rings16", seed) for seed in range(3)]
    q = torch.stack([torch.from_numpy(c[0]) for c in cases])
    qg = torch.stack([torch.from_numpy(c[4]) for c in cases])
    _, r, v, ring, _, rg = (torch.from_numpy(a) for a in cases[0])
    idx, d2 = torch.func.vmap(lambda a, b: tas.assoc(a, r, v, ring, kind, b, rg))(q, qg)
    for b in range(3):
        i1, v1 = tas.assoc(q[b], r, v, ring, kind, qg[b], rg)
        assert torch.equal(idx[b], i1) and torch.equal(d2[b], v1)


def test_assoc_rejects_bad_inputs():
    q, r, v, ring, qg, rg = (torch.from_numpy(a) for a in assoc_case("rings16"))
    with pytest.raises(ValueError, match="kind"):
        tas.assoc(q, r, v, ring, "plane")
    with pytest.raises(ValueError, match="both ground labels"):
        tas.assoc(q, r, v, ring, "tri", qg, None)


# (Q, B) -> lanes a query: the fleets' searches keep one lane (~1,000
# blocks already), a single sequence's spread over the card
@pytest.mark.parametrize("q_n,b,split", [
    (512, 256, 1), (256, 256, 1), (2048, 64, 1), (1024, 64, 1),
    (512, 8, 16), (256, 8, 32), (512, 1, 32), (2048, 1, 32), (4096, 1, 16),
    (1, 1, 32)])
def test_query_split_spreads_a_search_over_the_card(q_n, b, split):
    """K4's lanes a query: the fewest (a power of 2 up to 32) that give
    the grid MIN_BLOCKS blocks of BLOCK_THREADS threads."""
    s = tas.query_split(q_n, b)
    assert s == split
    blocks = lambda s: -(-q_n * s // tas.BLOCK_THREADS) * b
    assert blocks(s) >= tas.MIN_BLOCKS or s == 32
    assert s == 1 or blocks(s // 2) < tas.MIN_BLOCKS
