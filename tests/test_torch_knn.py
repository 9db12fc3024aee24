"""k-NN parity: the port's plain k-NN (the CPU side of kernel K3) against
lego_loam_tpu's exact XLA path and its Pallas kernel in interpret mode, at
the shapes of tests/test_knn_pallas.py.

Tolerance (the scheme of tests/test_knn_pallas.py): distances to rtol 1e-4
/ atol 1e-3 -- all paths compute |q|^2 + |r|^2 - 2 q.r in float32, with
the 3-term dot and the sums in different orders; neighbour sets equal up to
the order of ties, checked by every returned index being a valid point at
its returned distance.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lego_loam_tpu.ops.knn import knn as jknn
from lego_loam_tpu.ops.knn_pallas import knn_pallas
from lego_loam_tpu_torch.ops import knn as tknn


def _cloud(rng, n, scale=20.0):
    return (rng.standard_normal((n, 3)) * scale).astype(np.float32)


@pytest.mark.parametrize("q_n,r_n,k", [(100, 300, 5), (256, 2048, 5),
                                       (70, 130, 1), (512, 513, 8)])
def test_plain_knn_matches_xla_and_pallas(q_n, r_n, k):
    rng = np.random.default_rng(q_n + r_n + k)
    q, r = _cloud(rng, q_n), _cloud(rng, r_n)
    valid = rng.random(r_n) > 0.2
    xi, xd = map(np.asarray, jknn(jnp.asarray(q), jnp.asarray(r),
                                  jnp.asarray(valid), k, exact=True))
    pi, pd = map(np.asarray, knn_pallas(jnp.asarray(q), jnp.asarray(r),
                                        jnp.asarray(valid), k, interpret=True))
    launches = tknn.knn.launches
    ti, td = tknn.knn(torch.from_numpy(q), torch.from_numpy(r),
                      torch.from_numpy(valid), k, query_tile=64)
    assert tknn.knn.launches == launches            # CPU: plain path
    ti, td = ti.numpy(), td.numpy()
    assert ti.dtype == np.int32 and ti.shape == (q_n, k)

    kk = min(k, int(valid.sum()))
    for ref_d in (xd, pd):
        np.testing.assert_allclose(td[:, :kk], ref_d[:, :kk], rtol=1e-4, atol=1e-3)
    d_true = np.sum((q[:, None, :] - r[ti[:, :kk]]) ** 2, axis=-1)
    np.testing.assert_allclose(d_true, td[:, :kk], rtol=1e-4, atol=1e-3)
    assert valid[ti[:, :kk]].all()
    assert (td[:, kk:] > 1e29).all()
    # away from ties the plain path picks the very same points as XLA
    assert (ti == xi).mean() > 0.99


def test_duplicate_points_take_lowest_indices():
    q = torch.zeros((4, 3))
    r = torch.ones((32, 3))
    idx, d2 = tknn.knn(q, r, torch.ones(32, dtype=torch.bool), 5)
    np.testing.assert_allclose(d2.numpy(), 3.0, rtol=1e-6)
    assert (idx.numpy() == np.arange(5)).all()


@pytest.mark.parametrize("k", [1, 5, 8])
def test_plain_knn_is_a_stable_sorts_first_columns(k):
    """knn_plain's k argmin passes return the first k columns of a stable
    sort of the distance matrix: ties (duplicate points) to the lowest
    index, then the invalid references (1e30) in index order."""
    rng = np.random.default_rng(k)
    r = np.repeat(_cloud(rng, 40, scale=2.0), 3, axis=0)        # triples
    q = _cloud(rng, 50, scale=2.0)
    valid = np.ones(120, bool)
    valid[rng.permutation(120)[:117]] = False                  # 3 valid left
    q, r, valid = map(torch.from_numpy, (q, r, valid))
    for vmask in (torch.ones(120, dtype=torch.bool), valid):
        idx, d2 = tknn.knn_plain(q, r, vmask, k, query_tile=16)
        s = torch.sort(tknn.sq_dist_matrix(q, r, vmask), dim=1, stable=True)
        np.testing.assert_array_equal(idx.numpy(), s.indices[:, :k].numpy())
        np.testing.assert_array_equal(d2.numpy(), s.values[:, :k].numpy())


def test_plain_knn_refuses_k_outside_one_to_n():
    q, r = torch.zeros((4, 3)), torch.ones((6, 3))
    valid = torch.ones(6, dtype=torch.bool)
    for k in (0, 7):
        with pytest.raises(ValueError, match="1 <= k <= N"):
            tknn.knn(q, r, valid, k)


@pytest.mark.parametrize("q_n,r_n,s_n", [(4096, 32768, 16), (1024, 8192, 32),
                                         (100, 300, 1), (200, 600, 2),
                                         (37, 1000, 3), (5000, 32769, 13),
                                         (100_000, 4096, 1)])
def test_knn_splits_fill_one_wave_without_empty_splits(q_n, r_n, s_n):
    S = tknn.knn_splits(q_n, r_n)
    assert S == s_n
    split = -(-r_n // S)                  # the kernel's split length
    assert (S - 1) * split < r_n <= S * split
    assert S == 1 or split >= tknn.MIN_SPLIT
    tiles = -(-q_n // tknn.QUERY_TILE)
    assert tiles * S <= max(tknn.TARGET_BLOCKS, tiles)
    # one split more would overfill the wave or shorten splits below MIN_SPLIT
    assert (tiles * (S + 1) > tknn.TARGET_BLOCKS
            or -(-r_n // (S + 1)) < tknn.MIN_SPLIT or r_n // tknn.MIN_SPLIT <= S)


def test_masked_argmin_matches_jnp():
    from lego_loam_tpu.ops.knn import masked_argmin as jma
    from lego_loam_tpu.ops.knn import sq_dist_matrix as jsq

    rng = np.random.default_rng(5)
    q, r = _cloud(rng, 64), _cloud(rng, 200)
    valid = rng.random(200) > 0.3
    mask = rng.random((64, 200)) > 0.5
    jd = jsq(jnp.asarray(q), jnp.asarray(r), jnp.asarray(valid))
    td = tknn.sq_dist_matrix(torch.from_numpy(q), torch.from_numpy(r),
                             torch.from_numpy(valid))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5, atol=1e-3)
    ji, jv = jma(jd, jnp.asarray(mask))
    ti, tv = tknn.masked_argmin(td, torch.from_numpy(mask))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("q_n,r_n,frac,k,tile", [
    (4352, 16384, 0.35, 1, 1024), (2048, 16384, 0.5, 5, 512),
    (1024, 8192, 0.4, 5, 256), (300, 2000, 1.0, 8, 0), (50, 10, 0.2, 5, 0),
    (40, 10, 0.0, 3, 0)])
def test_valid_only_path_equals_knn_plain(q_n, r_n, frac, k, tile):
    """The CPU path (knn_plain_valid: the valid references and distinct
    queries alone) returns knn_plain's indices and distances bit for bit,
    at the loop check's ICP shape (4352 x 16384, k = 1), the mapping
    shapes, a full set, a set with fewer valid references than k and one
    with none (sentinels: the lowest invalid indices at 1e30); a third of
    the queries are one repeated padding point.  The two small sets take
    whole-metre points, exact in float32: with a handful of references
    MKL's small-matrix path may round the 3-term dot's last bit otherwise
    than at the full width."""
    rng = np.random.default_rng(q_n + k)
    q, r = _cloud(rng, q_n, 15.0), _cloud(rng, r_n, 15.0)
    if r_n <= 16:
        q, r = np.round(q), np.round(r)
    q[::3] = 0.0
    valid = rng.random(r_n) < frac
    q, r, valid = map(torch.from_numpy, (q, r, valid))
    want = tknn.knn_plain(q, r, valid, k, tile)
    got = tknn.knn_plain_valid(q, r, valid, k, tile)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
