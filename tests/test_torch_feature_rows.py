"""Packed rows built to stress the feature-label step (K2's function), and
the property K2's load phase relies on.

K2 (csrc/pick_features.cu) reads only the prefix [0, count) of each ring
and writes labels 0 / picked False beyond it.  Here on the CPU the plain
version (what the wrapper runs on a CPU tensor) is held to that on seeded
random rows whose padding holds garbage.  The built rows cover what a
one-warp-a-sector design can get wrong:

  * equal curvatures at different indices, within a lane's run of cells and
    across lanes (an alternating 10 / 10.125 m stretch: every inner cell has
    curvature exactly 0.5625; a ground row of period-11 spikes: every
    cell between them at exactly 0.015625);
  * bands that cross a sector boundary (spikes on both sides of one);
  * reach cut by a column gap > 10 (and not by a gap of exactly 10), and a
    pick at the last cell of the last sector (count - 7), whose reach ends
    one cell short of the ring's end;
  * count < 12, count = 12 (occlusion but no sector), count = 30 (sectors
    of 3-4 cells: a band crosses several), count = 0, count = W;
  * n_ok (base cells) of 0, 1, even and odd;
  * period-6 spikes of h = 0.1875 m: every cell between them sees two, so
    the median is 4 h^2, the threshold at edge_prominence = 1; one cell
    that sees four sits at 16 h^2, the threshold at edge_prominence = 4;
  * depth steps of exactly 0.5 m, across column gaps of 9 and 10.
All values are dyadic, so the curvatures are exact.  The thresholds one ulp
either side of a value the rows hold are config variants (THRESHOLD_CFGS)
that tests/test_torch_kernels_cuda.py runs on the card;
tests/test_torch_frontend.py holds the plain version against the JAX
package on these rows.
"""

import numpy as np
import pytest
import torch

from lego_loam_tpu_torch import config_for
from lego_loam_tpu_torch.ops import features
from lego_loam_tpu_torch.types import SegmentedScan

F32 = np.float32


def _next(x, toward):
    return float(np.nextafter(F32(x), F32(toward)))


# values that the built rows hold exactly: a corner curvature (0.5625), a surf
# curvature (h^2 of a 0.125 m spike's neighbours, 0.015625) and a depth step
# (0.5); each threshold at the value and one ulp below and above it
THRESHOLD_CFGS = {
    **{f"edge_{k}": dict(edge_threshold=v) for k, v in
       (("below", _next(0.5625, 0)), ("at", 0.5625),
        ("above", _next(0.5625, 1)))},
    **{f"surf_{k}": dict(surf_threshold=v) for k, v in
       (("below", _next(0.015625, 0)), ("at", 0.015625),
        ("above", _next(0.015625, 1)))},
    **{f"gap_{k}": dict(occlusion_depth_gap=v) for k, v in
       (("below", _next(0.5, 0)), ("at", 0.5), ("above", _next(0.5, 1)))},
    "prominence_1": dict(edge_prominence=1.0),
    "prominence_4": dict(edge_prominence=4.0),
    "prominence_0": dict(edge_prominence=0.0),
}


def _row(W, count, tail_rng):
    """A flat 10 m non-ground row of `count` kept cells in consecutive
    columns; the padding beyond `count` holds garbage."""
    rng = np.full(W, 10.0, F32)
    col = np.arange(W, dtype=np.int32)
    valid = np.arange(W) < count
    ground = np.zeros(W, bool)
    tail = slice(count, W)
    n = W - count
    rng[tail] = tail_rng.uniform(0.0, 50.0, n).astype(F32)
    col[tail] = tail_rng.integers(-5000, 5000, n)
    valid[tail] = tail_rng.random(n) < 0.5
    ground[tail] = tail_rng.random(n) < 0.5
    return rng, col, valid, ground


def built_rows(W: int = 1800, R: int = 16, seed: int = 0):
    """(rng, valid, col, ground, count) numpy arrays, (R, W) and (R,): one
    row per case of the module docstring, then seeded rows like a real
    scan's.  W >= 1200."""
    g = np.random.default_rng(seed)
    rows = []

    def add(count, edit=None):
        rng, col, valid, ground = _row(W, count, g)
        if edit is not None:
            edit(rng, col, valid, ground)
        rows.append((rng, valid, col, ground, count))

    def ties(rng, col, valid, ground):
        rng[300:700:2] = 10.125         # inner cells all at curvature 0.5625
        rng[1000:1100:11] = 10.125      # equal spikes far apart

    def spiked_ground(rng, col, valid, ground):
        ground[:] = True
        rng[5::11] = 10.125             # the cells between at 0.015625

    def sector_boundary(rng, col, valid, ground):
        # count 1000: sector 0 ends at 168, sector 1 starts at 169
        for c, h in ((163, 0.125), (166, 0.1875), (168, 0.0625),
                     (169, 0.0625), (171, 0.1875), (174, 0.125)):
            rng[c] += h

    def col_gaps(rng, col, valid, ground):
        rng[[500, 600, 700, W - 7]] += 0.1875
        col[503:] += 11                 # cuts 500's right reach at 2
        col[603:] += 9                  # a gap of 10 cuts nothing
        col[698:] += 11                 # cuts 700's left reach at 2
        rng[901:] += 0.5                # a 0.5 m step, columns 1 apart
        col[1001:] += 8                 # a 0.5 m step, columns 9 apart
        rng[1001:] += 0.5
        col[1101:] += 9                 # a 0.5 m step, columns 10 apart
        rng[1101:] += 0.5

    def short(rng, col, valid, ground):
        rng[5:12:3] += 0.1875
        rng[6] -= 0.5                   # occludes cell 5, the one in range

    def short_sectors(rng, col, valid, ground):
        rng[[8, 14]] += 0.1875          # two corners; 8's band spans 3 sectors
        ground[17:30] = True            # flat ground for the surf picks

    def no_base(rng, col, valid, ground):
        valid[:200] = False
        rng[20:180:9] += 0.1875

    def one_base(rng, col, valid, ground):
        valid[:40] = False
        valid[17] = True
        rng[17] += 0.1875

    def noisy(rng, col, valid, ground):
        rng[:] += g.integers(0, 16, W).astype(F32) / 64

    def prominence(rng, col, valid, ground):
        rng[6:W - 5:6] += 0.1875        # the median is 4 x 0.1875^2
        rng[880:921] = 10.0
        rng[[895, 899, 901, 905]] += 0.1875   # cell 900 sees four

    add(W, ties)
    add(W, spiked_ground)
    add(1000, sector_boundary)
    add(W, col_gaps)
    add(11, short)
    add(12, short)
    add(30, short_sectors)
    add(0)
    add(200, no_base)
    add(40, one_base)
    add(100, noisy)                     # n_ok = 90
    add(101, noisy)                     # n_ok = 91
    add(W, prominence)
    while len(rows) < R:
        rows.append(_scan_like_row(W, g))
    rng, valid, col, ground, count = (np.stack([r[i] for r in rows[:R]])
                                      for i in range(5))
    return rng, valid, col, ground, count.astype(np.int32)


def _scan_like_row(W, g):
    """Smooth walls with 1 cm noise, depth steps, column gaps and ground
    stretches, as in a segmented scan; count in [W/2, W]."""
    count = int(g.integers(W // 2, W + 1))
    steps = np.where(g.random(W) < 0.02, g.normal(0.0, 2.0, W), 0.0)
    rng = (12.0 + np.cumsum(steps) + g.normal(0.0, 0.01, W)).clip(1.0, 80.0)
    col = np.cumsum(np.where(g.random(W) < 0.05, g.integers(2, 16, W), 1))
    ground = np.repeat(g.random(W // 50 + 1) < 0.4, 50)[:W]
    r, c, valid, gr = _row(W, count, g)
    r[:count], c[:count], gr[:count] = rng[:count], col[:count], ground[:count]
    return r, valid, c, gr, count


def random_rows(seed: int, R: int = 16, W: int = 1800):
    """Seeded random packed rows, garbage beyond each count; the counts
    include 0, 11, 12 and W."""
    g = np.random.default_rng(seed)
    counts = g.integers(0, W + 1, R)
    counts[:4] = (0, 11, 12, W)
    walls = 12.0 + np.cumsum(np.where(g.random((R, W)) < 0.03,
                                      g.uniform(-0.25, 0.25, (R, W)), 0.0),
                             axis=1) + g.normal(0.0, 0.005, (R, W))
    rng = np.where(g.random((R, W)) < 0.02, g.uniform(0.5, 50.0, (R, W)),
                   walls).astype(F32)
    col = np.cumsum(g.integers(1, 13, (R, W)), axis=1).astype(np.int32)
    valid = g.random((R, W)) < 0.95
    ground = g.random((R, W)) < 0.5
    return rng, valid, col, ground, counts.astype(np.int32)


def packed_from(rng, valid, col, ground, count, device="cpu",
                max_outlier: int = 4096) -> SegmentedScan:
    """A SegmentedScan of these rows (the fields the label step does not
    read are zeros)."""
    R, W = rng.shape
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=device)  # noqa: E731
    return SegmentedScan(
        xyz=torch.zeros((R, W, 3), device=device), rng=t(rng), col=t(col),
        row_frac=torch.zeros((R, W), device=device), ground=t(ground),
        valid=t(valid), count=t(count),
        outlier_xyz=torch.zeros((max_outlier, 3), device=device),
        outlier_valid=torch.zeros(max_outlier, dtype=torch.bool, device=device))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plain_labels_nothing_at_or_beyond_count(seed):
    cfg = config_for("vlp16")
    rows = random_rows(seed)
    lab, pick = features.label_features_plain(packed_from(*rows), cfg)
    beyond = np.arange(rows[0].shape[1])[None, :] >= rows[4][:, None]
    assert not lab.numpy()[beyond].any()
    assert not pick.numpy()[beyond].any()
    # the rows do reach the picks: every row of 100 cells or more gets
    # some picked cells, and the rows both kinds of label
    assert pick.numpy()[rows[4] >= 100].any(axis=1).all()
    assert (lab.numpy() == 2).any() and (lab.numpy() == -1).any()


def test_built_rows_cover_their_cases():
    """The built rows reach the cases they are built for (under the plain
    version): tied picks, picks next to a sector boundary, cut reaches."""
    cfg = config_for("vlp16")
    rng, valid, col, ground, count = built_rows()
    packed = packed_from(rng, valid, col, ground, count)
    curv, corner, surf, picked0, reach_l, reach_r, sp, ep, ok = (
        features.pick_inputs(packed, cfg))
    lab, pick = features.label_features_plain(packed, cfg)
    lab, curv = lab.numpy(), curv.numpy()
    # ties: the alternating stretch's picks are at curvature 0.5625
    assert (curv[0, lab[0] > 0] == 0.5625).sum() >= 6
    assert (lab[1] == -1).sum() >= 6
    assert (curv[1, lab[1] == -1] == 0.015625).all()
    # a pick on each side of sector 0 / 1's boundary
    assert (int(sp[2, 1]), int(ep[2, 0])) == (169, 168)
    assert lab[2, 166] > 0 and lab[2, 171] > 0
    # reach cut by column gaps, and kept across a gap of 10
    assert (reach_r[3, 500], reach_l[3, 700], reach_r[3, 600]) == (2, 2, 5)
    assert lab[3, 500] > 0 and lab[3, 700] > 0 and lab[3, 600] > 0
    assert lab[3, 1793] > 0 and reach_r[3, 1793] == 5
    # count 11 and 0: nothing; count 12: occlusion marks only
    assert not lab[[4, 5, 7]].any() and not pick.numpy()[[4, 7]].any()
    assert picked0.numpy()[5].any() and not ok.numpy()[5].any()
    # count 30: sectors of at most 4 cells, and picks in them
    assert ((ep - sp + 1)[6][ok[6]] <= 4).all()
    assert lab[6, 8] > 0 and lab[6, 14] > 0 and (lab[6] == -1).any()
    # n_ok of 0, 1, even and odd
    base = packed.valid.numpy() & (np.arange(1800) >= 5) & (
        np.arange(1800) <= count[:, None] - 6)
    assert list(base[[8, 9, 10, 11]].sum(axis=1)) == [0, 1, 90, 91]
    # prominence row: the median is 4 h^2, and one cell sits at 16 h^2
    assert np.median(curv[12, base[12]]) == 4 * 0.1875 ** 2
    assert curv[12, 900] == 16 * 0.1875 ** 2
