"""Label propagation (K1's function) on built masks that stress a tiled
union-find: a serpentine through every tile border, components joined only
across the column seam (H-1 to 0), a fully connected grid, an empty one,
random masks near the percolation thresholds, and one column through all
rows.  Here on the CPU the plain version (what the wrapper runs on a CPU
tensor) is held, exactly, against an independent reference: the graph's
connected components from scipy, each labelled with its minimum index.
tests/test_torch_kernels_cuda.py holds the CUDA kernel against the plain
version on the same masks.
"""

import numpy as np
import pytest
import scipy.sparse as sp
from scipy.sparse.csgraph import connected_components
import torch

from lego_loam_tpu_torch.ops import segmentation

CASES = ("serpentine", "seam", "full", "empty", "site", "bond", "column")
# the card's shapes: preset grids (VLS-128, OS1-64) and ragged ones (rows
# and columns that are not multiples of an 8 x 64 tile; one narrower than a
# tile).  Here the plain version runs on smaller ones: its sweeps on the
# preset grids cost seconds of the suite, and the card tests hold the
# kernel against the scipy reference there as well.
SHAPES = ((128, 1800), (64, 1024), (20, 100), (5, 7))
CPU_SHAPES = ((40, 300), (20, 100), (5, 7))


def seam_rows(R):
    """(end of the left block, start of the right block) of the seam case."""
    return (3 * R) // 4, R // 2


def label_case(name: str, R: int, H: int, seed: int = 0):
    """(seg, edge_h, edge_v) numpy bool grids in build_edges' convention:
    edge_h[r, c] joins (r, c)-(r, c+1 mod H), edge_v[r, c] joins
    (r, c)-(r+1, c); every edge joins two segmentable pixels."""
    rng = np.random.default_rng(seed)
    seg = np.zeros((R, H), bool)
    cut_h = np.zeros((R, H), bool)          # edges left out on purpose
    if name == "serpentine":
        # full even rows, joined through one pixel of each odd row at
        # alternating ends; the seam is cut, so it is one long path
        seg[0::2] = True
        for r in range(1, R, 2):
            seg[r, H - 1 if (r // 2) % 2 == 0 else 0] = True
        cut_h[:, H - 1] = True
    elif name == "seam":
        # a block at the left edge (rows 1 .. 3R/4) and one at the right
        # edge (rows R/2 ..): only the wrap edge of the left block's last
        # row joins them, so the right block takes the left one's minimum
        w = max(1, min(5, H // 3))
        seg[1:seam_rows(R)[0], :w] = True
        seg[seam_rows(R)[1]:, H - w:] = True
        cut_h[:, H - 1] = True
        cut_h[seam_rows(R)[0] - 1, H - 1] = False
    elif name == "full":
        seg[:] = True
    elif name == "site":
        seg = rng.random((R, H)) < 0.5927      # site percolation threshold
    elif name == "bond":
        seg[:] = True
        cut_h = rng.random((R, H)) >= 0.5      # bond percolation threshold
    elif name == "column":
        seg[:, min(64, H - 1)] = True
    elif name != "empty":
        raise ValueError(name)
    edge_h = seg & np.roll(seg, -1, 1) & ~cut_h
    edge_v = np.zeros_like(seg)
    edge_v[:-1] = seg[:-1] & seg[1:]
    if name == "bond":
        edge_v[:-1] &= rng.random((R - 1, H)) < 0.5
    return seg, edge_h, edge_v


def label_args(seg, edge_h, edge_v, device="cpu"):
    """The arguments of propagate_labels for numpy grids."""
    t = [torch.as_tensor(a, device=device) for a in (seg, edge_h, edge_v)]
    return segmentation.label_inputs(*t)


def reference_labels(seg, edge_h, edge_v):
    """Min linear index of each pixel's component (scipy connected
    components over the undirected edges); R*H where not segmentable."""
    R, H = seg.shape
    n = R * H
    idx = np.arange(n).reshape(R, H)
    a = np.concatenate([idx[edge_h], idx[edge_v]])
    b = np.concatenate([np.roll(idx, -1, 1)[edge_h],
                        np.roll(idx, -1, 0)[edge_v]])
    g = sp.coo_matrix((np.ones(a.size), (a, b)), shape=(n, n))
    _, comp = connected_components(g, directed=False)
    lo = np.full(comp.max() + 1, n)
    np.minimum.at(lo, comp, np.arange(n))
    return np.where(seg, lo[comp].reshape(R, H), n).astype(np.int32)


@pytest.mark.parametrize("shape", CPU_SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("name", CASES)
def test_plain_labels_match_reference(name, shape):
    R, H = shape
    seg, edge_h, edge_v = label_case(name, R, H)
    want = reference_labels(seg, edge_h, edge_v)
    # a budget of R*H sweeps cannot bind: the loop stops when nothing moves
    got = segmentation.propagate_labels(*label_args(seg, edge_h, edge_v),
                                        max_sweeps=R * H)
    np.testing.assert_array_equal(got.numpy(), want)
    if name in ("serpentine", "full"):
        assert (want[seg] == 0).all()
    if name == "seam":
        assert (want[seam_rows(R)[1]:, H - 1] == H).all()
