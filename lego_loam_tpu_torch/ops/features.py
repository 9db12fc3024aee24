"""Curvature-based edge/planar feature extraction
(counterpart of ``lego_loam_tpu.ops.features``; featureAssociation.cpp:621-784).

All rings run in parallel and, in the sector_parallel mode the port
supports, all six sectors of a ring pick at once; the ranked picks within a
sector stay sequential (every pick suppresses neighbours that later picks
must see).  On a CUDA scan the whole label step (curvature, occlusion
mask, reach, ring median, sector picks) is kernel K2
(``csrc/pick_features.cu``), one launch; on a CPU scan it is the plain
prep and pick loop below.
"""

from __future__ import annotations

import ctypes

import torch

from lego_loam_tpu_torch.config import PipelineConfig
from lego_loam_tpu_torch.kernels import build as kb
from lego_loam_tpu_torch.ops.voxel import voxel_downsample
from lego_loam_tpu_torch.types import FeatureCloud, ScanFeatures, SegmentedScan

_NEG_INF = -1.0e30


def compute_curvature(packed: SegmentedScan, cfg: PipelineConfig):
    """11-tap range stencil; curvature = (sum of 10 neighbours - 10 r)^2.
    Returns (curv (R, W), curv_valid (R, W))."""
    rng = packed.rng * packed.valid
    acc = -10.0 * rng
    for off in range(1, 6):
        acc = acc + torch.roll(rng, off, 1) + torch.roll(rng, -off, 1)
    W = rng.shape[1]
    idx = torch.arange(W, dtype=torch.int32, device=rng.device)[None, :]
    curv_valid = (idx >= 5) & (idx <= packed.count[:, None] - 6)
    return acc * acc, curv_valid


def occlusion_mask(packed: SegmentedScan, cfg: PipelineConfig) -> torch.Tensor:
    """Initial picked mask from the occlusion / parallel-beam tests
    (featureAssociation.cpp:643-678)."""
    rng, col = packed.rng, packed.col
    W = rng.shape[1]
    idx = torch.arange(W, dtype=torch.int32, device=rng.device)[None, :]
    in_range = (idx >= 5) & (idx <= packed.count[:, None] - 7)
    nxt = torch.roll(rng, -1, 1)
    col_diff_ok = (torch.roll(col, -1, 1) - col).abs() < cfg.occlusion_col_diff
    occl_this = in_range & col_diff_ok & (rng - nxt > cfg.occlusion_depth_gap)
    occl_next = in_range & col_diff_ok & (nxt - rng > cfg.occlusion_depth_gap)
    picked = torch.zeros_like(in_range)
    # occl_this at i marks i-5..i ; occl_next at i marks i+1..i+6
    for off in range(0, 6):
        picked = picked | torch.roll(occl_this, -off, 1)
    for off in range(1, 7):
        picked = picked | torch.roll(occl_next, off, 1)
    diff1 = (torch.roll(rng, 1, 1) - rng).abs()
    diff2 = (nxt - rng).abs()
    parallel = (in_range & (diff1 > cfg.parallel_beam_frac * rng)
                & (diff2 > cfg.parallel_beam_frac * rng))
    return picked | parallel


def _sector_bounds(count: torch.Tensor, j, cfg: PipelineConfig):
    """Per-ring [sp, ep] of azimuthal sector j (featureAssociation.cpp:693-694);
    j may be an int or a tensor broadcasting against count."""
    start = torch.full_like(count, 4)
    end = count - 6
    sp = torch.div(start * (6 - j) + end * j, 6, rounding_mode="floor")
    ep = torch.div(start * (5 - j) + end * (j + 1), 6, rounding_mode="floor") - 1
    ok = (sp < ep) & (count >= 12)
    return sp.to(torch.int32), ep.to(torch.int32), ok


def _suppress_reach(col: torch.Tensor, count: torch.Tensor, cfg):
    """Per-cell suppression reach (left, right): how far a pick marks its
    +-5 neighbours, stopping at column gaps > 10 and ring bounds
    (featureAssociation.cpp:721-732)."""
    W = col.shape[1]
    idx = torch.arange(W, dtype=torch.int32, device=col.device)[None, :]
    gap = (col - torch.roll(col, 1, 1)).abs() <= 10
    cnt = count[:, None]
    reach_r = torch.zeros(col.shape, dtype=torch.int32, device=col.device)
    ok = torch.ones_like(gap)
    for l in range(1, 6):
        ok = ok & torch.roll(gap, -l, 1) & (idx + l <= cnt - 1)
        reach_r = reach_r + ok.to(torch.int32)
    reach_l = torch.zeros_like(reach_r)
    ok = torch.ones_like(gap)
    for l in range(1, 6):
        ok = ok & torch.roll(gap, l - 1, 1) & (idx - l >= 0)
        reach_l = reach_l + ok.to(torch.int32)
    return reach_l, reach_r


def pick_features_plain(curv, corner_base, surf_base, picked0, reach_l,
                        reach_r, sp_all, ep_all, ok_all, n_sectors: int,
                        n_corner: int, n_sharp: int, n_surf: int):
    """The sector_parallel pick loop (lego_loam_tpu/ops/features.py:169-221):
    per step every sector takes its masked argmax (ties to the lowest
    index) against the same `picked` snapshot, labels it and suppresses its
    reach band.  Returns (labels (R, W) int32, picked (R, W) bool)."""
    R, W = curv.shape
    dev = curv.device
    idxs = torch.arange(W, dtype=torch.int32, device=dev)
    in_sec = ((idxs[None, None, :] >= sp_all[:, :, None])
              & (idxs[None, None, :] <= ep_all[:, :, None])
              & ok_all[:, :, None])                          # (R, S, W)
    rows = torch.arange(R, device=dev).repeat_interleave(n_sectors)
    labels = torch.zeros((R, W), dtype=torch.int32, device=dev)
    picked = picked0.clone()

    def run(base, sign, n_picks, label_of, suppress_last):
        nonlocal labels, picked
        for k in range(n_picks):
            elig = base[:, None, :] & in_sec & ~picked[:, None, :]
            score = torch.where(elig, sign * curv[:, None, :], _NEG_INF)
            idx = torch.argmax(score, dim=2)                     # (R, S)
            has = elig.any(dim=2)
            idx_v = idx.reshape(-1)
            cur = labels[rows, idx_v]
            labels[rows, idx_v] = torch.where(has.reshape(-1), label_of(k), cur)
            sup = has if (suppress_last or k < n_picks - 1) else has & False
            rl = torch.gather(reach_l, 1, idx)
            rr = torch.gather(reach_r, 1, idx)
            band = ((idxs[None, None, :] >= (idx - rl)[:, :, None])
                    & (idxs[None, None, :] <= (idx + rr)[:, :, None])
                    & sup[:, :, None])
            picked = picked | band.any(dim=1)

    run(corner_base, 1.0, n_corner, lambda k: 2 if k < n_sharp else 1, True)
    run(surf_base, -1.0, n_surf, lambda k: -1, False)
    return labels, picked


def pick_inputs(packed: SegmentedScan, cfg: PipelineConfig):
    """The pick loop's inputs: (curv, corner_base, surf_base, picked0,
    reach_l, reach_r, sp_all, ep_all, ok_all) -- the arguments of
    :func:`pick_features_plain` before the static counts."""
    curv, curv_valid = compute_curvature(packed, cfg)
    picked0 = occlusion_mask(packed, cfg)
    reach_l, reach_r = _suppress_reach(packed.col, packed.count, cfg)

    base = packed.valid & curv_valid
    corner_thresh = torch.full((), cfg.edge_threshold, dtype=torch.float32,
                               device=curv.device)
    if cfg.edge_prominence > 0.0:
        # robust prominence gate: a corner must also clear edge_prominence x
        # the per-ring median curvature (the range-noise floor)
        sorted_c = torch.sort(torch.where(base, curv, float("inf")), dim=1).values
        n_ok = base.sum(dim=1)
        med = torch.gather(sorted_c, 1,
                           torch.div(torch.clamp(n_ok - 1, min=0), 2,
                                     rounding_mode="floor")[:, None])[:, 0]
        med = torch.where(torch.isfinite(med), med, 0.0)
        corner_thresh = torch.maximum(corner_thresh,
                                      cfg.edge_prominence * med)[:, None]
    corner_base = base & (curv > corner_thresh) & ~packed.ground
    surf_base = base & (curv < cfg.surf_threshold) & packed.ground

    j_all = torch.arange(cfg.sections_total, dtype=torch.int32,
                         device=curv.device)[None, :]
    sp_all, ep_all, ok_all = _sector_bounds(packed.count[:, None], j_all, cfg)
    return (curv, corner_base, surf_base, picked0, reach_l, reach_r, sp_all,
            ep_all, ok_all)


def label_features_plain(packed: SegmentedScan, cfg: PipelineConfig):
    """K2's plain version: the prep of :func:`pick_inputs`, then the pick
    loop :func:`pick_features_plain`."""
    return pick_features_plain(*pick_inputs(packed, cfg), cfg.sections_total,
                               cfg.edge_feature_num_less, cfg.edge_feature_num,
                               cfg.surf_feature_num)


class _Params(ctypes.Structure):
    """The cfg scalars of ``csrc/pick_features.cu``'s LegoFeatureParams."""

    _fields_ = ([(f, ctypes.c_float) for f in (
        "edge_threshold", "edge_prominence", "surf_threshold",
        "occlusion_depth_gap", "parallel_beam_frac")]
        + [(f, ctypes.c_int) for f in (
            "occlusion_col_diff", "n_sectors", "n_corner", "n_sharp",
            "n_surf", "use_median")])


_PARAMS: dict = {}


def _params(cfg: PipelineConfig) -> int:
    """The address of the kernel's params struct for a config, built once
    per config object (looked up by identity: hashing a config costs more
    than the launch)."""
    hit = _PARAMS.get(id(cfg))
    if hit is None or hit[0] is not cfg:
        p = _Params(cfg.edge_threshold, cfg.edge_prominence,
                    cfg.surf_threshold, cfg.occlusion_depth_gap,
                    cfg.parallel_beam_frac, cfg.occlusion_col_diff,
                    cfg.sections_total, cfg.edge_feature_num_less,
                    cfg.edge_feature_num, cfg.surf_feature_num,
                    int(cfg.edge_prominence > 0.0))
        hit = _PARAMS[id(cfg)] = (cfg, p, ctypes.addressof(p))
    return hit[2]


def _cells_per_lane(W: int) -> int:
    """Cells a lane of K2's pick warps holds at ring width W: a sector spans
    at most ceil((W - 10) / 6) cells, whatever its index."""
    sector = -(-max(W - 10, 0) // 6)
    return -(-sector // 32)


MAX_CELLS_PER_LANE = 16     # the kernel's largest register run
MAX_SECTORS = 8             # one warp a sector, eight warps a block
MAX_RING_WIDTH = 6 * 32 * MAX_CELLS_PER_LANE + 10     # 3082 cells


def check_k2_fits(cfg: PipelineConfig) -> None:
    """Raise ValueError unless K2 takes this config's scans: 1 to
    MAX_SECTORS sectors and rings of at most MAX_RING_WIDTH cells (every
    sensor preset fits: 6 sectors, at most 1800 columns).  The plain
    version takes any config."""
    _check_k2_fits(cfg.sections_total, cfg.sensor.horizon_scan)


def _check_k2_fits(S: int, W: int) -> None:
    if not 1 <= S <= MAX_SECTORS or _cells_per_lane(W) > MAX_CELLS_PER_LANE:
        raise ValueError(f"label_features: {S} sectors of a {W}-cell ring do "
                         f"not fit K2 (1..{MAX_SECTORS} sectors, W <= "
                         f"{MAX_RING_WIDTH})")


def label_features(packed: SegmentedScan, cfg: PipelineConfig):
    """Returns the label grid (2 sharp, 1 less-sharp, -1 flat, 0 none) and
    the final picked mask (sector_parallel pick order).  A CUDA scan
    launches K2 (``csrc/pick_features.cu``, the whole step in one launch,
    from rng / valid / col / ground / count); a CPU scan runs
    :func:`label_features_plain`."""
    if not cfg.sector_parallel:
        raise NotImplementedError(
            "the port implements the sector_parallel pick order only")
    rng = packed.rng
    if not rng.is_cuda:
        return label_features_plain(packed, cfg)
    R, W = rng.shape
    dev = rng.device
    _check_k2_fits(cfg.sections_total, W)
    kb.require(rng, "rng", torch.float32, (R, W), dev)
    kb.require(packed.valid, "valid", torch.bool, (R, W), dev)
    kb.require(packed.col, "col", torch.int32, (R, W), dev)
    kb.require(packed.ground, "ground", torch.bool, (R, W), dev)
    kb.require(packed.count, "count", torch.int32, (R,), dev)
    labels = torch.empty((R, W), dtype=torch.int32, device=dev)
    picked = torch.empty((R, W), dtype=torch.bool, device=dev)
    kb.check(kb.library().lego_label_features(
        rng.data_ptr(), packed.valid.data_ptr(), packed.col.data_ptr(),
        packed.ground.data_ptr(), packed.count.data_ptr(), labels.data_ptr(),
        picked.data_ptr(), R, W, _params(cfg), kb.stream_of(rng)),
        "label_features")
    label_features.launches += 1
    return labels, picked


label_features.launches = 0


def extract_features(packed: SegmentedScan, outlier_s: torch.Tensor,
                     cfg: PipelineConfig) -> ScanFeatures:
    R, W = packed.rng.shape
    dev = packed.rng.device
    rows = torch.arange(R, dtype=torch.int32, device=dev)
    idxs = torch.arange(W, dtype=torch.int32, device=dev)[None, :]
    labels, picked = label_features(packed, cfg)
    ring_grid = rows[:, None].expand(R, W).reshape(-1)
    xyz_flat = packed.xyz.reshape(-1, 3)
    s_flat = packed.row_frac.reshape(-1)
    g_flat = packed.ground.reshape(-1)

    def compact(mask, cap):
        lin = torch.arange(R * W, dtype=torch.int32, device=dev)
        key = torch.where(mask.reshape(-1), lin, R * W)
        order = torch.argsort(key, stable=True)[:cap]
        ok = key[order] < R * W
        return FeatureCloud(
            xyz=torch.where(ok[:, None], xyz_flat[order], 0.0),
            ring=torch.where(ok, ring_grid[order], 0),
            s=torch.where(ok, s_flat[order], 0.0),
            valid=ok,
            ground=ok & g_flat[order],
        )

    sharp = compact(labels == 2, cfg.max_sharp)
    less_sharp = compact(labels >= 1, cfg.max_less_sharp)
    flat = compact(labels == -1, cfg.max_flat)

    # less-flat: everything not corner-picked inside the sector span,
    # voxel-downsampled per ring (featureAssociation.cpp:771-783); cls=ground
    # keeps a leaf on the ground/structure boundary from mixing both
    sp0, _, _ = _sector_bounds(packed.count, 0, cfg)
    _, ep5, _ = _sector_bounds(packed.count, cfg.sections_total - 1, cfg)
    span = ((idxs >= sp0[:, None]) & (idxs <= ep5[:, None])
            & (packed.count[:, None] >= 12))
    lf_mask = span & (labels <= 0) & packed.valid
    cap_per_ring = cfg.max_less_flat // R
    aux = torch.stack([packed.row_frac, packed.ground.to(torch.float32)], dim=-1)
    lf_xyz, lf_aux, lf_valid = voxel_downsample(
        packed.xyz, lf_mask, cfg.leaf_less_flat, cap_per_ring, aux=aux,
        cls=packed.ground)
    less_flat = FeatureCloud(
        xyz=lf_xyz.reshape(-1, 3),
        ring=rows[:, None].expand(R, cap_per_ring).reshape(-1),
        s=lf_aux[..., 0].reshape(-1),
        valid=lf_valid.reshape(-1),
        # voxel mean of the bool label: ground only if ground dominates
        ground=lf_aux[..., 1].reshape(-1) > 0.5,
    )
    n_out = packed.outlier_xyz.shape[0]
    outlier = FeatureCloud(
        xyz=packed.outlier_xyz,
        ring=torch.zeros(n_out, dtype=torch.int32, device=dev),
        s=outlier_s,
        valid=packed.outlier_valid,
        ground=torch.zeros(n_out, dtype=torch.bool, device=dev),
    )
    return ScanFeatures(sharp=sharp, less_sharp=less_sharp, flat=flat,
                        less_flat=less_flat, outlier=outlier)
