"""Curvature-based edge/planar feature extraction
(counterpart of ``lego_loam_tpu.ops.features``; featureAssociation.cpp:621-784).

All rings run in parallel.  With cfg.sector_parallel (the default) all six
sectors of a ring pick at once; without it the sectors pick one after the
other in the reference's order, each sector's corner pass and then its
surf pass against the picks of every earlier pass.  The ranked picks within
a sector stay sequential either way (every pick suppresses neighbours that
later picks must see).  On a CUDA scan the whole label step (curvature,
occlusion mask, reach, ring median, sector picks in either order) is
kernel K2 (``csrc/pick_features.cu``), one launch; on a CPU scan it is the
plain prep and pick loop below.
"""

from __future__ import annotations

import ctypes
from types import SimpleNamespace

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
                        n_corner: int, n_sharp: int, n_surf: int,
                        sector_parallel: bool):
    """The pick loops of lego_loam_tpu/ops/features.py:169-238.  Each step
    takes the masked argmax (ties to the lowest index) of every sector in
    play, labels it and suppresses its reach band.  sector_parallel: all
    sectors in play at once, against the same `picked` snapshot, the
    corner pass and then the surf pass; otherwise the reference's order,
    sector by sector, its corner pass and then its surf pass.  The surf
    pass marks no band for its last pick.  Returns (labels (R, W) int32,
    picked (R, W) bool)."""
    R, W = curv.shape
    dev = curv.device
    idxs = torch.arange(W, dtype=torch.int32, device=dev)
    in_sec = ((idxs[None, None, :] >= sp_all[:, :, None])
              & (idxs[None, None, :] <= ep_all[:, :, None])
              & ok_all[:, :, None])                          # (R, S, W)
    labels = torch.zeros((R, W), dtype=torch.int32, device=dev)
    picked = picked0.clone()

    def run(sector_mask, base, sign, n_picks, label_of, suppress_last):
        nonlocal labels, picked
        rows = torch.arange(R, device=dev).repeat_interleave(sector_mask.shape[1])
        for k in range(n_picks):
            elig = base[:, None, :] & sector_mask & ~picked[:, None, :]
            score = torch.where(elig, sign * curv[:, None, :], _NEG_INF)
            idx = torch.argmax(score, dim=2)                     # (R, S')
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

    def both(sector_mask):
        run(sector_mask, corner_base, 1.0, n_corner,
            lambda k: 2 if k < n_sharp else 1, True)
        run(sector_mask, surf_base, -1.0, n_surf, lambda k: -1, False)

    if sector_parallel:
        both(in_sec)
    else:
        for j in range(n_sectors):
            both(in_sec[:, j:j + 1])
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


# the cfg scalars K2 reads, in the order of LegoFeatureParams (the last,
# use_median, is edge_prominence > 0)
_FLOAT_PARAMS = ("edge_threshold", "edge_prominence", "surf_threshold",
                 "occlusion_depth_gap", "parallel_beam_frac")
_INT_PARAMS = ("occlusion_col_diff", "sections_total", "edge_feature_num_less",
               "edge_feature_num", "surf_feature_num", "sector_parallel",
               "use_median")


def label_features_plain(packed: SegmentedScan, cfg: PipelineConfig):
    """K2's plain version: the prep of :func:`pick_inputs`, then the pick
    loop :func:`pick_features_plain` in cfg.sector_parallel's order."""
    return pick_features_plain(*pick_inputs(packed, cfg), cfg.sections_total,
                               cfg.edge_feature_num_less, cfg.edge_feature_num,
                               cfg.surf_feature_num, bool(cfg.sector_parallel))


class _Params(ctypes.Structure):
    """The cfg scalars of ``csrc/pick_features.cu``'s LegoFeatureParams."""

    _fields_ = ([(f, ctypes.c_float) for f in _FLOAT_PARAMS]
                + [(f, ctypes.c_int) for f in _INT_PARAMS])


_PARAMS: dict = {}


def _params(fparams: list, iparams: list) -> int:
    """The address of the kernel's params struct for these scalars, built
    once per distinct set."""
    key = (*fparams, *iparams)
    hit = _PARAMS.get(key)
    if hit is None:
        p = _Params(*key)
        hit = _PARAMS[key] = (p, ctypes.addressof(p))
    return hit[1]


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
    the final picked mask, in cfg.sector_parallel's pick order.  A CUDA
    scan launches K2 (``csrc/pick_features.cu``, the whole step in one
    launch, from rng / valid / col / ground / count); a CPU scan runs
    :func:`label_features_plain`.  The packed fields may carry leading
    batch dimensions; under torch.func.vmap the batch goes into the same
    launch (one block a ring of every scan)."""
    return _label_features_op(
        packed.rng, packed.valid, packed.col, packed.ground, packed.count,
        [float(getattr(cfg, f)) for f in _FLOAT_PARAMS],
        [int(getattr(cfg, f)) for f in _INT_PARAMS[:-1]]
        + [int(cfg.edge_prominence > 0.0)])


@torch.library.custom_op("lego::label_features", mutates_args=())
def _label_features_op(rng: torch.Tensor, valid: torch.Tensor,
                       col: torch.Tensor, ground: torch.Tensor,
                       count: torch.Tensor, fparams: list[float],
                       iparams: list[int]) -> tuple[torch.Tensor, torch.Tensor]:
    if rng.is_cuda:
        return _launch_label_features(rng, valid, col, ground, count, fparams,
                                      iparams)
    pcfg = SimpleNamespace(**dict(zip(_FLOAT_PARAMS + _INT_PARAMS,
                                      fparams + iparams)))

    def plain(rng, valid, col, ground, count):
        packed = SegmentedScan(None, rng, col, None, ground, valid, count,
                               None, None)
        return label_features_plain(packed, pcfg)

    return kb.per_element(plain, rng.dim() - 2, rng, valid, col, ground, count)


@_label_features_op.register_vmap
def _label_features_vmap(info, in_dims, *args):
    args = [a.contiguous() if isinstance(a, torch.Tensor) else a
            for a in kb.batch_front(info, in_dims, *args)]
    return _label_features_op(*args), (0, 0)


def _launch_label_features(rng, valid, col, ground, count, fparams, iparams):
    """K2 over every ring of a (..., R, W) batch: rings are independent, so
    a batch is R' = B x R rings of one launch."""
    shape = tuple(rng.shape)
    W = shape[-1]
    dev = rng.device
    _check_k2_fits(iparams[_INT_PARAMS.index("sections_total")], W)
    kb.require(rng, "rng", torch.float32, shape, dev)
    kb.require(valid, "valid", torch.bool, shape, dev)
    kb.require(col, "col", torch.int32, shape, dev)
    kb.require(ground, "ground", torch.bool, shape, dev)
    kb.require(count, "count", torch.int32, shape[:-1], dev)
    labels = torch.empty(shape, dtype=torch.int32, device=dev)
    picked = torch.empty(shape, dtype=torch.bool, device=dev)
    kb.check(kb.library().lego_label_features(
        rng.data_ptr(), valid.data_ptr(), col.data_ptr(), ground.data_ptr(),
        count.data_ptr(), labels.data_ptr(), picked.data_ptr(),
        count.numel(), W, _params(fparams, iparams), kb.stream_of(rng)),
        "label_features")
    label_features.launches += 1
    if not iparams[_INT_PARAMS.index("sector_parallel")]:
        label_features.launches_sequential += 1
    return labels, picked


label_features.launches = 0
label_features.launches_sequential = 0    # of which in the sequential order


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
