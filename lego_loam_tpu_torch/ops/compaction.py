"""Segmented-cloud assembly: grid -> per-ring compacted arrays
(counterpart of ``lego_loam_tpu.ops.compaction``; imageProjection.cpp:312-368).

Kept pixels of ring r occupy [0, count[r]) in column order: cluster points
always, ground points at every 5th column (plus the first/last few columns);
invalid-cluster pixels above the ground rows are sampled at every 5th column
into the outlier cloud.
"""

from __future__ import annotations

import torch

from lego_loam_tpu_torch.config import PipelineConfig
from lego_loam_tpu_torch.ops.ground import mark_ground
from lego_loam_tpu_torch.ops.projection import pixel_rel_time
from lego_loam_tpu_torch.ops.segmentation import Segmentation, label_components
from lego_loam_tpu_torch.types import RangeImage, SegmentedScan


def compact_segments(img: RangeImage, ground: torch.Tensor, seg: Segmentation,
                     cfg: PipelineConfig):
    """Returns (SegmentedScan, outlier relative sweep times)."""
    R, H = img.rng.shape
    dev = img.rng.device
    cols = torch.arange(H, dtype=torch.int32, device=dev).expand(R, H)
    ground_sampled = ground & ((cols % 5 == 0) | (cols <= 5) | (cols >= H - 5))
    keep = seg.cluster_good | ground_sampled

    # per-ring stable pack by column order: kept pixels first (keys unique)
    order = torch.argsort(torch.where(keep, cols, H + cols), dim=1)
    rel = pixel_rel_time(img)

    def take(x):
        return torch.take_along_dim(x, order, dim=1)

    count = keep.sum(dim=1).to(torch.int32)
    idx = torch.arange(H, dtype=torch.int32, device=dev).expand(R, H)
    packed = SegmentedScan(
        xyz=torch.take_along_dim(img.xyz, order[..., None], dim=1),
        rng=take(img.rng),
        col=take(cols),
        row_frac=take(rel),
        ground=take(ground),
        valid=idx < count[:, None],
        count=count,
        outlier_xyz=None,
        outlier_valid=None,
    )

    # outlier cloud: sampled invalid-cluster pixels above the ground rows
    # (imageProjection.cpp:328-334), first max_outlier in linear order
    rows = torch.arange(R, dtype=torch.int32, device=dev)[:, None].expand(R, H)
    flat_mask = (seg.outlier & (rows > cfg.sensor.ground_scan_ind)
                 & (cols % 5 == 0)).reshape(-1)
    lin = torch.arange(R * H, dtype=torch.int32, device=dev)
    okey = torch.where(flat_mask, lin, R * H)
    oorder = torch.argsort(okey, stable=True)[: cfg.max_outlier]
    o_valid = flat_mask[oorder]
    o_xyz = img.xyz.reshape(-1, 3)[oorder]
    o_rel = rel.reshape(-1)[oorder]
    return packed._replace(
        outlier_xyz=torch.where(o_valid[:, None], o_xyz, 0.0),
        outlier_valid=o_valid,
    ), o_rel


def segment_scan(img: RangeImage, cfg: PipelineConfig):
    """Ground + clustering + compaction.

    Returns (SegmentedScan, outlier_rel_time, ground_mask, Segmentation)."""
    ground = mark_ground(img, cfg)
    seg = label_components(img, ground, cfg)
    packed, o_rel = compact_segments(img, ground, seg, cfg)
    return packed, o_rel, ground, seg
