"""Ground extraction: vertical-stencil test on the range image
(counterpart of ``lego_loam_tpu.ops.ground``; imageProjection.cpp:260-310)."""

from __future__ import annotations

import torch

from lego_loam_tpu_torch.config import PipelineConfig
from lego_loam_tpu_torch.types import RangeImage


def mark_ground(img: RangeImage, cfg: PipelineConfig) -> torch.Tensor:
    """Returns (n_scan, horizon_scan) bool ground mask."""
    g = cfg.sensor.ground_scan_ind
    d = img.xyz[1: g + 1] - img.xyz[:g]
    both_valid = img.valid[:g] & img.valid[1: g + 1]
    angle_deg = torch.rad2deg(torch.atan2(
        d[..., 2], torch.sqrt(d[..., 0] ** 2 + d[..., 1] ** 2)))
    is_flat = ((angle_deg - cfg.sensor.mount_angle).abs()
               <= cfg.ground_angle_thresh_deg) & both_valid
    ground = torch.zeros_like(img.valid)
    ground[:g] = is_flat
    ground[1: g + 1] |= is_flat
    return ground & img.valid
