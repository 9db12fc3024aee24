"""Fixed-shape NamedTuples of tensors that flow between pipeline stages.

Same fields and shapes as ``lego_loam_tpu.types``: every hand-off is a
NamedTuple of padded tensors plus masks and counts.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

# Sentinel range for empty range-image pixels (finite: keeps arithmetic
# NaN-free).
INVALID_RANGE = 1.0e9


class RangeImage(NamedTuple):
    """Projected scan: all tensors are (n_scan, horizon_scan[, 3])."""

    xyz: torch.Tensor          # (R, H, 3) point coordinates; 0 where invalid
    rng: torch.Tensor          # (R, H) range; INVALID_RANGE where empty
    valid: torch.Tensor        # (R, H) bool
    start_orientation: torch.Tensor  # scalar, sweep azimuth window start
    end_orientation: torch.Tensor    # scalar
    orientation_diff: torch.Tensor   # scalar


class SegmentedScan(NamedTuple):
    """Per-ring compacted segmentation output: the kept pixels of ring r
    occupy the prefix [0, count[r]) in column order; the tail is padding."""

    xyz: torch.Tensor          # (R, W, 3)
    rng: torch.Tensor          # (R, W)
    col: torch.Tensor          # (R, W) int32 original column index
    row_frac: torch.Tensor     # (R, W) relative sweep time in [0, 1]
    ground: torch.Tensor       # (R, W) bool
    valid: torch.Tensor        # (R, W) bool
    count: torch.Tensor        # (R,) int32
    outlier_xyz: torch.Tensor  # (max_outlier, 3) sampled outlier cloud
    outlier_valid: torch.Tensor  # (max_outlier,) bool


class FeatureCloud(NamedTuple):
    """One padded feature set: points + ring id + sweep-time fraction, with
    the segmentation's ground label (None = label unavailable)."""

    xyz: torch.Tensor          # (N, 3)
    ring: torch.Tensor         # (N,) int32
    s: torch.Tensor            # (N,) float32 relative sweep time in [0, 1]
    valid: torch.Tensor        # (N,) bool
    ground: torch.Tensor | None = None  # (N,) bool, or None


class ScanFeatures(NamedTuple):
    """Front-end output per scan."""

    sharp: FeatureCloud        # corner candidates for odometry
    less_sharp: FeatureCloud   # corner reference set for the next scan
    flat: FeatureCloud         # planar candidates for odometry (ground only)
    less_flat: FeatureCloud    # planar reference set for the next scan
    outlier: FeatureCloud      # sampled outliers (fed to mapping as surf)


def empty_feature_cloud(capacity: int, device=None) -> FeatureCloud:
    return FeatureCloud(
        xyz=torch.zeros((capacity, 3), dtype=torch.float32, device=device),
        ring=torch.zeros((capacity,), dtype=torch.int32, device=device),
        s=torch.zeros((capacity,), dtype=torch.float32, device=device),
        valid=torch.zeros((capacity,), dtype=torch.bool, device=device),
        ground=torch.zeros((capacity,), dtype=torch.bool, device=device),
    )
