"""High-rate pose fusion (TransformFusion node replacement; counterpart of
``lego_loam_tpu.models.fusion``; transformFusion.cpp:94-239)."""

from __future__ import annotations

from lego_loam_tpu_torch.models.mapping import MappingState
from lego_loam_tpu_torch.utils.math3d import Pose


def fuse_pose(state: MappingState, odom_pose: Pose) -> Pose:
    """Map-accurate pose at odometry rate: aft o (bef^-1 o odom)."""
    return state.aft_mapped.compose(state.bef_mapped.inverse().compose(odom_pose))
