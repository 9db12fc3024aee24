"""NamedTuples of numpy arrays <-> the port's NamedTuples of tensors.

This is how a port stage starts from the exact state another implementation
reached (the counterpart of carrying weights across): any NamedTuple whose
class name and fields match one of the port's state types -- OdometryState,
MappingState, ImuBuffer, ScanFeatures, FeatureCloud, Pose -- converts field
by field.  MappingState's map_age / map_stale and ImuBuffer's ptr / count
are host values in the port.
"""

from __future__ import annotations

import numpy as np
import torch

from lego_loam_tpu_torch.models.imu import ImuBuffer
from lego_loam_tpu_torch.models.mapping import MappingState
from lego_loam_tpu_torch.models.odometry import OdometryState
from lego_loam_tpu_torch.types import FeatureCloud, ScanFeatures
from lego_loam_tpu_torch.utils.math3d import Pose

_TYPES = {cls.__name__: cls for cls in
          (OdometryState, MappingState, ImuBuffer, ScanFeatures, FeatureCloud,
           Pose)}
_HOST = {("MappingState", "map_age"): int, ("MappingState", "map_stale"): bool,
         ("ImuBuffer", "ptr"): int, ("ImuBuffer", "count"): int}


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def state_from_numpy(x, device):
    """Convert a NamedTuple (nested) of numpy arrays to the port's type of
    the same name, with every array as a tensor on `device`."""
    if x is None:
        return None
    if _is_namedtuple(x):
        name = type(x).__name__
        cls = _TYPES[name]
        if tuple(cls._fields) != tuple(x._fields):
            raise ValueError(f"{name}: fields {x._fields} != {cls._fields}")
        vals = []
        for f, v in zip(x._fields, x):
            host = _HOST.get((name, f))
            vals.append(host(np.asarray(v)) if host else state_from_numpy(v, device))
        return cls(*vals)
    return torch.as_tensor(np.array(x, copy=True), device=device)


def state_to_numpy(x):
    """The reverse: the same NamedTuple type with numpy leaves."""
    if x is None:
        return None
    if _is_namedtuple(x):
        return type(x)(*(state_to_numpy(v) for v in x))
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)
