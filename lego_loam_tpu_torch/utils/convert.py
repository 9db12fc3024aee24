"""NamedTuples of numpy arrays <-> the port's NamedTuples of tensors.

This is how a port stage starts from the exact state another implementation
reached (the counterpart of carrying weights across): any NamedTuple whose
class name and fields match one of the port's state types -- OdometryState,
MappingState, ImuBuffer, ScanFeatures, FeatureCloud, Pose -- converts field
by field.  MappingState's map_age / map_stale and ImuBuffer's ptr / count
are host values in the port.

A stacked state (a leading batch axis on every leaf, as the JAX package's
BatchPipeline holds it and models/batch.py holds the port's) converts the
same way: its host fields become one host value a sequence, a tuple, and
come back as one (B,) array.

A MappingState's keyframe pool cuts into one slice a rank for the
distributed back end (parallel/backend_sharded.py): shard_pool and its
inverse gather_pool.
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
            vals.append(_host_value(host, v) if host else state_from_numpy(v, device))
        return cls(*vals)
    return torch.as_tensor(np.array(x, copy=True), device=device)


def _host_value(host, v):
    """A host field: one value, or a tuple of one a sequence of a stack."""
    a = np.asarray(v)
    return host(a) if a.ndim == 0 else tuple(host(e) for e in a)


def state_to_numpy(x):
    """The reverse: the same NamedTuple type with numpy leaves (a stacked
    state's per-sequence host values as one array)."""
    if x is None:
        return None
    if _is_namedtuple(x):
        return type(x)(*(state_to_numpy(v) for v in x))
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


# the keyframe pool's block fields, the ones the distributed back end shards
POOL_FIELDS = ("kf_corner", "kf_corner_valid", "kf_surf", "kf_surf_valid",
               "kf_outlier", "kf_outlier_valid")


def shard_pool(state: MappingState, rank: int, world: int) -> MappingState:
    """Rank `rank`'s copy of a whole MappingState: the six pool fields cut
    to its rows [rank K / world, (rank + 1) K / world), the pose-level
    fields whole.  The slice is a copy, so it updates in place alone."""
    K = state.kf_corner.shape[0]
    if K % world:
        raise ValueError(f"a pool of {K} keyframes does not split over {world} ranks")
    n = K // world
    return state._replace(**{f: getattr(state, f)[rank * n:(rank + 1) * n].clone()
                             for f in POOL_FIELDS})


def gather_pool(shards) -> MappingState:
    """The inverse of shard_pool: the whole state from every rank's copy,
    in rank order (the pose-level fields from the first)."""
    return shards[0]._replace(**{f: torch.cat([getattr(s, f) for s in shards])
                                 for f in POOL_FIELDS})
