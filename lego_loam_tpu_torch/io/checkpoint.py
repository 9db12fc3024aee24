"""Checkpoint / resume of the full SLAM state (counterpart of
``lego_loam_tpu.io.checkpoint``), in the JAX package's own ``.npz`` layout,
so a file written by either package loads into the other: a run can hand
its exact state, IMU buffer included, across mid-course.

The layout: one array ``leaf_<i>`` for each leaf of the tree
{"imu_buf", "mstate", "ostate"} in ``jax.tree_util``'s order -- the keys
sorted, then each NamedTuple's fields in order (a Pose as R, t) -- plus
``trajectory`` (N, 3) and ``meta_json`` (frame, imu_used, n_leaves,
version) as uint8 bytes.  The port writes that order out itself
(_leaves).  Its host values (MappingState.map_age / map_stale,
ImuBuffer.ptr / count) go in as 0-d int32 / bool arrays, as the JAX
package stores them.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from lego_loam_tpu_torch.utils.convert import state_from_numpy

# jax.tree_util flattens a dict in sorted key order
_KEYS = ("imu_buf", "mstate", "ostate")


def _tree(pipeline) -> dict:
    return {"imu_buf": pipeline.imu_host.state(), "mstate": pipeline.mstate,
            "ostate": pipeline.ostate}


def _leaves(x) -> list:
    """Leaves of a NamedTuple tree in field order, each as a numpy array
    (host values as 0-d arrays of their JAX dtype)."""
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return [leaf for v in x for leaf in _leaves(v)]
    if isinstance(x, torch.Tensor):
        return [x.detach().cpu().numpy()]
    if isinstance(x, bool):
        return [np.asarray(x, bool)]
    if isinstance(x, int):
        return [np.asarray(x, np.int32)]
    return [np.asarray(x)]


def _unflatten(template, leaves):
    """Rebuild `template`'s NamedTuple tree from an iterator of numpy
    leaves (numpy leaves throughout)."""
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        return type(template)(*(_unflatten(v, leaves) for v in template))
    return next(leaves)


def save_checkpoint(pipeline, path: str) -> None:
    pipeline.sync_map_stale()     # a pending loop flag settles map_stale
    tree = _tree(pipeline)
    leaves = [leaf for k in _KEYS for leaf in _leaves(tree[k])]
    meta = {"frame": pipeline.frame, "imu_used": pipeline.imu_used,
            "n_leaves": len(leaves), "version": 1}
    arrays = {f"leaf_{i}": x for i, x in enumerate(leaves)}
    arrays["trajectory"] = pipeline.trajectory_numpy()
    arrays["meta_json"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    np.savez_compressed(path, **arrays)


def load_checkpoint(pipeline, path: str) -> None:
    """Restore state in place, on the pipeline's device.  The pipeline must
    be built with the same PipelineConfig (shapes must match)."""
    data = np.load(path if path.endswith(".npz") else path + ".npz")
    meta = json.loads(bytes(data["meta_json"]).decode())
    tree = _tree(pipeline)
    refs = [leaf for k in _KEYS for leaf in _leaves(tree[k])]
    if meta["n_leaves"] != len(refs):
        raise ValueError(
            f"checkpoint has {meta['n_leaves']} leaves, pipeline expects "
            f"{len(refs)} — config mismatch?")
    new_leaves = []
    for i, ref in enumerate(refs):
        arr = data[f"leaf_{i}"]
        if arr.shape != ref.shape:
            raise ValueError(
                f"leaf {i}: checkpoint shape {arr.shape} != {ref.shape}")
        new_leaves.append(arr.astype(ref.dtype))
    it = iter(new_leaves)
    loaded = {k: _unflatten(tree[k], it) for k in _KEYS}
    dev = pipeline.device
    pipeline.ostate = state_from_numpy(loaded["ostate"], dev)
    pipeline.mstate = state_from_numpy(loaded["mstate"], dev)
    pipeline.imu_host.load_state(loaded["imu_buf"])
    pipeline.frame = int(meta["frame"])
    pipeline.imu_used = bool(meta["imu_used"])
    pipeline.trajectory = [t for t in data["trajectory"]]
    # the host's upper bound on the keyframe count restarts at the count
    pipeline.n_kf_bound = int(pipeline.mstate.n_kf)
