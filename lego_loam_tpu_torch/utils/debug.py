"""Per-stage debug cloud dumps, the reference's rviz debugging workflow: a
jax-free counterpart of ``lego_loam_tpu.utils.debug``.

The reference publishes debug clouds from every stage (ground / segmented
/ outlier clouds from imageProjection.cpp:480-506, sharp / flat / less-*
feature clouds from featureAssociation.cpp:790-816, history / corrected
submaps from mapOptmization.cpp:863-869).  dump_stages runs one scan
through the front-end stages on a device (the card unless the caller
passes device="cpu") and writes each intermediate as a PCD; dump_keyframe
writes one keyframe's stored blocks.

Usage:
    from lego_loam_tpu_torch.utils.debug import dump_stages
    info = dump_stages(cfg, xyz, valid, ring, "/tmp/frame42")
"""

from __future__ import annotations

import os

import numpy as np
import torch

from lego_loam_tpu_torch.config import PipelineConfig
from lego_loam_tpu_torch.io.pcd import save_pcd
from lego_loam_tpu_torch.ops.compaction import segment_scan
from lego_loam_tpu_torch.ops.features import extract_features
from lego_loam_tpu_torch.ops.projection import project_scan


def dump_stages(cfg: PipelineConfig, xyz, valid, ring=None,
                out_dir: str = ".", prefix: str = "", device="cuda") -> dict:
    """Run projection -> segmentation -> features on ONE scan on `device`
    and write each stage's cloud as `<out_dir>/<prefix><stage>.pcd`.

    Returns {stage: point_count}.  Clouds are in the sensor frame, what the
    reference's debug publishers emit (full_cloud_projected, ground_cloud,
    segmented_cloud, outlier_cloud, sharp/less_sharp/flat/less_flat)."""
    os.makedirs(out_dir, exist_ok=True)
    dev = torch.device(device)
    xyz = torch.as_tensor(xyz, dtype=torch.float32, device=dev)
    valid = torch.as_tensor(valid, dtype=torch.bool, device=dev)
    ring = (torch.as_tensor(ring, dtype=torch.int32, device=dev)
            if ring is not None and cfg.sensor.use_ring else None)

    img = project_scan(xyz, valid, cfg, ring)
    packed, o_rel, ground, _ = segment_scan(img, cfg)
    feats = extract_features(packed, o_rel, cfg)

    counts = {}

    def host(x):
        return x.cpu().numpy()

    def dump(name, pts, mask):
        pts = np.asarray(pts, np.float32).reshape(-1, 3)[np.asarray(mask).reshape(-1)]
        save_pcd(os.path.join(out_dir, f"{prefix}{name}.pcd"), pts)
        counts[name] = int(pts.shape[0])

    img_valid = host(img.valid)
    dump("projected", host(img.xyz), img_valid)
    dump("ground", host(img.xyz), img_valid & host(ground))
    dump("segmented", host(packed.xyz), host(packed.valid))
    dump("segmented_nonground", host(packed.xyz),
         host(packed.valid) & ~host(packed.ground))
    dump("outlier", host(packed.outlier_xyz), host(packed.outlier_valid))
    for name in ("sharp", "less_sharp", "flat", "less_flat"):
        fc = getattr(feats, name)
        dump(name, host(fc.xyz), host(fc.valid))
    return counts


def dump_keyframe(pipeline, k: int, out_dir: str = ".") -> dict:
    """Write keyframe k's stored corner / surf / outlier blocks in the map
    frame, the reference's history-submap debug publisher
    (mapOptmization.cpp:863-869)."""
    os.makedirs(out_dir, exist_ok=True)
    st = pipeline.mstate
    R = st.kf_R[k].cpu().numpy()
    t = st.kf_t[k].cpu().numpy()
    counts = {}
    for name, pts, val in (
            ("kf_corner", st.kf_corner[k], st.kf_corner_valid[k]),
            ("kf_surf", st.kf_surf[k], st.kf_surf_valid[k]),
            ("kf_outlier", st.kf_outlier[k], st.kf_outlier_valid[k])):
        p = pts.cpu().numpy()[val.cpu().numpy()] @ R.T + t
        save_pcd(os.path.join(out_dir, f"{name}_{k}.pcd"), p.astype(np.float32))
        counts[name] = int(p.shape[0])
    return counts
