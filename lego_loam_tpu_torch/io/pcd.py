"""PCD export (on the host): a jax-free copy of ``lego_loam_tpu.io.pcd``.

The reference saves finalCloud.pcd / cornerMap.pcd / surfaceMap.pcd /
trajectory.pcd at shutdown (reference: mapOptmization.cpp:724-755,
utility.h:57).  Same artifacts here, minus the PCL dependency; from the
same state the files are byte-identical to the JAX package's.
"""

from __future__ import annotations

import os

import numpy as np


def save_pcd(path: str, points: np.ndarray, binary: bool = True) -> None:
    """Write an (N, 3) float32 cloud as PCD."""
    pts = np.ascontiguousarray(points, dtype=np.float32).reshape(-1, 3)
    n = pts.shape[0]
    header = (
        "# .PCD v0.7 - Point Cloud Data file format\n"
        "VERSION 0.7\nFIELDS x y z\nSIZE 4 4 4\nTYPE F F F\nCOUNT 1 1 1\n"
        f"WIDTH {n}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\nPOINTS {n}\n"
        f"DATA {'binary' if binary else 'ascii'}\n"
    )
    with open(path, "wb") as f:
        f.write(header.encode())
        if binary:
            f.write(pts.tobytes())
        else:
            np.savetxt(f, pts, fmt="%.6f")


def load_pcd(path: str) -> np.ndarray:
    """Read an xyz PCD written by save_pcd (binary or ascii)."""
    with open(path, "rb") as f:
        data = f.read()
    header_end = data.index(b"DATA")
    line_end = data.index(b"\n", header_end)
    header = data[:line_end].decode()
    mode = header.splitlines()[-1].split()[1]
    n = int(next(line for line in header.splitlines()
                 if line.startswith("POINTS")).split()[1])
    body = data[line_end + 1:]
    if mode == "binary":
        return np.frombuffer(body, dtype=np.float32, count=n * 3).reshape(n, 3).copy()
    return np.loadtxt(body.decode().splitlines()).reshape(n, 3).astype(np.float32)


def export_maps(pipeline, out_dir: str) -> dict:
    """Dump the reference's shutdown artifacts.  Returns path -> count."""
    os.makedirs(out_dir, exist_ok=True)
    written = {}
    corner = pipeline.global_map("corner")
    surf = pipeline.global_map("surf")
    outlier = pipeline.global_map("outlier")
    traj = pipeline.keyframe_poses()
    final = np.concatenate([corner, surf, outlier], axis=0)
    for name, cloud in [
        ("cornerMap.pcd", corner), ("surfaceMap.pcd", surf),
        ("trajectory.pcd", traj), ("finalCloud.pcd", final),
    ]:
        p = os.path.join(out_dir, name)
        save_pcd(p, cloud)
        written[p] = cloud.shape[0]
    return written
