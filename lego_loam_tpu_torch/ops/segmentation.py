"""Cluster segmentation of the range image
(counterpart of ``lego_loam_tpu.ops.segmentation``).

  1. boolean edge grids from the beta-angle predicate
     angle = atan2(d2*sin(a), d1 - d2*cos(a)) > segment_theta;
  2. every segmentable pixel starts at its linear index;
  3. label propagation to the min-index fixpoint -- kernel K1
     (``csrc/label_prop.cu``) on a CUDA tensor, the XLA loop's sweeps
     (4-neighbour min + segmented min-scans along rows and columns) on a
     CPU tensor;
  4. per-component size and ring span by scatter reductions, and the
     reference's validity rules (imageProjection.cpp:440-451).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from lego_loam_tpu_torch.config import PipelineConfig
from lego_loam_tpu_torch.kernels import build as kb
from lego_loam_tpu_torch.types import RangeImage


class Segmentation(NamedTuple):
    labels: torch.Tensor        # (R, H) int32 component root id; -1 if not segmentable
    cluster_good: torch.Tensor  # (R, H) bool: member of a valid cluster
    outlier: torch.Tensor       # (R, H) bool: member of an invalid cluster


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    # torch.full fills on the device; torch.tensor(x) would be a host copy
    return torch.full((), x, dtype=torch.float32, device=like.device)


def _edge_predicate(r1, r2, alpha: float, theta: float):
    a = _f32(alpha, r1)
    d1 = torch.maximum(r1, r2)
    d2 = torch.minimum(r1, r2)
    return torch.atan2(d2 * torch.sin(a), d1 - d2 * torch.cos(a)) > theta


def build_edges(img: RangeImage, ground: torch.Tensor, cfg: PipelineConfig):
    """(seg, edge_h, edge_v): seg marks pixels that take part in clustering;
    edge_h[r, c] joins (r, c)-(r, c+1 mod H); edge_v[r, c] joins
    (r, c)-(r+1, c) (last row all False)."""
    seg = img.valid & ~ground
    theta = cfg.segment_theta
    edge_h = (_edge_predicate(img.rng, torch.roll(img.rng, -1, 1),
                              cfg.segment_alpha_x, theta)
              & seg & torch.roll(seg, -1, 1))
    edge_v = torch.zeros_like(seg)
    edge_v[:-1] = (_edge_predicate(img.rng[:-1], img.rng[1:],
                                   cfg.segment_alpha_y, theta)
                   & seg[:-1] & seg[1:])
    return seg, edge_h, edge_v


def _shift(v: torch.Tensor, d: int, dim: int, fill):
    """v[i - d] at i along `dim` (d < 0: v[i + |d|]); vacated cells = fill."""
    out = torch.roll(v, d, dim)
    n = v.shape[dim]
    idx = torch.arange(n, device=v.device)
    keep = idx >= d if d > 0 else idx < n + d
    shape = [1] * v.dim()
    shape[dim] = n
    return torch.where(keep.view(shape), out, fill)


def _segmented_min_scan(labels, conn_prev, dim: int, reverse: bool, big: int):
    """Min over the maximal connected run prefix (suffix if reverse) along
    `dim`; conn_prev[i] means i is joined to its predecessor in scan
    direction.  Hillis-Steele doubling: log2(n) shift+min steps."""
    m, e = labels, conn_prev
    n = labels.shape[dim]
    d = 1
    while d < n:
        s = -d if reverse else d
        ms = _shift(m, s, dim, big)
        es = _shift(e, s, dim, False)
        m = torch.where(e, torch.minimum(m, ms), m)
        e = e & es
        d *= 2
    return m


def propagate_labels_plain(labels0, conn_left, edge_h, conn_up, conn_down,
                           max_sweeps: int = 64):
    """The XLA loop (lego_loam_tpu/ops/segmentation.py:126-164): sweeps of
    4-neighbour min (circular columns) + linear segmented min-scans along
    rows and columns, until no label changes or max_sweeps."""
    R, H = labels0.shape
    big = R * H
    conn_left_lin = conn_left.clone()
    conn_left_lin[:, 0] = False
    conn_right_lin = edge_h.clone()
    conn_right_lin[:, -1] = False
    bigt = torch.full_like(labels0, big)

    def sweep(labels):
        n = torch.minimum(torch.where(conn_left, torch.roll(labels, 1, 1), bigt),
                          torch.where(edge_h, torch.roll(labels, -1, 1), bigt))
        n = torch.minimum(n, torch.where(conn_up, torch.roll(labels, 1, 0), bigt))
        n = torch.minimum(n, torch.where(conn_down, torch.roll(labels, -1, 0), bigt))
        labels = torch.minimum(labels, n)
        labels = torch.minimum(
            _segmented_min_scan(labels, conn_left_lin, 1, False, big),
            _segmented_min_scan(labels, conn_right_lin, 1, True, big))
        return torch.minimum(
            _segmented_min_scan(labels, conn_up, 0, False, big),
            _segmented_min_scan(labels, conn_down, 0, True, big))

    labels = labels0
    for _ in range(max_sweeps):
        new = sweep(labels)
        changed = bool((new != labels).any())
        labels = new
        if not changed:
            break
    return labels


def propagate_labels(labels0, conn_left, edge_h, conn_up, conn_down,
                     max_sweeps: int = 64):
    """Label propagation to the min-index fixpoint (K1).

    labels0 (R, H) int32 (p for a segmentable pixel, >= R*H otherwise);
    conn_left / edge_h (= conn_right) / conn_up / conn_down (R, H) bool.
    CUDA tensors launch ``csrc/label_prop.cu``; CPU tensors run
    :func:`propagate_labels_plain`.  The kernel's sweep count is kept in
    ``propagate_labels.last_sweeps`` (a device tensor)."""
    if not labels0.is_cuda:
        return propagate_labels_plain(labels0, conn_left, edge_h, conn_up,
                                      conn_down, max_sweeps)
    R, H = labels0.shape
    dev = labels0.device
    kb.require(labels0, "labels0", torch.int32, (R, H), dev)
    for name, m in (("conn_left", conn_left), ("edge_h", edge_h),
                    ("conn_up", conn_up), ("conn_down", conn_down)):
        kb.require(m, name, torch.bool, (R, H), dev)
    lib = kb.library()
    need = lib.lego_label_prop_smem_bytes(R, H)
    optin = torch.cuda.get_device_properties(dev).shared_memory_per_block_optin
    if need > optin:
        raise ValueError(
            f"label_prop: a {R}x{H} grid needs {need} B of shared memory, a "
            f"block may hold {optin} B (larger sensors need a multi-block "
            "kernel)")
    out = torch.empty((R, H), dtype=torch.int32, device=dev)
    sweeps = torch.empty((), dtype=torch.int32, device=dev)
    kb.check(lib.lego_label_prop(
        labels0.data_ptr(), conn_left.data_ptr(), edge_h.data_ptr(),
        conn_up.data_ptr(), conn_down.data_ptr(), out.data_ptr(),
        sweeps.data_ptr(), R, H, max_sweeps, kb.stream_of(labels0)),
        "label_prop")
    propagate_labels.launches += 1
    propagate_labels.last_sweeps = sweeps
    return out


propagate_labels.launches = 0
propagate_labels.last_sweeps = None


def label_inputs(seg, edge_h, edge_v):
    """(labels0, conn_left, conn_right, conn_up, conn_down): the arguments
    of :func:`propagate_labels` for the edges of :func:`build_edges`."""
    R, H = seg.shape
    lin = torch.arange(R * H, dtype=torch.int32, device=seg.device).reshape(R, H)
    labels0 = torch.where(seg, lin, R * H).to(torch.int32)
    conn_left = torch.roll(edge_h, 1, 1)          # (r,c) joined to (r,c-1)
    conn_up = torch.zeros_like(edge_v)
    conn_up[1:] = edge_v[:-1]
    return labels0, conn_left, edge_h.contiguous(), conn_up, edge_v.contiguous()


def label_components(img: RangeImage, ground: torch.Tensor,
                     cfg: PipelineConfig, edges=None) -> Segmentation:
    R, H = img.rng.shape
    seg, edge_h, edge_v = edges if edges is not None else build_edges(img, ground, cfg)
    labels = propagate_labels(*label_inputs(seg, edge_h, edge_v),
                              cfg.label_prop_max_sweeps)
    return _finalize(labels, seg, R, H, R * H, cfg)


def _cluster_stats_scatter(labels, seg, R, H, big, cfg):
    """Per-component size and ring span via scatter reductions (invalid
    pixels land in slot R*H)."""
    dev = labels.device
    flat = torch.where(seg, labels, big).reshape(-1).to(torch.int64)
    ones = seg.reshape(-1).to(torch.int32)
    counts = torch.zeros(R * H + 1, dtype=torch.int32, device=dev)
    counts.scatter_add_(0, flat, ones)
    rows = torch.arange(R, dtype=torch.int32, device=dev)[:, None].expand(R, H).reshape(-1)
    min_row = torch.full((R * H + 1,), R, dtype=torch.int32, device=dev)
    min_row.scatter_reduce_(0, flat, torch.where(ones == 1, rows, R), "amin")
    max_row = torch.full((R * H + 1,), -1, dtype=torch.int32, device=dev)
    max_row.scatter_reduce_(0, flat, torch.where(ones == 1, rows, -1), "amax")
    span = max_row - min_row + 1
    good = (counts >= cfg.segment_big_cluster) | (
        (counts >= cfg.segment_valid_point_num)
        & (span >= cfg.segment_valid_line_num))
    return good[flat].reshape(R, H)


def _finalize(labels, seg, R, H, big, cfg) -> Segmentation:
    """Component statistics + validity rules (imageProjection.cpp:440-451)."""
    cluster_good = seg & _cluster_stats_scatter(labels, seg, R, H, big, cfg)
    return Segmentation(
        labels=torch.where(seg, labels, -1),
        cluster_good=cluster_good,
        outlier=seg & ~cluster_good,
    )
