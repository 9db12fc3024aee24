"""Range-image projection: unordered points -> (n_scan, horizon_scan) grid.

Counterpart of ``lego_loam_tpu.ops.projection``.  Where several points land
in one pixel the nearest wins.  The JAX package sorts by the two keys
(cell, range) in one multi-operand sort; here that is two chained stable
sorts (range first, then cell), which gives the same order, and the winners
(the first entry of each cell run) are scattered into the grid with every
loser sent to one dump slot past its end.
"""

from __future__ import annotations

import math

import torch

from lego_loam_tpu_torch.config import PipelineConfig
from lego_loam_tpu_torch.types import INVALID_RANGE, RangeImage

_TWO_PI = 2.0 * math.pi


def fmod_floor(a: torch.Tensor, b: float) -> torch.Tensor:
    """Python-style modulo (sign of the divisor) built on fmod, the way
    jnp.mod computes it, so both round identically."""
    r = torch.fmod(a, b)
    return torch.where((r != 0) & ((r < 0) != (b < 0)), r + b, r)


def project_scan(
    xyz: torch.Tensor,
    valid: torch.Tensor,
    cfg: PipelineConfig,
    ring: torch.Tensor | None = None,
) -> RangeImage:
    """Project a padded (P, 3) point list with (P,) validity into the range
    image; `ring` (P,) int is required when cfg.sensor.use_ring."""
    s = cfg.sensor
    R, H = s.n_scan, s.horizon_scan
    x, y, z = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    dev = xyz.device
    rng = torch.sqrt(x * x + y * y + z * z)

    if s.use_ring:
        if ring is None:
            raise ValueError(f"sensor {s.name} expects a ring channel")
        row = ring.to(torch.int32)
    else:
        vert_deg = torch.rad2deg(torch.atan2(z, torch.sqrt(x * x + y * y)))
        row = torch.floor((vert_deg + s.ang_bottom) / s.ang_res_y).to(torch.int32)

    # col = -round((atan2(x, y)*deg - 90)/res) + H/2 (imageProjection.cpp:235-242)
    horizon_deg = torch.rad2deg(torch.atan2(x, y))
    col = (-torch.round((horizon_deg - 90.0) / s.ang_res_x)).to(torch.int32) + H // 2
    col = torch.where(col >= H, col - H, col)

    ok = (valid & (row >= 0) & (row < R) & (col >= 0) & (col < H)
          & (rng >= s.min_range) & (rng <= s.max_range))
    flat = torch.where(ok, row * H + col, R * H).to(torch.int64)
    rng_k = torch.where(ok, rng, torch.full_like(rng, INVALID_RANGE))

    # sort by (cell, range): stable by range, then stable by cell
    o1 = torch.sort(rng_k, stable=True).indices
    o2 = torch.sort(flat[o1], stable=True).indices
    order = o1[o2]
    cell = flat[order]
    lead = torch.ones_like(cell, dtype=torch.bool)
    lead[1:] = cell[1:] != cell[:-1]
    lead = lead & (cell < R * H)
    slot = torch.where(lead, cell, R * H)           # losers -> dump slot

    # out of place: under torch.func.vmap (models/batch.py) the empty grids
    # are not batched, the scattered values are
    rng_grid = torch.full((R * H + 1,), INVALID_RANGE, dtype=torch.float32,
                          device=dev).scatter(0, slot, rng_k[order])
    xyz_grid = torch.zeros((R * H + 1, 3), dtype=torch.float32,
                           device=dev).index_put((slot,), xyz[order])
    rng_grid = rng_grid[: R * H].reshape(R, H)
    xyz_grid = xyz_grid[: R * H].reshape(R, H, 3)
    valid_grid = rng_grid < INVALID_RANGE

    # sweep azimuth window from the first/last valid raw points
    # (imageProjection.cpp:199-209)
    # (index_select with a 1-element index: indexing with a 0-d tensor
    # would copy it to the host)
    P = xyz.shape[0]
    vi = valid.to(torch.int32)
    ends = torch.stack([torch.argmax(vi), P - 1 - torch.argmax(vi.flip(0))])
    e = xyz.index_select(0, ends)
    start_ori = -torch.atan2(e[0, 1], e[0, 0])
    end_ori = -torch.atan2(e[1, 1], e[1, 0]) + _TWO_PI
    diff0 = end_ori - start_ori
    end_ori = torch.where(diff0 > 3.0 * math.pi, end_ori - _TWO_PI,
                          torch.where(diff0 < math.pi, end_ori + _TWO_PI, end_ori))
    return RangeImage(
        xyz=xyz_grid, rng=rng_grid, valid=valid_grid,
        start_orientation=start_ori, end_orientation=end_ori,
        orientation_diff=end_ori - start_ori,
    )


def pixel_rel_time(img: RangeImage) -> torch.Tensor:
    """Relative sweep time in [0, 1] per pixel, from pixel azimuth:
    rel = ((ori - start) mod 2pi) / diff."""
    ori = -torch.atan2(img.xyz[..., 1], img.xyz[..., 0])
    rel = fmod_floor(ori - img.start_orientation, _TWO_PI) / torch.clamp(
        img.orientation_diff, min=1e-3)
    return torch.clamp(rel, 0.0, 1.0)
