"""Dense occupancy-grid evaluation (port of ``monoport_tpu/recon/dense.py``).

Volume convention, shared across ``recon``:

    vol[i, j, k] = occ(x = lerp(b_min_x, b_max_x, k / (R-1)),
                       y = lerp(b_min_y, b_max_y, j / (R-1)),
                       z = lerp(b_min_z, b_max_z, i / (R-1)))

axis 0 is z (the "front" viewing ray enters at i = R-1), axis 1 is y, axis
2 is x. ``query_fn(points [1, N, 3]) -> [1, N, 1]``.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..ops.constants import device_constant, float_array

QueryFn = Callable[[torch.Tensor], torch.Tensor]


def _bounds(b_min, b_max, device):
    lo = device_constant(float_array, (tuple(b_min),), device, torch.float32)
    hi = device_constant(float_array, (tuple(b_max),), device, torch.float32)
    return lo, hi


def index_to_world(idx_xyz: torch.Tensor, resolution: int,
                   b_min=(-1.0, -1.0, -1.0),
                   b_max=(1.0, 1.0, 1.0)) -> torch.Tensor:
    """[..., 3] integer (x, y, z) voxel indices -> world coords."""
    lo, hi = _bounds(b_min, b_max, idx_xyz.device)
    unit = idx_xyz.to(torch.float32) / (resolution - 1)
    return unit * (hi - lo) + lo


def flat_to_world(flat: torch.Tensor, resolution: int,
                  b_min=(-1.0, -1.0, -1.0),
                  b_max=(1.0, 1.0, 1.0)) -> torch.Tensor:
    """Flat volume positions [N] (z-major, x-fastest) -> world [N, 3]."""
    r = resolution
    xyz = torch.stack([flat % r, (flat // r) % r, flat // (r * r)], dim=-1)
    return index_to_world(xyz, r, b_min, b_max)


def grid_points(resolution: int, b_min=(-1.0, -1.0, -1.0),
                b_max=(1.0, 1.0, 1.0), device=None) -> torch.Tensor:
    """[R^3, 3] world coords in volume order (z-major, x-fastest)."""
    flat = torch.arange(resolution ** 3, device=torch.device(device or "cpu"))
    return flat_to_world(flat, resolution, b_min, b_max)


def dense_eval(query_fn: QueryFn, resolution: int,
               b_min=(-1.0, -1.0, -1.0), b_max=(1.0, 1.0, 1.0),
               chunk: int = 262144, device=None) -> torch.Tensor:
    """Evaluate the full R^3 grid in chunks of ``chunk`` points (the last
    one padded, so every query has one shape) -> vol [R, R, R]. A chunk's
    points are made from its flat indices: the R^3 x 3 coordinate tensor is
    never held."""
    device = torch.device(device or "cpu")
    n = resolution ** 3
    occ = []
    for start in range(0, n, chunk):
        flat = torch.arange(start, start + chunk, device=device)
        flat = torch.where(flat < n, flat, torch.zeros_like(flat))
        pts = flat_to_world(flat, resolution, b_min, b_max)
        occ.append(query_fn(pts[None])[0, :, 0])
    return torch.cat(occ)[:n].reshape(resolution, resolution, resolution)
