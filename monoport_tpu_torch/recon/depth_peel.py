"""Surface maps, normal shading, per-point colouring and display resize
(port of ``monoport_tpu/recon/depth_peel.py`` without ``depth_peel``).

The dense-volume ``depth_peel`` comes with the dense/hierarchy slice
(ROADMAP queue 1 item 8).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.constants import device_constant, float_array
from ..ops.resize import resize_axis


class SurfaceMaps(NamedTuple):
    depth: torch.Tensor    # [R, R] float voxel-space depth along the ray
    normal: torch.Tensor   # [R, R, 3] unit normals
    valid: torch.Tensor    # [R, R] bool — ray hit the surface


def shade_normal(maps: SurfaceMaps) -> torch.Tensor:
    """Normal-colored canvas [R, R, 3]; white background."""
    color = torch.clamp((maps.normal + 1.0) * 0.5, 0.0, 1.0)
    return torch.where(maps.valid[..., None], color,
                       torch.ones_like(color))


def surface_world_points(maps: SurfaceMaps, resolution: int,
                         b_min=(-1.0, -1.0, -1.0),
                         b_max=(1.0, 1.0, 1.0)) -> torch.Tensor:
    """World coords of every (a, b) surface pixel -> [R*R, 3]:
    world = b_min + (length / R) * (X, Y, R - Z)."""
    r = resolution
    dev = maps.depth.device
    a = torch.arange(r, dtype=torch.float32, device=dev)
    vox = torch.stack([a[:, None].expand(r, r), a[None, :].expand(r, r),
                       float(r) - maps.depth], dim=-1).reshape(-1, 3)
    lo = device_constant(float_array, (tuple(b_min),), dev, torch.float32)
    hi = device_constant(float_array, (tuple(b_max),), dev, torch.float32)
    return vox * (hi - lo) / r + lo


def colorize(maps: SurfaceMaps, query_color_fn, resolution: int,
             b_min=(-1.0, -1.0, -1.0),
             b_max=(1.0, 1.0, 1.0)) -> torch.Tensor:
    """Textured canvas [R, R, 3], white background.
    ``query_color_fn(points [1, N, 3]) -> [1, N, 3]`` in [-1, 1]."""
    pts = surface_world_points(maps, resolution, b_min, b_max)
    color = query_color_fn(pts[None])[0].float() * 0.5 + 0.5
    color = color.reshape(resolution, resolution, 3)
    return torch.where(maps.valid[..., None], color, torch.ones_like(color))


def visualize(canvas: torch.Tensor, render_size: int = 256):
    """rot90 + nearest resize (explicit floor(i*in/out) index) + background
    mask -> (image [S, S, 3] in [0, 1], mask [S, S, 1] bool)."""
    img = torch.rot90(canvas, 1, dims=(0, 1))
    img = resize_axis(img, 0, render_size, "nearest")
    img = resize_axis(img, 1, render_size, "nearest")
    bg = (img >= 1.0).all(dim=-1, keepdim=True)
    return img, ~bg
