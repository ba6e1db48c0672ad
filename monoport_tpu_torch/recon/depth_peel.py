"""Surface maps, normal shading and display resize (port of the frontal
parts of ``monoport_tpu/recon/depth_peel.py``).

The dense-volume ``depth_peel`` and per-point ``colorize`` come with the
dense/hierarchy slice (ROADMAP queue 1 item 8).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

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


def visualize(canvas: torch.Tensor, render_size: int = 256):
    """rot90 + nearest resize (explicit floor(i*in/out) index) + background
    mask -> (image [S, S, 3] in [0, 1], mask [S, S, 1] bool)."""
    img = torch.rot90(canvas, 1, dims=(0, 1))
    img = resize_axis(img, 0, render_size, "nearest")
    img = resize_axis(img, 1, render_size, "nearest")
    bg = (img >= 1.0).all(dim=-1, keepdim=True)
    return img, ~bg
