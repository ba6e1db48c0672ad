"""Visible-surface extraction by depth peeling, normal shading, per-point
colouring and display resize (port of ``monoport_tpu/recon/depth_peel.py``).

``depth_peel`` reduces a dense volume vol[i=z, j=y, k=x] (``recon/dense.py``)
along the view ray to a depth map, a normal map and a validity mask: the
first hit of a ray is the largest occupied index along the volume's leading
axis, so no 3D transpose is made. The "front" viewer looks along -z from
z = +1.
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


def _orient(vol: torch.Tensor, direction: str) -> torch.Tensor:
    """The volume as the ``direction`` viewer sees it from the front."""
    if direction == "front":
        return vol
    if direction == "left":
        return vol.permute(2, 1, 0)
    if direction == "back":
        return vol.flip(0)
    if direction == "right":
        return vol.flip(0).permute(2, 1, 0)
    raise ValueError(direction)


def depth_peel(vol: torch.Tensor, direction: str = "front",
               balance_value: float = 0.5) -> SurfaceMaps:
    """First-hit surface of vol [R, R, R] along the view ray.

    A ray with no occupied voxel is invalid; its depth and its 0/0 normal
    are whatever the formulas give at index 0 (NaN normals included) and
    are masked by ``valid``."""
    r = vol.shape[0]
    vol = _orient(vol, direction)

    # the ray enters at i = R-1 (c = 0): the first hit is the largest
    # occupied i. The weights are i + 1 where occupied, so their maximum
    # less one is that index, and 0 on a ray with no hit (``argmax``
    # promises no index among ties)
    occupied = vol > balance_value                          # [i, j, k]
    weights = occupied * torch.arange(
        1, r + 1, dtype=torch.int32, device=vol.device)[:, None, None]
    top = weights.amax(dim=0)                               # [j, k]
    valid_jk = top > 0
    i1 = torch.clamp(top - 1, min=0).long()
    c1 = (r - 1) - i1
    c2 = torch.clamp(c1 - 2, 0, r)
    i2 = (r - 1) - c2

    def take0(s, i):
        return torch.gather(s, 0, i[None])[0].float()

    v1 = take0(vol, i1)
    v2 = take0(vol, i2)
    # sub-voxel crossing of the iso-level between c2 and c1
    z = (c2.float() * (balance_value - v1)
         + c1.float() * (v2 - balance_value)) / (v2 - v1)
    z = torch.clamp(z, 0.0, float(r))

    # normals from 2-voxel backward differences at the hit, clamped to
    # the edge: v3 = vol[i1, j-2, k], v4 = vol[i1, j, k-2]. Only the hit
    # plane is read, so the shift goes into the gather's indices and no
    # shifted copy of the volume is made
    ar = torch.arange(r, device=vol.device)
    back = torch.clamp(ar - 2, min=0)
    v3 = vol[i1, back[:, None], ar[None, :]].float()
    v4 = vol[i1, ar[:, None], back[None, :]].float()
    norm = torch.stack([v4 - v1, v3 - v1, v2 - v1], dim=-1)
    norm = norm / torch.linalg.vector_norm(norm, dim=-1, keepdim=True)

    # outputs are indexed [a = x, b = y]: transpose the 2D maps
    return SurfaceMaps(depth=z.t(), normal=norm.transpose(0, 1),
                       valid=valid_jk.t())


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
