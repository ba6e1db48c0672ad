"""Per-ray surface localization — the frontal real-time path (port of the
frontal branches of ``monoport_tpu/recon/ray_refine.py``).

``ray_pyramid`` runs a dense first-crossing march at a coarse level, then
refines through the remaining levels and finally ``fine_res`` inside an
optional subject-bbox window. Each pass queries T z-taps per ray through
the grid-structured query (separable sampling + the fused ray MLP), the
ray-structured query, or a per-point ``query_fn``. All of it is 2D map
work on ``[R, R]`` tensors; no 3D volume exists.

The compacted (rotated-view) branches come with the rotated slice
(ROADMAP queue 1 item 7) and raise here.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch

from ..ops.constants import device_constant, float_array
from ..ops.resize import interpolate_2d
from .depth_peel import SurfaceMaps


def _f32(x, device) -> torch.Tensor:
    return device_constant(float_array, (tuple(x),), device, torch.float32)


def _tap_offsets(pad: int, taps: int) -> np.ndarray:
    return np.linspace(-pad, pad + 1, taps).astype(np.float32)


def _first_crossing(vals: torch.Tensor, c_taps: torch.Tensor,
                    balance_value: float):
    """First iso-crossing along the tap axis: vals/c_taps [..., T] ->
    (z sub-tap crossing depth, hit mask, v1, v2, c1, c2)."""
    taps = vals.shape[-1]
    occ = vals > balance_value
    hit = occ.any(dim=-1)
    weights = torch.arange(taps, 0, -1, dtype=torch.int32, device=vals.device)
    first = torch.argmax(occ.to(torch.int32) * weights, dim=-1)
    prev = torch.clamp(first - 1, min=0)

    def take(m, i):
        return torch.gather(m, -1, i[..., None])[..., 0]

    v1, v2 = take(vals, first), take(vals, prev)
    c1, c2 = take(c_taps, first), take(c_taps, prev)
    denom = v2 - v1
    z = (c2 * (balance_value - v1) + c1 * (v2 - balance_value)) / torch.where(
        torch.abs(denom) > 1e-12, denom, torch.ones_like(denom))
    return z, hit, v1, v2, c1, c2


def _refine_core(query_fn: Callable | None, depth_f: torch.Tensor,
                 valid_f: torch.Tensor, ax: torch.Tensor, by: torch.Tensor,
                 rf: int, taps: int, scale: float, balance_value: float,
                 b_min, b_max, spacing=(1.0, 1.0),
                 query_taps_fn: Callable | None = None,
                 query_grid_fn: Callable | None = None) -> SurfaceMaps:
    """Fine pass over the outer-product ray grid ax [H] x by [W] with the
    upsampled coarse maps depth_f/valid_f [H, W]; ``spacing`` is the ray
    pitch in fine units along each axis."""
    dev = depth_f.device
    pad = math.ceil(scale) + 1
    offsets = device_constant(_tap_offsets, (pad, taps), dev, torch.float32)
    b_min = _f32(b_min, dev)
    step = (_f32(b_max, dev) - b_min) / (rf - 1)
    h, w = depth_f.shape
    xw1 = ax * step[0] + b_min[0]                               # [H]
    yw1 = by * step[1] + b_min[1]                               # [W]

    c_taps = torch.clamp(depth_f[..., None] + offsets, 0.0, rf - 1)
    # vol index i = rf-1-c; world z from it
    wz = ((rf - 1) - c_taps) * step[2] + b_min[2]               # [H, W, T]
    vals = _query_lattice(query_fn, query_taps_fn, query_grid_fn, xw1, yw1,
                          wz)

    z, hit, v1, v2, c1, c2 = _first_crossing(vals, c_taps, balance_value)
    z = torch.clamp(z, 0.0, float(rf))
    # rays whose taps missed the surface fall back to the coarse depth
    z = torch.where(hit, z, depth_f)
    # the refined silhouette is the tap-verified one
    valid = hit & valid_f
    dvdz = (v1 - v2) / torch.clamp(c1 - c2, min=1e-6)
    return _normals_from_maps(z, dvdz, v2 - v1, valid, h, w, spacing)


def _query_lattice(query_fn, query_taps_fn, query_grid_fn, xw1, yw1, wz):
    """Occupancy at the lattice xw1 [H] x yw1 [W] x wz [H, W, T] -> [H, W, T]
    through the first query form given: grid, ray taps, per point."""
    h, w, taps = wz.shape
    if query_grid_fn is not None:
        return query_grid_fn(xw1, yw1, wz).float()
    if query_taps_fn is not None:
        xy = torch.stack([xw1[:, None].expand(h, w),
                          yw1[None, :].expand(h, w)], dim=-1)
        vals = query_taps_fn(xy.reshape(1, -1, 2), wz.reshape(1, -1, taps))
        return vals.reshape(h, w, taps).float()
    pts = torch.stack([xw1[:, None, None].expand(h, w, taps),
                       yw1[None, :, None].expand(h, w, taps), wz], dim=-1)
    return query_fn(pts.reshape(1, -1, 3))[0, :, 0].reshape(h, w, taps).float()


def _shift2(z: torch.Tensor, dim: int) -> torch.Tensor:
    """z[i - 2] along ``dim``, edge-clamped (2-sample backward difference)."""
    n = z.shape[dim]
    idx = torch.clamp(torch.arange(n, device=z.device) - 2, min=0)
    return torch.index_select(z, dim, idx)


def _normals_from_maps(z, dvdz, nz, valid, h, w, spacing) -> SurfaceMaps:
    # z-gradient from adjacent taps; x/y from neighbour-ray depth
    # differences: v(x-2) - v(x) at fixed c ~ (z(x-2) - z(x)) * dv/dc
    norm_x = (z - _shift2(z, 0)) * dvdz / spacing[0]
    norm_y = (z - _shift2(z, 1)) * dvdz / spacing[1]
    norm = torch.stack([norm_x, norm_y, nz], dim=-1)
    norm = norm / torch.clamp(torch.linalg.vector_norm(norm, dim=-1,
                                                       keepdim=True), min=1e-9)
    return SurfaceMaps(depth=z, normal=norm, valid=valid)


def _upsampled_coarse(coarse: SurfaceMaps, rf: int, scale: float):
    # valid-WEIGHTED bilinear upsample of the coarse depth: invalid coarse
    # pixels contribute zero weight instead of a zero depth
    v = coarse.valid.float()
    d = torch.nan_to_num(coarse.depth, nan=0.0) * v

    def up(img):
        return interpolate_2d(img[None, ..., None], (rf, rf),
                              "bilinear")[0, ..., 0]

    wsum = up(v)
    depth_f = torch.where(wsum > 1e-6, up(d) / torch.clamp(wsum, min=1e-6),
                          torch.zeros_like(wsum)) * scale
    return depth_f, wsum > 0.0


def refine_from_maps(query_fn: Callable | None, coarse: SurfaceMaps, rc: int,
                     fine_res: int, taps: int = 6,
                     balance_value: float = 0.5,
                     b_min=(-1.0, -1.0, -1.0), b_max=(1.0, 1.0, 1.0),
                     window: int | None = None,
                     query_taps_fn: Callable | None = None,
                     query_grid_fn: Callable | None = None,
                     compact: float | None = None) -> SurfaceMaps:
    """Fine pass from coarse per-ray maps (rc^2 grid, depth in rc-voxel
    units). ``window``: refine only a window^2 ray block spread over the
    subject's coarse bbox at stride >= 1; outside it the coarse maps stay."""
    if compact:
        raise NotImplementedError(
            "compacted refines belong to the rotated slice (ROADMAP queue 1 "
            "item 7)")
    rf = fine_res
    dev = coarse.depth.device
    scale = (rf - 1) / (rc - 1)
    depth_f, valid_f = _upsampled_coarse(coarse, rf, scale)

    if window is None or window >= rf:
        a = torch.arange(rf, dtype=torch.float32, device=dev)
        return _refine_core(query_fn, depth_f, valid_f, a, a, rf, taps,
                            scale, balance_value, b_min, b_max,
                            query_taps_fn=query_taps_fn,
                            query_grid_fn=query_grid_fn)

    x0, sx = _axis_window(coarse.valid.any(dim=1), rc, rf, scale, window)
    y0, sy = _axis_window(coarse.valid.any(dim=0), rc, rf, scale, window)
    ar_w = torch.arange(window, dtype=torch.float32, device=dev)
    aw = x0 + ar_w * sx
    bw = y0 + ar_w * sy
    d_w = _sample_grid(depth_f, aw, bw)
    v_w = _sample_grid(valid_f.float(), aw, bw) > 0.0
    maps_w = _refine_core(query_fn, d_w, v_w, aw, bw, rf, taps, scale,
                          balance_value, b_min, b_max, spacing=(sx, sy),
                          query_taps_fn=query_taps_fn,
                          query_grid_fn=query_grid_fn)

    # resample the refined window back onto the full fine grid (an exact
    # gather at stride 1); outside the window keep the coarse maps
    ar = torch.arange(rf, dtype=torch.float32, device=dev)
    u = (ar - x0) / sx
    v = (ar - y0) / sy
    inside = (((u >= 0) & (u <= window - 1))[:, None]
              & ((v >= 0) & (v <= window - 1))[None, :])
    uc = torch.clamp(u, 0.0, window - 1)
    vc = torch.clamp(v, 0.0, window - 1)
    depth = torch.where(inside, _sample_grid(maps_w.depth, uc, vc), depth_f)
    norm_fallback = torch.zeros(rf, rf, 3, device=dev)
    norm_fallback[..., 2] = -1.0
    norm_w = torch.stack([_sample_grid(maps_w.normal[..., k], uc, vc)
                          for k in range(3)], dim=-1)
    norm_w = norm_w / torch.clamp(torch.linalg.vector_norm(
        norm_w, dim=-1, keepdim=True), min=1e-9)
    norm = torch.where(inside[..., None], norm_w, norm_fallback)
    valid_w = _sample_grid(maps_w.valid.float(), uc, vc) > 0.5
    valid = torch.where(inside, valid_w, valid_f)
    return SurfaceMaps(depth=depth, normal=norm, valid=valid)


def _axis_window(any_valid: torch.Tensor, rc: int, rf: int, scale: float,
                 window: int):
    """Start (fine units, snapped to the stride lattice) and stride for one
    window axis, covering the subject's coarse-valid extent with margin.
    Both are 0-d device tensors: no host sync."""
    idx = torch.arange(rc, dtype=torch.float32, device=any_valid.device)
    lo = torch.where(any_valid, idx, torch.full_like(idx, float(rc))).min()
    hi = torch.where(any_valid, idx, torch.full_like(idx, -1.0)).max()
    has = hi >= lo
    lo = torch.where(has, lo, torch.zeros_like(lo))
    hi = torch.where(has, hi, torch.full_like(hi, rc - 1.0))
    margin = 1.5 * scale  # the crossing can sit +-1 coarse voxel out
    f_lo = torch.clamp(lo * scale - margin, min=0.0)
    f_hi = torch.clamp(hi * scale + margin, max=rf - 1.0)
    stride = torch.clamp((f_hi - f_lo) / (window - 1), min=1.0)
    center = (f_lo + f_hi) * 0.5
    start = center - stride * (window - 1) * 0.5
    start = torch.minimum(torch.clamp(start, min=0.0),
                          rf - 1 - stride * (window - 1))
    # an integer start when unstrided keeps the fit-in-window path an
    # exact gather
    start = torch.where(stride <= 1.0, torch.round(start), start)
    return start, stride


def ray_march(query_fn: Callable | None, res: int, balance_value: float = 0.5,
              b_min=(-1.0, -1.0, -1.0), b_max=(1.0, 1.0, 1.0),
              query_taps_fn: Callable | None = None,
              query_grid_fn: Callable | None = None,
              device=None) -> SurfaceMaps:
    """Dense first-crossing march: res^2 frontal rays x res z-taps ->
    SurfaceMaps with depth in res-voxel units."""
    device = torch.device(device or "cpu")
    b_min = _f32(b_min, device)
    step = (_f32(b_max, device) - b_min) / (res - 1)
    a = torch.arange(res, dtype=torch.float32, device=device)
    c_taps = a.expand(res, res, res)                          # [R, R, T]
    wz = ((res - 1) - c_taps) * step[2] + b_min[2]
    xw1 = a * step[0] + b_min[0]
    yw1 = a * step[1] + b_min[1]
    vals = _query_lattice(query_fn, query_taps_fn, query_grid_fn, xw1, yw1,
                          wz)
    z, hit, *_ = _first_crossing(vals, c_taps, balance_value)
    z = torch.where(hit, torch.clamp(z, 0.0, float(res)), torch.zeros_like(z))
    # coarse levels need no normals (the fine pass recomputes them)
    norm = torch.zeros(res, res, 3, device=device)
    norm[..., 2] = -1.0
    return SurfaceMaps(depth=z, normal=norm, valid=hit)


def ray_pyramid(query_fn: Callable | None, fine_res: int, levels=(33, 65),
                taps: int = 6, balance_value: float = 0.5,
                b_min=(-1.0, -1.0, -1.0), b_max=(1.0, 1.0, 1.0),
                window: int | None = None,
                query_taps_fn: Callable | None = None,
                query_grid_fn: Callable | None = None,
                device=None) -> SurfaceMaps:
    """Volume-free coarse-to-fine surface localization: dense march at
    levels[0], then ``refine_from_maps`` through the remaining levels and
    finally ``fine_res`` (with the optional bbox window)."""
    maps = ray_march(query_fn, levels[0], balance_value, b_min, b_max,
                     query_taps_fn=query_taps_fn, query_grid_fn=query_grid_fn,
                     device=device)
    for rc, rl in zip(levels[:-1], levels[1:]):
        maps = refine_from_maps(query_fn, maps, rc, rl, taps=taps,
                                balance_value=balance_value, b_min=b_min,
                                b_max=b_max, query_taps_fn=query_taps_fn,
                                query_grid_fn=query_grid_fn)
    return refine_from_maps(query_fn, maps, levels[-1], fine_res, taps=taps,
                            balance_value=balance_value, b_min=b_min,
                            b_max=b_max, window=window,
                            query_taps_fn=query_taps_fn,
                            query_grid_fn=query_grid_fn)


def _sample_grid(img: torch.Tensor, xi: torch.Tensor,
                 yi: torch.Tensor) -> torch.Tensor:
    """Separable bilinear sample of img [H, W] at the outer-product grid
    xi [h] x yi [w] (float indices, assumed in range) -> [h, w]."""
    h, w = img.shape
    x0 = torch.clamp(torch.floor(xi).long(), 0, h - 1)
    x1 = torch.clamp(x0 + 1, max=h - 1)
    fx = torch.clamp(xi - x0, 0.0, 1.0)
    rows = img[x0] * (1.0 - fx)[:, None] + img[x1] * fx[:, None]   # [h, W]
    y0 = torch.clamp(torch.floor(yi).long(), 0, w - 1)
    y1 = torch.clamp(y0 + 1, max=w - 1)
    fy = torch.clamp(yi - y0, 0.0, 1.0)
    return rows[:, y0] * (1.0 - fy)[None, :] + rows[:, y1] * fy[None, :]
