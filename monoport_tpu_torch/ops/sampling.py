"""Pixel-aligned feature sampling (port of ``monoport_tpu/ops/sampling.py``).

Bilinear sampling with ``align_corners=True`` and zeros padding of NHWC
features [B, H, W, C] at point-major coords [B, N, 2] (``u`` indexes W,
``v`` indexes H). ``index_grid`` is the separable form for outer-product
lattices: two dense products, which the JAX package also leaves to the
compiler.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def grid_sample_2d(feat: torch.Tensor, uv: torch.Tensor,
                   align_corners: bool = True) -> torch.Tensor:
    """[B, H, W, C] sampled at [B, N, 2] normalized coords -> [B, N, C]."""
    grid = uv.to(feat.dtype)[:, None]                      # [B, 1, N, 2]
    out = F.grid_sample(feat.permute(0, 3, 1, 2), grid, mode="bilinear",
                        padding_mode="zeros", align_corners=align_corners)
    return out[:, :, 0].transpose(1, 2)                    # [B, N, C]


def index(feat: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """PIFu ``index``: sample [B,H,W,C] at [B,N,2] -> [B,N,C]."""
    return grid_sample_2d(feat, uv, align_corners=True)


def bilinear_rows(pos_ndc: torch.Tensor, size: int) -> torch.Tensor:
    """[..., N] normalized positions -> [..., N, size] interpolation rows
    (align_corners=True; the hat function is zeros padding: a tap outside
    the grid has no column)."""
    x = (pos_ndc.float() + 1.0) * 0.5 * (size - 1)
    j = torch.arange(size, dtype=torch.float32, device=pos_ndc.device)
    return torch.clamp(1.0 - torch.abs(x[..., None] - j), min=0.0)


def index_grid(feat: torch.Tensor, u_ndc: torch.Tensor,
               v_ndc: torch.Tensor) -> torch.Tensor:
    """Separable ``index`` at the outer product u_ndc [B, Nu] (W axis) x
    v_ndc [B, Nv] (H axis) of [B, H, W, C] -> [B, Nu, Nv, C]."""
    _, h, w, _ = feat.shape
    wx = bilinear_rows(u_ndc, w).to(feat.dtype)           # [B, Nu, W]
    wy = bilinear_rows(v_ndc, h).to(feat.dtype)           # [B, Nv, H]
    rows = torch.einsum("bnh,bhwc->bnwc", wy, feat)       # [B, Nv, W, C]
    return torch.einsum("buw,bnwc->bunc", wx, rows)       # [B, Nu, Nv, C]
