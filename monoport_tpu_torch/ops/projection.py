"""Calibrated point projection (port of ``monoport_tpu/ops/projection.py``).

Point-major convention: points are [B, N, 3]; calibrations [B, 3, 4] or
[B, 4, 4] (extra row ignored); transforms optional [B, 2, 3] image-space
affines. The JAX side pins ``Precision.HIGHEST``: here the products are
plain f32 multiply-adds, which no TF32 setting touches.
"""

from __future__ import annotations

import torch


def _affine(points: torch.Tensor, mat: torch.Tensor,
            shift: torch.Tensor) -> torch.Tensor:
    # explicit f32 multiply-adds over the tiny inner dim: the projected
    # coords feed grid sampling, where a reduced-precision product shifts taps
    out = shift[:, None, :]
    for j in range(mat.shape[-1]):
        out = out + mat[:, None, :, j] * points[..., j:j + 1]
    return out


def orthogonal(points: torch.Tensor, calibrations: torch.Tensor,
               transforms: torch.Tensor | None = None) -> torch.Tensor:
    """Orthographic projection: [B,N,3] x [B,3,4] -> [B,N,3]."""
    xyz = _affine(points, calibrations[:, :3, :3], calibrations[:, :3, 3])
    if transforms is not None:
        xy = _affine(xyz[..., :2], transforms[:, :2, :2], transforms[:, :2, 2])
        xyz = torch.cat([xy, xyz[..., 2:3]], dim=-1)
    return xyz


def perspective(points: torch.Tensor, calibrations: torch.Tensor,
                transforms: torch.Tensor | None = None) -> torch.Tensor:
    """Perspective projection with z-divide."""
    homo = _affine(points, calibrations[:, :3, :3], calibrations[:, :3, 3])
    xy = homo[..., :2] / homo[..., 2:3]
    if transforms is not None:
        xy = _affine(xy, transforms[:, :2, :2], transforms[:, :2, 2])
    return torch.cat([xy, homo[..., 2:3]], dim=-1)


PROJECTIONS = {"orthogonal": orthogonal, "perspective": perspective}
