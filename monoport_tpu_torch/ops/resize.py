"""Image and volume resampling as dense per-axis matrices (port of
``monoport_tpu/ops/resize.py``).

The interpolation matrices are built in numpy exactly as the JAX package
builds them (bicubic a=-0.75 with border clamp, torch ``F.interpolate``
source coordinates), so both packages resample with the same weights.
Public functions take NHWC tensors; ``resize_axis`` works on any axis.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .constants import device_constant


def _source_coords(out_size: int, in_size: int,
                   align_corners: bool) -> np.ndarray:
    """Continuous source coordinate for each output index (torch rule)."""
    i = np.arange(out_size, dtype=np.float64)
    if in_size == 1:
        return np.zeros(out_size, dtype=np.float64)
    if align_corners:
        if out_size == 1:
            return np.zeros(out_size, dtype=np.float64)
        return i * (in_size - 1) / (out_size - 1)
    return (i + 0.5) * in_size / out_size - 0.5


def _cubic_weight(t: np.ndarray, a: float = -0.75) -> np.ndarray:
    """Cubic convolution kernel (Keys, a=-0.75)."""
    at = np.abs(t)
    f1 = ((a + 2.0) * at - (a + 3.0)) * at * at + 1.0
    f2 = ((a * at - 5.0 * a) * at + 8.0 * a) * at - 4.0 * a
    return np.where(at <= 1.0, f1, np.where(at < 2.0, f2, 0.0))


def _resize_matrix(in_size: int, out_size: int, mode: str,
                   align_corners: bool) -> np.ndarray:
    """Dense [out_size, in_size] interpolation matrix for one axis."""
    src = _source_coords(out_size, in_size, align_corners)
    mat = np.zeros((out_size, in_size), dtype=np.float64)
    rows = np.arange(out_size)
    x0 = np.floor(src).astype(np.int64)
    if mode == "bilinear":
        frac = src - x0
        for tap, w in ((x0, 1.0 - frac), (x0 + 1, frac)):
            np.add.at(mat, (rows, np.clip(tap, 0, in_size - 1)), w)
    elif mode == "bicubic":
        for k in range(-1, 3):
            tap = x0 + k
            # out-of-range taps clamp to the border (replication)
            np.add.at(mat, (rows, np.clip(tap, 0, in_size - 1)),
                      _cubic_weight(src - tap))
    else:
        raise ValueError(f"unknown interpolation mode: {mode}")
    return mat.astype(np.float32)


def nearest_index(in_size: int, out_size: int) -> np.ndarray:
    """torch 'nearest' source index: floor(i * in / out)."""
    return np.floor(np.arange(out_size, dtype=np.float64) * in_size
                    / out_size).astype(np.int64)


def resize_axis(x: torch.Tensor, axis: int, out_size: int, mode: str,
                align_corners: bool = True) -> torch.Tensor:
    """Resize one axis of ``x`` (explicit nearest index or a dense matmul)."""
    in_size = x.shape[axis]
    if in_size == out_size and mode != "bicubic":
        return x
    if mode == "nearest":
        idx = device_constant(nearest_index, (in_size, out_size), x.device,
                              torch.int64)
        return torch.index_select(x, axis, idx)
    mat = device_constant(_resize_matrix,
                          (in_size, out_size, mode, align_corners), x.device,
                          x.dtype)
    moved = torch.movedim(x, axis, -1)
    return torch.movedim(torch.matmul(moved, mat.t()), -1, axis)


def interpolate_2d(x: torch.Tensor, size: tuple[int, int],
                   mode: str = "bilinear",
                   align_corners: bool = True) -> torch.Tensor:
    """NHWC resize with ``F.interpolate`` semantics."""
    x = resize_axis(x, 1, size[0], mode, align_corners)
    return resize_axis(x, 2, size[1], mode, align_corners)


def interpolate_nchw(x: torch.Tensor, size: tuple[int, int],
                     mode: str = "bilinear",
                     align_corners: bool = True) -> torch.Tensor:
    """``interpolate_2d`` of an NCHW tensor (inside the backbones)."""
    x = resize_axis(x, 2, size[0], mode, align_corners)
    return resize_axis(x, 3, size[1], mode, align_corners)


def upsample2x_bicubic(x: torch.Tensor) -> torch.Tensor:
    """2x bicubic upsample of NHWC, align_corners=True."""
    _, h, w, _ = x.shape
    return interpolate_2d(x, (h * 2, w * 2), "bicubic", align_corners=True)


def interpolate_3d(vol: torch.Tensor, size: tuple[int, int, int],
                   mode: str = "bilinear",
                   align_corners: bool = True) -> torch.Tensor:
    """Separable volume resize of [..., D, H, W] grids (exact on nested
    2^k+1 grids under align_corners=True): the hierarchical evaluator's
    upsampling."""
    vol = resize_axis(vol, -3, size[0], mode, align_corners)
    vol = resize_axis(vol, -2, size[1], mode, align_corners)
    return resize_axis(vol, -1, size[2], mode, align_corners)


def avg_pool_2d(x: torch.Tensor, window: int = 2,
                stride: int | None = None) -> torch.Tensor:
    """NHWC average pooling (``F.avg_pool2d``, VALID windows)."""
    out = F.avg_pool2d(x.permute(0, 3, 1, 2), window, stride or window)
    return out.permute(0, 2, 3, 1)
