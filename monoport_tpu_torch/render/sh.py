"""Spherical-harmonics shading, 2nd order, 9 coefficients (port of
``monoport_tpu/render/sh.py``): the irradiance basis of the SH render pass,
the real SH basis, the exact 9x9 rotation of SH coefficients (least squares
over rotated sample directions; exact because SH bands are closed under
rotation) and the irradiance of a [9, 3] environment. The bases take torch
tensors or numpy arrays."""

from __future__ import annotations

import numpy as np
import torch

_C1, _C2, _C3, _C4, _C5 = 0.429043, 0.511664, 0.743125, 0.886227, 0.247708


def _stack(like):
    return torch.stack if isinstance(like, torch.Tensor) else np.stack


def evaluate_irradiance_basis(normals):
    """[..., 3] unit normals -> [..., 9] irradiance basis H."""
    x, y, z = normals[..., 0], normals[..., 1], normals[..., 2]
    one = x * 0 + 1.0
    return _stack(normals)([
        _C4 * one,
        2.0 * _C2 * y,
        2.0 * _C2 * z,
        2.0 * _C2 * x,
        2.0 * _C1 * x * y,
        2.0 * _C1 * y * z,
        _C3 * z * z - _C5,
        2.0 * _C1 * z * x,
        _C1 * (x * x - y * y),
    ], -1)


def evaluate_sh_basis(dirs):
    """Real SH basis Y_lm up to l=2: [..., 3] -> [..., 9]."""
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    one = x * 0 + 1.0
    return _stack(dirs)([
        0.282095 * one,
        -0.488603 * y,
        0.488603 * z,
        -0.488603 * x,
        1.092548 * x * y,
        -1.092548 * y * z,
        0.315392 * (3 * z * z - 1),
        -1.092548 * x * z,
        0.546274 * (x * x - y * y),
    ], -1)


def _fibonacci_dirs(n: int) -> torch.Tensor:
    i = torch.arange(n, dtype=torch.float64) + 0.5
    phi = torch.arccos(1 - 2 * i / n)
    theta = np.pi * (1 + 5 ** 0.5) * i
    return torch.stack([torch.sin(phi) * torch.cos(theta),
                        torch.sin(phi) * torch.sin(theta),
                        torch.cos(phi)], -1)


def sh_rotation_matrix(rot) -> torch.Tensor:
    """Exact 9x9 SH rotation (f64, on the CPU) for a 3x3 rotation: solve
    B(d) R_sh = B(R d) over sample directions; coeffs' = R_sh @ coeffs."""
    dirs = _fibonacci_dirs(128)
    rot = torch.as_tensor(np.asarray(rot, np.float64))
    basis = evaluate_sh_basis(dirs)                   # [N, 9]
    basis_rot = evaluate_sh_basis(dirs @ rot.T)
    return torch.linalg.lstsq(basis, basis_rot).solution.T


def shade_sh(normals: torch.Tensor, sh_coeffs) -> torch.Tensor:
    """Irradiance from [9, 3] environment coefficients: [..., 3] normals ->
    [..., 3] rgb."""
    h = evaluate_irradiance_basis(normals)            # [..., 9]
    return h @ torch.as_tensor(np.asarray(sh_coeffs, np.float32),
                               device=normals.device)
