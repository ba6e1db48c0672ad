"""Depth (z) feature normalizer (port of
``monoport_tpu/models/normalizers/depth_normalizer.py``).

The scalar form returns ``z * scale`` in z's own shape; the soft-onehot
form takes z as [..., 1] and returns [..., soft_dim]: weight
1 - |z_norm - i| on the two bins around z_norm (the ray queries require
the scalar form).
"""

from __future__ import annotations

import torch


class DepthNormalizer:
    """Stateless z-feature normalizer (no parameters)."""

    def __init__(self, soft_onehot: bool = False, soft_dim: int = 64,
                 scale: float = 512 // 2 / 200.0):
        self.soft_onehot = soft_onehot
        self.soft_dim = soft_dim
        self.scale = scale

    def __call__(self, z: torch.Tensor) -> torch.Tensor:
        if not self.soft_onehot:
            return z * self.scale
        soft_dim = self.soft_dim
        z_norm = (torch.clamp(z[..., 0], -1.0, 1.0) + 1.0) / 2.0 * (
            soft_dim - 1)
        z_floor = torch.floor(z_norm)
        z_ceil = torch.ceil(z_norm)
        floor_val = 1.0 - (z_norm - z_floor)
        ceil_val = 1.0 - (z_ceil - z_norm)
        # one-hot by comparison with the bins, not ``F.one_hot``: a NaN z
        # (depth_peel's 0/0 on a colour query) then gives a NaN feature, as
        # in JAX, where ``F.one_hot`` raises on the CPU and asserts on the
        # card; and the card needs no range check
        bins = torch.arange(soft_dim, dtype=z_norm.dtype, device=z.device)
        onehot_floor = (z_floor[..., None] == bins).to(z.dtype)
        onehot_ceil = (z_ceil[..., None] == bins).to(z.dtype)
        # torch scatter overwrites: when floor == ceil the ceil write wins
        # (the reference's DepthNormalizer.py:29-30), so the floor adds
        # nothing there
        same = (z_floor == z_ceil)[..., None]
        return (torch.where(same, 0.0, onehot_floor * floor_val[..., None])
                + onehot_ceil * ceil_val[..., None])


def PIFuNomalizer(opt=None) -> DepthNormalizer:
    """Factory with the reference defaults."""
    opt = opt or {}
    return DepthNormalizer(soft_onehot=opt.get("soft_onehot", False),
                           soft_dim=opt.get("soft_dim", 64),
                           scale=opt.get("scale", 512 // 2 / 200.0))
