"""Depth (z) feature normalizer, scalar form (port of
``monoport_tpu/models/normalizers/depth_normalizer.py``).

Only the scalar ``z * scale`` form is ported: the frontal ray queries
require it. The soft-onehot variant raises until a later slice needs it.
"""

from __future__ import annotations

import torch


class DepthNormalizer:
    """Stateless z-feature normalizer (no parameters)."""

    def __init__(self, soft_onehot: bool = False, soft_dim: int = 64,
                 scale: float = 512 // 2 / 200.0):
        if soft_onehot:
            raise NotImplementedError(
                "soft-onehot z features are not ported yet (ROADMAP queue 1)")
        self.soft_onehot = False
        self.soft_dim = soft_dim
        self.scale = scale

    def __call__(self, z: torch.Tensor) -> torch.Tensor:
        return z * self.scale


def PIFuNomalizer(opt=None) -> DepthNormalizer:
    """Factory with the reference defaults."""
    opt = opt or {}
    return DepthNormalizer(soft_onehot=opt.get("soft_onehot", False),
                           soft_dim=opt.get("soft_dim", 64),
                           scale=opt.get("scale", 512 // 2 / 200.0))
