"""Johnson-style ResNet generator, the netC backbone (port of
``monoport_tpu/models/backbones/resnet.py``).

Reflect padding + 7x7 stem, two stride-2 downsamples, ``n_blocks`` ResNet
blocks at 256 channels (the last block has no second norm), GroupNorm(32),
convolutions without bias. NHWC in and out; NCHW inside.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .hourglass import conv, make_norm


def _reflect_pad(x: torch.Tensor, p: int) -> torch.Tensor:
    return F.pad(x, (p, p, p, p), mode="reflect")


class ResnetBlock(nn.Module):
    def __init__(self, dim: int, norm: str = "group", use_bias: bool = False,
                 last: bool = False):
        super().__init__()
        self.last = last
        self.conv1 = conv(dim, dim, 3, bias=use_bias)
        self.norm1 = make_norm(norm, dim)
        self.conv2 = conv(dim, dim, 3, bias=use_bias)
        if not last:
            self.norm2 = make_norm(norm, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.norm1(self.conv1(_reflect_pad(x, 1))))
        y = self.conv2(_reflect_pad(y, 1))
        if not self.last:
            y = self.norm2(y)
        return x + y


class ResnetFilter(nn.Module):
    """[B, H, W, 3] -> [([B, H/4, W/4, ngf*4],)]."""

    def __init__(self, ngf: int = 64, n_blocks: int = 6, norm: str = "group",
                 use_bias: bool = False, use_tanh: bool = False):
        super().__init__()
        self.use_tanh = use_tanh
        self.n_blocks = n_blocks
        self.conv_stem = conv(3, ngf, 7, bias=use_bias)
        self.norm_stem = make_norm(norm, ngf)
        for i in range(2):
            mult = 2 ** i
            self.add_module(f"down{i}_conv", conv(ngf * mult, ngf * mult * 2,
                                                  3, stride=2, pad=1,
                                                  bias=use_bias))
            self.add_module(f"down{i}_norm", make_norm(norm, ngf * mult * 2))
        for i in range(n_blocks):
            self.add_module(f"block{i}", ResnetBlock(
                ngf * 4, norm, use_bias, last=(i == n_blocks - 1)))

    def forward(self, x: torch.Tensor) -> list[tuple[torch.Tensor, ...]]:
        x = x.permute(0, 3, 1, 2)
        x = F.relu(self.norm_stem(self.conv_stem(_reflect_pad(x, 3))))
        for i in range(2):
            x = F.relu(getattr(self, f"down{i}_norm")(
                getattr(self, f"down{i}_conv")(x)))
        for i in range(self.n_blocks):
            x = getattr(self, f"block{i}")(x)
        if self.use_tanh:
            x = torch.tanh(x)
        return [(x.permute(0, 2, 3, 1),)]


def PIFuResBlkFilters(opt=None) -> ResnetFilter:
    opt = opt or {}
    return ResnetFilter(use_tanh=opt.get("use_tanh", False),
                        norm=opt.get("norm", "group"))
