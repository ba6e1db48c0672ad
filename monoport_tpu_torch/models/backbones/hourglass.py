"""Stacked-hourglass image encoder, the netG backbone (port of
``monoport_tpu/models/backbones/hourglass.py``).

7x7/s2 stem, ConvBlocks with average-pool (or, ``hg_down`` ``conv64`` /
``conv128``, strided-conv) downsampling, ``num_stack`` hourglasses at 256
channels with intermediate heads. Parity points: hourglass upsampling is
bicubic align_corners=True through the shared interpolation matrices
(ops/resize.py); GroupNorm(32, eps=1e-5); the ConvBlock is the 3-way
split-channel residual. Module and parameter names follow the flax tree so
``weights.torch_state_from_flax`` is a rename.

``make_norm`` is the norm of every backbone: GroupNorm, or ``BatchNorm``
with flax's running-stat update (the converted reference HRNet / Yolov4
weights use BatchNorm, HRNetFilters.py:10).

The public ``forward`` takes NHWC images and returns NHWC feature maps;
inside, the convolutions run NCHW.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops.resize import interpolate_nchw


def adaptive_groups(channels: int, max_groups: int = 32) -> int:
    """Largest divisor of ``channels`` that is <= max_groups."""
    for g in range(min(max_groups, channels), 0, -1):
        if channels % g == 0:
            return g
    return 1


class BatchNorm(nn.BatchNorm2d):
    """flax ``nn.BatchNorm(epsilon=1e-5, momentum=0.9)`` as a BatchNorm2d
    (eps 1e-5, momentum 0.1; the same state_dict).

    ``use_running_average`` (norm 'batch') reads the running stats in
    either mode. Otherwise (norm 'batch_train') train mode normalizes by
    the batch's statistics and updates the running ones, and eval mode
    reads them (``eval_net``). The update is flax's: the batch variance is
    E[x^2] - E[x]^2 (biased), where torch's own BatchNorm2d would put the
    unbiased variance into ``running_var`` and drift from flax's
    ``batch_stats``.

    Under ``batch_stats_over`` the batch's E[x] and E[x^2] are the means
    over a process group's ranks (a data-parallel step's global batch:
    every rank holds as many images), through a differentiable all-reduce,
    and every rank updates its running stats from the same values."""

    def __init__(self, channels: int, use_running_average: bool):
        super().__init__(channels, eps=1e-5, momentum=0.1)
        self.use_running_average = use_running_average
        self.stats_group = None        # (process group, its rank count)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.use_running_average or not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        dims = (0, 2, 3)
        mean = x.mean(dims)
        sq = (x * x).mean(dims)
        if self.stats_group is not None:
            from torch.distributed.nn.functional import all_reduce

            group, n = self.stats_group
            mean, sq = all_reduce(torch.stack([mean, sq]), group=group) / n
        var = torch.clamp(sq - mean * mean, min=0.0)
        with torch.no_grad():
            m = self.momentum
            self.running_mean.copy_((1 - m) * self.running_mean
                                    + m * mean.detach())
            self.running_var.copy_((1 - m) * self.running_var
                                   + m * var.detach())
            self.num_batches_tracked.add_(1)
        inv = torch.rsqrt(var + self.eps) * self.weight
        return ((x - mean[:, None, None]) * inv[:, None, None]
                + self.bias[:, None, None])


@contextlib.contextmanager
def batch_stats_over(net: nn.Module, group, ranks: int):
    """Inside, the train-mode ``BatchNorm`` layers of ``net`` average their
    batch statistics over ``group``'s ``ranks`` ranks (None: nothing
    changes)."""
    norms = [] if group is None else [
        m for m in net.modules() if isinstance(m, BatchNorm)]
    for m in norms:
        m.stats_group = (group, ranks)
    try:
        yield
    finally:
        for m in norms:
            m.stats_group = None


def make_norm(norm: str, channels: int, groups: int = 32) -> nn.Module:
    """'group': GroupNorm(``groups``) (each backbone has its own group
    rule: 32 in the hourglass and the ResNet, ``adaptive_groups`` in HRNet,
    min(32, channels) in Yolov4); 'batch': BatchNorm on running stats, for
    converted reference weights; 'batch_train': BatchNorm on batch
    statistics in train mode (``BatchNorm``)."""
    if norm == "group":
        return nn.GroupNorm(groups, channels, eps=1e-5)
    if norm in ("batch", "batch_train"):
        return BatchNorm(channels, use_running_average=norm == "batch")
    raise ValueError(f"unknown norm: {norm}")


def conv(cin: int, cout: int, k: int, stride: int = 1, pad: int = 0,
         bias: bool = True) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride=stride, padding=pad, bias=bias)


def upsample2x_bicubic_nchw(x: torch.Tensor) -> torch.Tensor:
    h, w = x.shape[-2:]
    return interpolate_nchw(x, (2 * h, 2 * w), "bicubic")


class ConvBlock(nn.Module):
    def __init__(self, in_planes: int, out_planes: int, norm: str = "group"):
        super().__init__()
        o = out_planes
        self.conv1 = conv(in_planes, o // 2, 3, pad=1, bias=False)
        self.conv2 = conv(o // 2, o // 4, 3, pad=1, bias=False)
        self.conv3 = conv(o // 4, o // 4, 3, pad=1, bias=False)
        self.bn1 = make_norm(norm, in_planes)
        self.bn2 = make_norm(norm, o // 2)
        self.bn3 = make_norm(norm, o // 4)
        self.project = in_planes != out_planes
        if self.project:
            self.bn4 = make_norm(norm, in_planes)
            self.downsample_conv = conv(in_planes, o, 1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out1 = self.conv1(F.relu(self.bn1(x)))
        out2 = self.conv2(F.relu(self.bn2(out1)))
        out3 = self.conv3(F.relu(self.bn3(out2)))
        out = torch.cat([out1, out2, out3], dim=1)
        residual = x
        if self.project:
            residual = self.downsample_conv(F.relu(self.bn4(x)))
        return out + residual


class HourGlass(nn.Module):
    def __init__(self, depth: int, features: int, norm: str = "group"):
        super().__init__()
        self.depth = depth
        f = features
        for level in range(depth, 0, -1):
            self.add_module(f"b1_{level}", ConvBlock(f, f, norm))
            self.add_module(f"b2_{level}", ConvBlock(f, f, norm))
            if level == 1:
                self.add_module("b2_plus_1", ConvBlock(f, f, norm))
            self.add_module(f"b3_{level}", ConvBlock(f, f, norm))

    def _recurse(self, level: int, inp: torch.Tensor) -> torch.Tensor:
        up1 = getattr(self, f"b1_{level}")(inp)
        low1 = getattr(self, f"b2_{level}")(F.avg_pool2d(inp, 2, 2))
        if level > 1:
            low2 = self._recurse(level - 1, low1)
        else:
            low2 = self.b2_plus_1(low1)
        low3 = getattr(self, f"b3_{level}")(low2)
        return up1 + upsample2x_bicubic_nchw(low3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._recurse(self.depth, x)


class HGFilter(nn.Module):
    """Multi-stage hourglass encoder: [B, H, W, 3] -> list of per-stage
    single-level tuples [([B, H/4, W/4, hourglass_dim],), ...]."""

    def __init__(self, num_stack: int = 4, num_hourglass: int = 2,
                 hourglass_dim: int = 256, norm: str = "group",
                 hg_down: str = "ave_pool"):
        super().__init__()
        if hg_down not in ("ave_pool", "conv64", "conv128"):
            raise ValueError(f"unknown hg_down: {hg_down}")
        self.num_stack = num_stack
        self.hg_down = hg_down
        self.conv1 = conv(3, 64, 7, stride=2, pad=3)
        self.bn1 = make_norm(norm, 64)
        c2 = 64 if hg_down == "conv64" else 128
        self.conv2 = ConvBlock(64, c2, norm)
        if hg_down != "ave_pool":
            self.down_conv2 = conv(c2, 128, 3, stride=2, pad=1)
        self.conv3 = ConvBlock(128, 128, norm)
        self.conv4 = ConvBlock(128, 256, norm)
        for i in range(num_stack):
            self.add_module(f"m{i}", HourGlass(num_hourglass, 256, norm))
            self.add_module(f"top_m_{i}", ConvBlock(256, 256, norm))
            self.add_module(f"conv_last{i}", conv(256, 256, 1))
            self.add_module(f"bn_end{i}", make_norm(norm, 256))
            self.add_module(f"l{i}", conv(256, hourglass_dim, 1))
            if i < num_stack - 1:
                self.add_module(f"bl{i}", conv(256, 256, 1))
                self.add_module(f"al{i}", conv(hourglass_dim, 256, 1))

    def forward(self, x: torch.Tensor) -> list[tuple[torch.Tensor, ...]]:
        x = x.permute(0, 3, 1, 2)
        x = F.relu(self.bn1(self.conv1(x)))
        if self.hg_down == "ave_pool":
            x = F.avg_pool2d(self.conv2(x), 2, 2)
        else:
            x = self.down_conv2(self.conv2(x))
        x = self.conv4(self.conv3(x))
        previous = x
        outputs = []
        for i in range(self.num_stack):
            hg = getattr(self, f"m{i}")(previous)
            ll = getattr(self, f"top_m_{i}")(hg)
            ll = F.relu(getattr(self, f"bn_end{i}")(
                getattr(self, f"conv_last{i}")(ll)))
            tmp_out = getattr(self, f"l{i}")(ll)
            outputs.append((tmp_out.permute(0, 2, 3, 1),))
            if i < self.num_stack - 1:
                previous = (previous + getattr(self, f"bl{i}")(ll)
                            + getattr(self, f"al{i}")(tmp_out))
        return outputs


def PIFuHGFilters(opt=None) -> HGFilter:
    opt = opt or {}
    return HGFilter(num_stack=opt.get("num_stack", 4),
                    num_hourglass=opt.get("num_hourglass", 2),
                    hourglass_dim=opt.get("hourglass_dim", 256),
                    norm=opt.get("norm", "group"),
                    hg_down=opt.get("hg_down", "ave_pool"))
