"""YOLOv4 (CSPDarknet53 + SPP + PAN) multi-scale encoder (port of
``monoport_tpu/models/backbones/yolov4.py``).

Mish-activated CSP downsample stages (1-2-8-8-4 residual blocks), an SPP
neck with a 5/9/13 max-pool pyramid, the PAN top-down path, and a 3-scale
head returning ``[(out0,), (out1,), (out2,)]``, 256 channels each at
strides 8, 16 and 32. GroupNorm here has min(32, channels) groups. Module
names follow the flax tree (``weights.torch_state_from_flax``); NHWC in and
out, NCHW inside.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops.resize import interpolate_nchw
from .hourglass import conv, make_norm


def mish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.tanh(F.softplus(x))


class ConvBnAct(nn.Module):
    def __init__(self, cin: int, ch: int, kernel: int, stride: int = 1,
                 act: str = "mish", bn: bool = True, bias: bool = False,
                 norm: str = "group"):
        super().__init__()
        self.conv = conv(cin, ch, kernel, stride, (kernel - 1) // 2,
                         bias=bias or not bn)
        self.bn = make_norm(norm, ch, min(32, ch)) if bn else None
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        if self.bn is not None:
            x = self.bn(x)
        if self.act == "mish":
            return mish(x)
        if self.act == "leaky":
            return F.leaky_relu(x, 0.1)
        return x  # linear


class ResBlock(nn.Module):
    def __init__(self, ch: int, nblocks: int, norm: str = "group"):
        super().__init__()
        self.nblocks = nblocks
        for i in range(nblocks):
            self.add_module(f"b{i}_conv1", ConvBnAct(ch, ch, 1, norm=norm))
            self.add_module(f"b{i}_conv2", ConvBnAct(ch, ch, 3, norm=norm))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.nblocks):
            x = x + getattr(self, f"b{i}_conv2")(
                getattr(self, f"b{i}_conv1")(x))
        return x


class DownSample1(nn.Module):
    def __init__(self, norm: str = "group"):
        super().__init__()
        c = lambda cin, ch, k, s=1: ConvBnAct(cin, ch, k, s, norm=norm)
        self.conv1 = c(3, 32, 3)
        self.conv2 = c(32, 64, 3, 2)
        self.conv3 = c(64, 64, 1)
        self.conv4 = c(64, 64, 1)
        self.conv5 = c(64, 32, 1)
        self.conv6 = c(32, 64, 3)
        self.conv7 = c(64, 64, 1)
        self.conv8 = c(128, 64, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x2 = self.conv2(self.conv1(x))
        x3 = self.conv3(x2)
        x4 = self.conv4(x2)
        x6 = self.conv6(self.conv5(x4)) + x4
        x7 = self.conv7(x6)
        return self.conv8(torch.cat([x7, x3], dim=1))


class DownSampleCSP(nn.Module):
    """DownSample2-5 share this CSP pattern (Yolov4Filters.py:132-229)."""

    def __init__(self, cin: int, ch: int, nblocks: int, norm: str = "group"):
        super().__init__()
        half = ch // 2
        c = lambda ci, co, k, s=1: ConvBnAct(ci, co, k, s, norm=norm)
        self.conv1 = c(cin, ch, 3, 2)
        self.conv2 = c(ch, half, 1)
        self.conv3 = c(ch, half, 1)
        self.res = ResBlock(half, nblocks, norm)
        self.conv4 = c(half, half, 1)
        self.conv5 = c(ch, ch, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x1 = self.conv1(x)
        x2 = self.conv2(x1)
        x4 = self.conv4(self.res(self.conv3(x1)))
        return self.conv5(torch.cat([x4, x2], dim=1))


def _maxpool(x: torch.Tensor, k: int) -> torch.Tensor:
    """k x k stride-1 max-pool over a -inf border (``reduce_window``)."""
    return F.max_pool2d(x, k, 1, k // 2)


def _up(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return interpolate_nchw(x, like.shape[-2:], "nearest")


class Neck(nn.Module):
    """SPP + PAN top-down (Yolov4Filters.py:232-313)."""

    # (input, output, kernel) of conv1..conv20
    SPEC = [(1024, 512, 1), (512, 1024, 3), (1024, 512, 1), (2048, 512, 1),
            (512, 1024, 3), (1024, 512, 1), (512, 256, 1), (512, 256, 1),
            (512, 256, 1), (256, 512, 3), (512, 256, 1), (256, 512, 3),
            (512, 256, 1), (256, 128, 1), (256, 128, 1), (256, 128, 1),
            (128, 256, 3), (256, 128, 1), (128, 256, 3), (256, 128, 1)]

    def __init__(self, norm: str = "group"):
        super().__init__()
        for k, (cin, ch, ks) in enumerate(self.SPEC, 1):
            self.add_module(f"conv{k}", ConvBnAct(cin, ch, ks, act="leaky",
                                                  norm=norm))

    def forward(self, d5, d4, d3):
        c = lambda k, x: getattr(self, f"conv{k}")(x)
        x3 = c(3, c(2, c(1, d5)))
        spp = torch.cat([_maxpool(x3, 13), _maxpool(x3, 9), _maxpool(x3, 5),
                         x3], dim=1)
        x6 = c(6, c(5, c(4, spp)))
        up = _up(c(7, x6), d4)
        x8 = torch.cat([c(8, d4), up], dim=1)
        x13 = c(13, c(12, c(11, c(10, c(9, x8)))))
        up2 = _up(c(14, x13), d3)
        x15 = torch.cat([c(15, d3), up2], dim=1)
        x20 = c(20, c(19, c(18, c(17, c(16, x15)))))
        return x20, x13, x6


class Yolov4Head(nn.Module):
    """3-scale output head (Yolov4Filters.py:316-378)."""

    # (input, output, kernel, stride) of the leaky ConvBnActs
    SPEC = {1: (128, 256, 3, 1), 3: (128, 256, 3, 2), 4: (512, 256, 1, 1),
            5: (256, 512, 3, 1), 6: (512, 256, 1, 1), 7: (256, 512, 3, 1),
            8: (512, 256, 1, 1), 9: (256, 512, 3, 1), 11: (256, 512, 3, 2),
            12: (1024, 512, 1, 1), 13: (512, 1024, 3, 1),
            14: (1024, 512, 1, 1), 15: (512, 1024, 3, 1),
            16: (1024, 512, 1, 1), 17: (512, 1024, 3, 1)}
    # the linear outputs: conv with a bias and no norm
    OUTS = {2: 256, 10: 512, 18: 1024}

    def __init__(self, output_ch: int = 256, norm: str = "group"):
        super().__init__()
        for k, (cin, ch, ks, s) in self.SPEC.items():
            self.add_module(f"conv{k}", ConvBnAct(cin, ch, ks, s,
                                                  act="leaky", norm=norm))
        for k, cin in self.OUTS.items():
            self.add_module(f"conv{k}", ConvBnAct(
                cin, output_ch, 1, act="linear", bn=False, bias=True,
                norm=norm))

    def forward(self, in1, in2, in3):
        c = lambda k, x: getattr(self, f"conv{k}")(x)
        out0 = c(2, c(1, in1))
        x3 = torch.cat([c(3, in1), in2], dim=1)
        x8 = c(8, c(7, c(6, c(5, c(4, x3)))))
        out1 = c(10, c(9, x8))
        x11 = torch.cat([c(11, x8), in3], dim=1)
        x16 = c(16, c(15, c(14, c(13, c(12, x11)))))
        out2 = c(18, c(17, x16))
        return [out0, out1, out2]


class Yolov4(nn.Module):
    """[B, H, W, 3] -> [(out0,), (out1,), (out2,)] at H/8, H/16, H/32."""

    def __init__(self, output_ch: int = 256, norm: str = "group"):
        super().__init__()
        self.down1 = DownSample1(norm)
        self.down2 = DownSampleCSP(64, 128, 2, norm)
        self.down3 = DownSampleCSP(128, 256, 8, norm)
        self.down4 = DownSampleCSP(256, 512, 8, norm)
        self.down5 = DownSampleCSP(512, 1024, 4, norm)
        self.neek = Neck(norm)
        self.head = Yolov4Head(output_ch, norm)

    def forward(self, x: torch.Tensor) -> list[tuple[torch.Tensor, ...]]:
        d1 = self.down1(x.permute(0, 3, 1, 2))
        d3 = self.down3(self.down2(d1))
        d4 = self.down4(d3)
        d5 = self.down5(d4)
        out = self.head(*self.neek(d5, d4, d3))
        return [(o.permute(0, 2, 3, 1),) for o in out]


def Yolov4Filters(opt=None) -> Yolov4:
    opt = opt or {}
    return Yolov4(output_ch=opt.get("output_ch", 256),
                  norm=opt.get("norm", "group"))
