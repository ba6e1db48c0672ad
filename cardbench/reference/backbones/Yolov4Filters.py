"""The reference of MonoPort's ``Yolov4Filters`` netG backbone: YOLOv4's
CSPDarknet53 + SPP + PAN encoder (Bochkovskiy, Wang and Liao, "YOLOv4:
Optimal Speed and Accuracy of Object Detection", arXiv:2004.10934), as
MonoPort's ``modeling/backbones/Yolov4Filters.py`` builds it: ``Mish``
(:5), ``Conv_Bn_Activation`` (:33), ``ResBlock``, ``DownSample1-5``
(:91-229), ``Neck`` with the SPP pyramid (:232), ``Yolov4Head`` (:316) and
``Yolov4`` (:379), whose forward returns ``[(out0,), (out1,), (out2,)]``,
``output_ch`` channels each at strides 8, 16 and 32 (:405-416).

Plain PyTorch, float32, nothing of the system under test. Departures from
the published file, none of which changes the arithmetic:

* Parameter names are those of the state dict both sides load: a
  ``Conv_Bn_Activation``'s ``conv.0`` / ``conv.1`` are ``conv`` / ``bn``,
  a ``ResBlock``'s ``module_list.<i>.<0|1>`` is ``b<i>_conv1`` /
  ``b<i>_conv2``, and ``DownSample2-5`` (one CSP pattern at four widths
  and block counts) are one class.
* Images come in NHWC and the stages go out NHWC ([B, h, w, C]); the
  convolutions run NCHW inside.
* BatchNorm reads its running statistics (eps 1e-5): the inference
  forward. Only the 'mish', 'leaky' (0.1) and 'linear' activations, the
  ones the net uses.
* No darknet weight loader (``yolov4.conv.137.pth`` by positional key
  zip, :392-401): the weights are the benchmark's.
* ``Upsample`` (``F.interpolate`` 'nearest' to the skip's size, or
  ``expand`` by the integer ratio at inference: the same copies) is the
  reference's own nearest resize, ``nets.interpolate_nchw``: torch's
  source index floor(i * in / out), as an index gather.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from cardbench.reference.nets import BatchNorm, conv, interpolate_nchw


def mish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.tanh(F.softplus(x))


class ConvBnActivation(nn.Module):
    """Conv (padding (k - 1) // 2, a bias only without the norm), then
    BatchNorm, then the activation."""

    def __init__(self, cin: int, cout: int, k: int, stride: int,
                 activation: str, bn: bool = True):
        super().__init__()
        self.conv = conv(cin, cout, k, stride, (k - 1) // 2, bias=not bn)
        self.bn = BatchNorm(cout) if bn else None
        self.activation = activation

    def forward(self, x):
        x = self.conv(x)
        if self.bn is not None:
            x = self.bn(x)
        if self.activation == "mish":
            return mish(x)
        if self.activation == "leaky":
            return F.leaky_relu(x, 0.1)
        return x                                    # 'linear'


class ResBlock(nn.Module):
    """``nblocks`` of x + conv3x3(conv1x1(x)), mish throughout."""

    def __init__(self, ch: int, nblocks: int):
        super().__init__()
        self.nblocks = nblocks
        for i in range(nblocks):
            self.add_module(f"b{i}_conv1", ConvBnActivation(ch, ch, 1, 1,
                                                            "mish"))
            self.add_module(f"b{i}_conv2", ConvBnActivation(ch, ch, 3, 1,
                                                            "mish"))

    def forward(self, x):
        for i in range(self.nblocks):
            h = getattr(self, f"b{i}_conv1")(x)
            x = x + getattr(self, f"b{i}_conv2")(h)
        return x


class DownSample1(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = ConvBnActivation(3, 32, 3, 1, "mish")
        self.conv2 = ConvBnActivation(32, 64, 3, 2, "mish")
        self.conv3 = ConvBnActivation(64, 64, 1, 1, "mish")
        # [route] layers = -2
        self.conv4 = ConvBnActivation(64, 64, 1, 1, "mish")
        self.conv5 = ConvBnActivation(64, 32, 1, 1, "mish")
        self.conv6 = ConvBnActivation(32, 64, 3, 1, "mish")
        # [shortcut] from = -3
        self.conv7 = ConvBnActivation(64, 64, 1, 1, "mish")
        # [route] layers = -1, -7
        self.conv8 = ConvBnActivation(128, 64, 1, 1, "mish")

    def forward(self, x):
        x1 = self.conv1(x)
        x2 = self.conv2(x1)
        x3 = self.conv3(x2)
        x4 = self.conv4(x2)
        x5 = self.conv5(x4)
        x6 = self.conv6(x5) + x4
        x7 = self.conv7(x6)
        return self.conv8(torch.cat([x7, x3], dim=1))


class DownSample(nn.Module):
    """DownSample2-5: a stride-2 conv, then the cross-stage split: one
    half through 1x1 + ``nblocks`` residual blocks + 1x1, the other 1x1
    alone, concatenated and mixed by a 1x1."""

    def __init__(self, cin: int, ch: int, nblocks: int):
        super().__init__()
        half = ch // 2
        self.conv1 = ConvBnActivation(cin, ch, 3, 2, "mish")
        self.conv2 = ConvBnActivation(ch, half, 1, 1, "mish")
        # [route] layers = -2
        self.conv3 = ConvBnActivation(ch, half, 1, 1, "mish")
        self.res = ResBlock(half, nblocks)
        self.conv4 = ConvBnActivation(half, half, 1, 1, "mish")
        # [route] layers = -1, -(3 * nblocks + 4)
        self.conv5 = ConvBnActivation(ch, ch, 1, 1, "mish")

    def forward(self, x):
        x1 = self.conv1(x)
        x2 = self.conv2(x1)
        x3 = self.conv3(x1)
        x4 = self.conv4(self.res(x3))
        return self.conv5(torch.cat([x4, x2], dim=1))


def upsample(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return interpolate_nchw(x, like.shape[-2:], "nearest")


class Neck(nn.Module):
    """SPP over the stride-32 map, then PAN's top-down path: -> (x20 at
    stride 8, x13 at 16, x6 at 32)."""

    def __init__(self):
        super().__init__()
        leaky = lambda cin, cout, k: ConvBnActivation(cin, cout, k, 1,
                                                      "leaky")
        self.conv1 = leaky(1024, 512, 1)
        self.conv2 = leaky(512, 1024, 3)
        self.conv3 = leaky(1024, 512, 1)
        # SPP: max-pools 5, 9, 13 (stride 1, same size); [route] -1 -3 -5 -6
        self.conv4 = leaky(2048, 512, 1)
        self.conv5 = leaky(512, 1024, 3)
        self.conv6 = leaky(1024, 512, 1)
        self.conv7 = leaky(512, 256, 1)
        # upsample; [route] 85 (downsample4)
        self.conv8 = leaky(512, 256, 1)
        # [route] -1 -3
        self.conv9 = leaky(512, 256, 1)
        self.conv10 = leaky(256, 512, 3)
        self.conv11 = leaky(512, 256, 1)
        self.conv12 = leaky(256, 512, 3)
        self.conv13 = leaky(512, 256, 1)
        self.conv14 = leaky(256, 128, 1)
        # upsample; [route] 54 (downsample3)
        self.conv15 = leaky(256, 128, 1)
        # [route] -1 -3
        self.conv16 = leaky(256, 128, 1)
        self.conv17 = leaky(128, 256, 3)
        self.conv18 = leaky(256, 128, 1)
        self.conv19 = leaky(128, 256, 3)
        self.conv20 = leaky(256, 128, 1)

    def forward(self, d5, d4, d3):
        x3 = self.conv3(self.conv2(self.conv1(d5)))
        m1 = F.max_pool2d(x3, 5, 1, 5 // 2)
        m2 = F.max_pool2d(x3, 9, 1, 9 // 2)
        m3 = F.max_pool2d(x3, 13, 1, 13 // 2)
        spp = torch.cat([m3, m2, m1, x3], dim=1)
        x6 = self.conv6(self.conv5(self.conv4(spp)))
        up = upsample(self.conv7(x6), d4)
        x8 = torch.cat([self.conv8(d4), up], dim=1)
        x13 = self.conv13(self.conv12(self.conv11(self.conv10(
            self.conv9(x8)))))
        up = upsample(self.conv14(x13), d3)
        x15 = torch.cat([self.conv15(d3), up], dim=1)
        x20 = self.conv20(self.conv19(self.conv18(self.conv17(
            self.conv16(x15)))))
        return x20, x13, x6


class Yolov4Head(nn.Module):
    """PAN's bottom-up path and the three outputs, each a biased linear
    1x1 conv to ``output_ch``."""

    def __init__(self, output_ch: int):
        super().__init__()
        leaky = lambda cin, cout, k, s=1: ConvBnActivation(cin, cout, k, s,
                                                           "leaky")
        linear = lambda cin: ConvBnActivation(cin, output_ch, 1, 1, "linear",
                                              bn=False)
        self.conv1 = leaky(128, 256, 3)
        self.conv2 = linear(256)
        # [route] -4
        self.conv3 = leaky(128, 256, 3, 2)
        # [route] -1 -16
        self.conv4 = leaky(512, 256, 1)
        self.conv5 = leaky(256, 512, 3)
        self.conv6 = leaky(512, 256, 1)
        self.conv7 = leaky(256, 512, 3)
        self.conv8 = leaky(512, 256, 1)
        self.conv9 = leaky(256, 512, 3)
        self.conv10 = linear(512)
        # [route] -4
        self.conv11 = leaky(256, 512, 3, 2)
        # [route] -1 -37
        self.conv12 = leaky(1024, 512, 1)
        self.conv13 = leaky(512, 1024, 3)
        self.conv14 = leaky(1024, 512, 1)
        self.conv15 = leaky(512, 1024, 3)
        self.conv16 = leaky(1024, 512, 1)
        self.conv17 = leaky(512, 1024, 3)
        self.conv18 = linear(1024)

    def forward(self, in1, in2, in3):
        x2 = self.conv2(self.conv1(in1))
        x3 = torch.cat([self.conv3(in1), in2], dim=1)
        x8 = self.conv8(self.conv7(self.conv6(self.conv5(self.conv4(x3)))))
        x10 = self.conv10(self.conv9(x8))
        x11 = torch.cat([self.conv11(x8), in3], dim=1)
        x16 = self.conv16(self.conv15(self.conv14(self.conv13(
            self.conv12(x11)))))
        x18 = self.conv18(self.conv17(x16))
        return [x2, x10, x18]


class Yolov4(nn.Module):
    """[B, H, W, 3] -> [(out0,), (out1,), (out2,)], NHWC, at H/8, H/16,
    H/32."""

    def __init__(self, output_ch: int = 256):
        super().__init__()
        self.down1 = DownSample1()
        self.down2 = DownSample(64, 128, 2)
        self.down3 = DownSample(128, 256, 8)
        self.down4 = DownSample(256, 512, 8)
        self.down5 = DownSample(512, 1024, 4)
        self.neek = Neck()                  # the published file's spelling
        self.head = Yolov4Head(output_ch)

    def forward(self, x):
        d1 = self.down1(x.permute(0, 3, 1, 2))
        d2 = self.down2(d1)
        d3 = self.down3(d2)
        d4 = self.down4(d3)
        d5 = self.down5(d4)
        x20, x13, x6 = self.neek(d5, d4, d3)
        return [(o.permute(0, 2, 3, 1),) for o in self.head(x20, x13, x6)]


def build(spec: dict) -> Yolov4:
    """The configuration's ``backbone`` entry: BatchNorm, as the published
    ``Conv_Bn_Activation`` has; ``output_ch`` 256 unless given."""
    if spec.get("norm", "batch") != "batch":
        raise ValueError("Yolov4Filters' reference is BatchNorm's")
    return Yolov4(spec.get("output_ch", 256))
