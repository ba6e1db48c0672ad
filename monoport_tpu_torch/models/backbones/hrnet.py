"""HRNet-V2-W18 backbone family (port of
``monoport_tpu/models/backbones/hrnet.py``).

Stem of two stride-2 3x3 convs, a Bottleneck stage 1, Basic stages 2-4 of
parallel branches with all-to-all fusion (1x1 conv + norm + ``nearest``
upsample from lower resolutions, strided 3x3 convs from higher ones), and
an optional ``last_layer`` that concatenates the four scales (bilinear,
align_corners=True) into a 256-channel map, and six config factories.

Parity points: the stem's norms have 32 groups, every other GroupNorm
``adaptive_groups(channels)``; ``last_conv2`` is a 1x1 conv with padding 1
(the reference's, HRNetFilters.py:299), so ``last_layer`` returns a map 2
pixels wider than H/4 whose border is bias only. Without ``last_layer`` the
output is one stage of the four branches (strides 4, 8, 16, 32).

Module names follow the flax tree (``weights.torch_state_from_flax``). NHWC
in and out; NCHW inside.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops.resize import interpolate_nchw
from .hourglass import adaptive_groups, conv, make_norm


def _norm(norm: str, channels: int) -> nn.Module:
    return make_norm(norm, channels, adaptive_groups(channels))


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 norm: str = "group"):
        super().__init__()
        self.conv1 = conv(inplanes, planes, 3, stride, 1, bias=False)
        self.bn1 = _norm(norm, planes)
        self.conv2 = conv(planes, planes, 3, pad=1, bias=False)
        self.bn2 = _norm(norm, planes)
        self.project = inplanes != planes or stride != 1
        if self.project:
            self.down_conv = conv(inplanes, planes, 1, stride, bias=False)
            self.down_bn = _norm(norm, planes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        residual = self.down_bn(self.down_conv(x)) if self.project else x
        return F.relu(out + residual)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 norm: str = "group"):
        super().__init__()
        out = planes * 4
        self.conv1 = conv(inplanes, planes, 1, bias=False)
        self.bn1 = _norm(norm, planes)
        self.conv2 = conv(planes, planes, 3, stride, 1, bias=False)
        self.bn2 = _norm(norm, planes)
        self.conv3 = conv(planes, out, 1, bias=False)
        self.bn3 = _norm(norm, out)
        self.project = inplanes != out or stride != 1
        if self.project:
            self.down_conv = conv(inplanes, out, 1, stride, bias=False)
            self.down_bn = _norm(norm, out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        residual = self.down_bn(self.down_conv(x)) if self.project else x
        return F.relu(out + residual)


_BLOCKS = {"Basic": BasicBlock, "Bottleneck": Bottleneck}


class HighResolutionModule(nn.Module):
    """Parallel branches + all-to-all fusion (HRNetFilters.py:103-220)."""

    def __init__(self, num_branches: int, block: str,
                 num_blocks: Sequence[int], in_channels: Sequence[int],
                 num_channels: Sequence[int], norm: str = "group"):
        super().__init__()
        blk = _BLOCKS[block]
        self.num_branches = num_branches
        chans = []
        for i in range(num_branches):
            c_in = in_channels[i]
            for k in range(num_blocks[i]):
                self.add_module(f"branch{i}_block{k}",
                                blk(c_in, num_channels[i], norm=norm))
                c_in = num_channels[i] * blk.expansion
            chans.append(c_in)
        self.num_blocks = tuple(num_blocks)
        self.out_channels = tuple(chans)
        if num_branches == 1:
            return
        for i in range(num_branches):
            for j in range(num_branches):
                if j > i:
                    self.add_module(f"fuse{i}_{j}_conv",
                                    conv(chans[j], chans[i], 1, bias=False))
                    self.add_module(f"fuse{i}_{j}_bn", _norm(norm, chans[i]))
                elif j < i:
                    for k in range(i - j):
                        c_out = chans[i] if k == i - j - 1 else chans[j]
                        self.add_module(f"fuse{i}_{j}_conv{k}", conv(
                            chans[j], c_out, 3, 2, 1, bias=False))
                        self.add_module(f"fuse{i}_{j}_bn{k}",
                                        _norm(norm, c_out))

    def forward(self, xs: list[torch.Tensor]) -> list[torch.Tensor]:
        outs = []
        for i in range(self.num_branches):
            y = xs[i]
            for k in range(self.num_blocks[i]):
                y = getattr(self, f"branch{i}_block{k}")(y)
            outs.append(y)
        if self.num_branches == 1:
            return outs
        fused = []
        for i in range(self.num_branches):
            acc = None
            for j in range(self.num_branches):
                if j == i:
                    y = outs[j]
                elif j > i:
                    y = getattr(self, f"fuse{i}_{j}_bn")(
                        getattr(self, f"fuse{i}_{j}_conv")(outs[j]))
                    y = interpolate_nchw(y, outs[i].shape[-2:], "nearest")
                else:
                    y = outs[j]
                    for k in range(i - j):
                        y = getattr(self, f"fuse{i}_{j}_bn{k}")(
                            getattr(self, f"fuse{i}_{j}_conv{k}")(y))
                        if k != i - j - 1:
                            y = F.relu(y)
                acc = y if acc is None else acc + y
            fused.append(F.relu(acc))
        return fused


class HRNet(nn.Module):
    """[B, H, W, 3] -> [(y,)] with ``last_layer`` (256 channels), else one
    stage of the last stage's branches [(y_0, ..., y_n)]."""

    def __init__(self, cfg: dict, norm: str = "group"):
        super().__init__()
        self.conv1 = conv(3, 64, 3, 2, 1, bias=False)
        self.bn1 = make_norm(norm, 64)
        self.conv2 = conv(64, 64, 3, 2, 1, bias=False)
        self.bn2 = make_norm(norm, 64)

        s1 = cfg["STAGE1"]
        block = _BLOCKS[s1["BLOCK"]]
        c = 64
        self.layer1_blocks = s1["NUM_BLOCKS"][0]
        for k in range(self.layer1_blocks):
            self.add_module(f"layer1_{k}",
                            block(c, s1["NUM_CHANNELS"][0], norm=norm))
            c = s1["NUM_CHANNELS"][0] * block.expansion
        prev = [c]

        self.stages = []
        for si in (2, 3, 4):
            key = f"STAGE{si}"
            if key not in cfg:
                break
            sc = cfg[key]
            block = _BLOCKS[sc["BLOCK"]]
            chans = [ch * block.expansion for ch in sc["NUM_CHANNELS"]]
            # transition: adapt existing branches, spawn new ones from the
            # last branch of the previous stage
            trans = []
            for i in range(sc["NUM_BRANCHES"]):
                if i < len(prev) and prev[i] == chans[i]:
                    trans.append(False)
                    continue
                new = i >= len(prev)
                c_in = prev[-1] if new else prev[i]
                self.add_module(f"t{si}_{i}_conv", conv(
                    c_in, chans[i], 3, 2 if new else 1, 1, bias=False))
                self.add_module(f"t{si}_{i}_bn", _norm(norm, chans[i]))
                trans.append(True)
            c_in = chans
            for m in range(sc["NUM_MODULES"]):
                mod = HighResolutionModule(
                    sc["NUM_BRANCHES"], sc["BLOCK"], sc["NUM_BLOCKS"],
                    c_in, chans, norm=norm)
                self.add_module(f"stage{si}_m{m}", mod)
                c_in = mod.out_channels
            self.stages.append((si, tuple(trans), sc["NUM_MODULES"]))
            prev = list(c_in)

        self.last_layer = bool(cfg.get("last_layer"))
        if self.last_layer:
            c = sum(prev)
            self.last_conv1 = conv(c, c, 1)
            self.last_bn = _norm(norm, c)
            self.last_conv2 = conv(c, 256, 1, pad=1)

    def forward(self, x: torch.Tensor) -> list[tuple[torch.Tensor, ...]]:
        x = x.permute(0, 3, 1, 2)
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.relu(self.bn2(self.conv2(x)))
        for k in range(self.layer1_blocks):
            x = getattr(self, f"layer1_{k}")(x)
        ys = [x]
        for si, trans, n_modules in self.stages:
            xs = []
            for i, t in enumerate(trans):
                y = ys[i] if i < len(ys) else ys[-1]
                if t:
                    y = F.relu(getattr(self, f"t{si}_{i}_bn")(
                        getattr(self, f"t{si}_{i}_conv")(y)))
                xs.append(y)
            for m in range(n_modules):
                xs = getattr(self, f"stage{si}_m{m}")(xs)
            ys = xs
        if self.last_layer:
            hw = ys[0].shape[-2:]
            y = torch.cat([ys[0]] + [interpolate_nchw(y, hw, "bilinear")
                                     for y in ys[1:]], dim=1)
            y = F.relu(self.last_bn(self.last_conv1(y)))
            return [(self.last_conv2(y).permute(0, 2, 3, 1),)]
        return [tuple(y.permute(0, 2, 3, 1) for y in ys)]


def _small_v2_cfg(c2, c3, c4, last_layer, blocks3=(2, 2, 2),
                  blocks4=(2, 2, 2, 2), mods3=3, mods4=2):
    return {
        "STAGE1": {"NUM_MODULES": 1, "NUM_BRANCHES": 1, "NUM_BLOCKS": [2],
                   "NUM_CHANNELS": [64], "BLOCK": "Bottleneck"},
        "STAGE2": {"NUM_MODULES": 1, "NUM_BRANCHES": 2,
                   "NUM_BLOCKS": [2, 2], "NUM_CHANNELS": list(c2),
                   "BLOCK": "Basic"},
        "STAGE3": {"NUM_MODULES": mods3, "NUM_BRANCHES": 3,
                   "NUM_BLOCKS": list(blocks3), "NUM_CHANNELS": list(c3),
                   "BLOCK": "Basic"},
        "STAGE4": {"NUM_MODULES": mods4, "NUM_BRANCHES": 4,
                   "NUM_BLOCKS": list(blocks4), "NUM_CHANNELS": list(c4),
                   "BLOCK": "Basic"},
        "last_layer": last_layer,
    }


def _opt_norm(opt) -> str:
    """The reference hardcodes BatchNorm (HRNetFilters.py:10); the default
    here is GroupNorm, as in the JAX package: set ``norm: batch`` for
    converted reference weights."""
    return opt.get("norm", "group") if opt else "group"


def HRNetV2_W18_small_v2(opt=None) -> HRNet:
    return HRNet(_small_v2_cfg([18, 36], [18, 36, 72], [18, 36, 72, 144],
                               False), norm=_opt_norm(opt))


def HRNetV2_W18_small_v2_balance(opt=None) -> HRNet:
    return HRNet(_small_v2_cfg([80, 160], [80, 160, 240],
                               [80, 160, 240, 360], False),
                 norm=_opt_norm(opt))


def HRNetV2_W18_small_v2_balance_gn32(opt=None) -> HRNet:
    return HRNet(_small_v2_cfg([64, 128], [64, 128, 256],
                               [64, 128, 256, 384], False),
                 norm=_opt_norm(opt))


def HRNetV2_W18_small_v2_balance_last(opt=None) -> HRNet:
    return HRNet(_small_v2_cfg([80, 160], [80, 160, 240],
                               [80, 160, 240, 360], True),
                 norm=_opt_norm(opt))


def HRNetV2_W18_small_v2_balance_v2(opt=None) -> HRNet:
    return HRNet(_small_v2_cfg([80, 160], [80, 160, 380],
                               [80, 160, 380, 520], False),
                 norm=_opt_norm(opt))


def HRNetV2_W18_small_v2_deeper(opt=None) -> HRNet:
    return HRNet(_small_v2_cfg([80, 160], [80, 160, 320],
                               [80, 160, 320, 480], False,
                               blocks3=(2, 2, 3), blocks4=(2, 2, 3, 4),
                               mods3=2, mods4=3),
                 norm=_opt_norm(opt))
