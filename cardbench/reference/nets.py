"""The plain networks of the benchmark's reference: a frozen copy of the
pixel-aligned implicit-function nets in plain PyTorch, float32.

Backbones (stacked hourglass, Johnson ResNet, HRNet-V2 small), the PIFu
head (leaky-ReLU MLP with the input skip-concatenated into every layer
after the first), the scalar z feature, bilinear feature sampling
(``grid_sample``, align_corners=True, zeros padding) and the per-point
and anchored queries. Images are NHWC, features [B, h, w, C], points
[B, N, 3]; the convolutions run NCHW inside.

Module and parameter names match the checkpoints' torch layout, so one
state dict loads here and into the system under test. Nothing here
imports the system under test: this file is the yardstick. A backbone
other than the three built in here is found by its ``IMF`` name as a file
of its own (``backbone``; ``reference/__init__.py``).
"""

from __future__ import annotations

import importlib.util
import os
import sys
from typing import Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

Z_SCALE = 512 // 2 / 200.0          # PIFu's depth normalizer
HEAD_ROWS = 65536                   # rows of one plain head call
BACKBONE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "backbones")

_CONSTANTS: dict = {}


def _constant(build, args: tuple, device, dtype) -> torch.Tensor:
    key = (build.__name__, args, str(device), dtype)
    if key not in _CONSTANTS:
        _CONSTANTS[key] = torch.as_tensor(build(*args), device=device).to(
            dtype)
    return _CONSTANTS[key]


# -- resampling -------------------------------------------------------------
def _source_coords(out_size: int, in_size: int, align_corners: bool):
    i = np.arange(out_size, dtype=np.float64)
    if in_size == 1 or (align_corners and out_size == 1):
        return np.zeros(out_size, dtype=np.float64)
    if align_corners:
        return i * (in_size - 1) / (out_size - 1)
    return (i + 0.5) * in_size / out_size - 0.5


def _cubic_weight(t, a: float = -0.75):
    at = np.abs(t)
    f1 = ((a + 2.0) * at - (a + 3.0)) * at * at + 1.0
    f2 = ((a * at - 5.0 * a) * at + 8.0 * a) * at - 4.0 * a
    return np.where(at <= 1.0, f1, np.where(at < 2.0, f2, 0.0))


def resize_matrix(in_size: int, out_size: int, mode: str,
                  align_corners: bool) -> np.ndarray:
    """Dense [out, in] interpolation matrix of one axis (torch's source
    coordinates; bicubic a = -0.75 with the border replicated)."""
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
            np.add.at(mat, (rows, np.clip(tap, 0, in_size - 1)),
                      _cubic_weight(src - tap))
    else:
        raise ValueError(mode)
    return mat.astype(np.float32)


def nearest_index(in_size: int, out_size: int) -> np.ndarray:
    return np.floor(np.arange(out_size, dtype=np.float64) * in_size
                    / out_size).astype(np.int64)


def resize_axis(x: torch.Tensor, axis: int, out_size: int, mode: str,
                align_corners: bool = True) -> torch.Tensor:
    in_size = x.shape[axis]
    if in_size == out_size and mode != "bicubic":
        return x
    if mode == "nearest":
        idx = _constant(nearest_index, (in_size, out_size), x.device,
                        torch.int64)
        return torch.index_select(x, axis, idx)
    mat = _constant(resize_matrix, (in_size, out_size, mode, align_corners),
                    x.device, x.dtype)
    moved = torch.movedim(x, axis, -1)
    return torch.movedim(torch.matmul(moved, mat.t()), -1, axis)


def interpolate_2d(x, size, mode="bilinear"):
    """NHWC resize, align_corners=True."""
    return resize_axis(resize_axis(x, 1, size[0], mode), 2, size[1], mode)


def interpolate_nchw(x, size, mode="bilinear"):
    return resize_axis(resize_axis(x, 2, size[0], mode), 3, size[1], mode)


# -- sampling and projection -------------------------------------------------
def index(feat: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of [B, H, W, C] at [B, N, 2] (u along W) -> [B, N, C]."""
    out = F.grid_sample(feat.permute(0, 3, 1, 2), uv.to(feat.dtype)[:, None],
                        mode="bilinear", padding_mode="zeros",
                        align_corners=True)
    return out[:, :, 0].transpose(1, 2)


def orthogonal(points: torch.Tensor, calib: torch.Tensor) -> torch.Tensor:
    """[B, N, 3] through the [B, 4, 4] calib's affine rows, as f32
    multiply-adds (no reduced-precision product shifts a tap)."""
    out = calib[:, None, :3, 3]
    for j in range(3):
        out = out + calib[:, None, :3, j] * points[..., j:j + 1]
    return out


def in_image(u, v):
    return (u >= -1.0) & (u <= 1.0) & (v >= -1.0) & (v <= 1.0)


# -- the head ----------------------------------------------------------------
class SurfaceClassifier(nn.Module):
    """PIFu MLP over [B, N, C_in]: leaky ReLU 0.01 between layers, the
    input concatenated onto every layer after the first, then
    ``last_op``."""

    def __init__(self, channels: Sequence[int], last_op: str):
        super().__init__()
        chans = list(channels)
        self.n_layers = len(chans) - 1
        self.last_op = last_op
        for i in range(self.n_layers):
            self.add_module(f"filters_{i}", nn.Linear(
                chans[i] + (chans[0] if i else 0), chans[i + 1]))

    def forward(self, feature: torch.Tensor) -> torch.Tensor:
        rows = feature.shape[1]
        if rows > HEAD_ROWS:
            return torch.cat([self(feature[:, i:i + HEAD_ROWS])
                              for i in range(0, rows, HEAD_ROWS)], dim=1)
        y = feature
        for i in range(self.n_layers):
            if i:
                y = torch.cat([y, feature], dim=-1)
            y = getattr(self, f"filters_{i}")(y)
            if i != self.n_layers - 1:
                y = F.leaky_relu(y, 0.01)
        return torch.sigmoid(y) if self.last_op == "sigmoid" else torch.tanh(y)


# -- backbones ---------------------------------------------------------------
class BatchNorm(nn.BatchNorm2d):
    """BatchNorm on its running statistics (eps 1e-5)."""

    def __init__(self, channels: int):
        super().__init__(channels, eps=1e-5)

    def forward(self, x):
        return F.batch_norm(x, self.running_mean, self.running_var,
                            self.weight, self.bias, False, 0.0, self.eps)


def adaptive_groups(channels: int, max_groups: int = 32) -> int:
    for g in range(min(max_groups, channels), 0, -1):
        if channels % g == 0:
            return g
    return 1


def make_norm(norm: str, channels: int, groups: int = 32) -> nn.Module:
    if norm == "group":
        return nn.GroupNorm(groups, channels, eps=1e-5)
    if norm == "batch":
        return BatchNorm(channels)
    raise ValueError(norm)


def conv(cin, cout, k, stride=1, pad=0, bias=True):
    return nn.Conv2d(cin, cout, k, stride=stride, padding=pad, bias=bias)


class ConvBlock(nn.Module):
    """The hourglass's 3-way split-channel residual block."""

    def __init__(self, cin: int, cout: int, norm: str):
        super().__init__()
        self.conv1 = conv(cin, cout // 2, 3, pad=1, bias=False)
        self.conv2 = conv(cout // 2, cout // 4, 3, pad=1, bias=False)
        self.conv3 = conv(cout // 4, cout // 4, 3, pad=1, bias=False)
        self.bn1 = make_norm(norm, cin)
        self.bn2 = make_norm(norm, cout // 2)
        self.bn3 = make_norm(norm, cout // 4)
        self.project = cin != cout
        if self.project:
            self.bn4 = make_norm(norm, cin)
            self.downsample_conv = conv(cin, cout, 1, bias=False)

    def forward(self, x):
        out1 = self.conv1(F.relu(self.bn1(x)))
        out2 = self.conv2(F.relu(self.bn2(out1)))
        out3 = self.conv3(F.relu(self.bn3(out2)))
        res = self.downsample_conv(F.relu(self.bn4(x))) if self.project else x
        return torch.cat([out1, out2, out3], dim=1) + res


class HourGlass(nn.Module):
    def __init__(self, depth: int, f: int, norm: str):
        super().__init__()
        self.depth = depth
        for level in range(depth, 0, -1):
            self.add_module(f"b1_{level}", ConvBlock(f, f, norm))
            self.add_module(f"b2_{level}", ConvBlock(f, f, norm))
            if level == 1:
                self.add_module("b2_plus_1", ConvBlock(f, f, norm))
            self.add_module(f"b3_{level}", ConvBlock(f, f, norm))

    def _level(self, level, x):
        up1 = getattr(self, f"b1_{level}")(x)
        low1 = getattr(self, f"b2_{level}")(F.avg_pool2d(x, 2, 2))
        low2 = (self._level(level - 1, low1) if level > 1
                else self.b2_plus_1(low1))
        low3 = getattr(self, f"b3_{level}")(low2)
        h, w = low3.shape[-2:]
        return up1 + interpolate_nchw(low3, (2 * h, 2 * w), "bicubic")

    def forward(self, x):
        return self._level(self.depth, x)


class HGFilter(nn.Module):
    """Stacked hourglass (average-pool downsampling): -> one single-level
    stage a hourglass, [B, H/4, W/4, hourglass_dim]."""

    def __init__(self, num_stack=4, num_hourglass=2, hourglass_dim=256,
                 norm="group"):
        super().__init__()
        self.num_stack = num_stack
        self.conv1 = conv(3, 64, 7, stride=2, pad=3)
        self.bn1 = make_norm(norm, 64)
        self.conv2 = ConvBlock(64, 128, norm)
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

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x.permute(0, 3, 1, 2))))
        x = self.conv4(self.conv3(F.avg_pool2d(self.conv2(x), 2, 2)))
        previous, outputs = x, []
        for i in range(self.num_stack):
            ll = getattr(self, f"top_m_{i}")(getattr(self, f"m{i}")(previous))
            ll = F.relu(getattr(self, f"bn_end{i}")(
                getattr(self, f"conv_last{i}")(ll)))
            tmp = getattr(self, f"l{i}")(ll)
            outputs.append((tmp.permute(0, 2, 3, 1),))
            if i < self.num_stack - 1:
                previous = (previous + getattr(self, f"bl{i}")(ll)
                            + getattr(self, f"al{i}")(tmp))
        return outputs


class ResnetBlock(nn.Module):
    def __init__(self, dim: int, norm: str, last: bool):
        super().__init__()
        self.last = last
        self.conv1 = conv(dim, dim, 3, bias=False)
        self.norm1 = make_norm(norm, dim)
        self.conv2 = conv(dim, dim, 3, bias=False)
        if not last:
            self.norm2 = make_norm(norm, dim)

    def forward(self, x):
        y = F.relu(self.norm1(self.conv1(F.pad(x, (1,) * 4, mode="reflect"))))
        y = self.conv2(F.pad(y, (1,) * 4, mode="reflect"))
        return x + (y if self.last else self.norm2(y))


class ResnetFilter(nn.Module):
    """Johnson ResNet: reflect-padded 7x7 stem, two stride-2 convs,
    ``n_blocks`` blocks at 4 ngf (the last without its second norm)."""

    def __init__(self, ngf=64, n_blocks=6, norm="group"):
        super().__init__()
        self.n_blocks = n_blocks
        self.conv_stem = conv(3, ngf, 7, bias=False)
        self.norm_stem = make_norm(norm, ngf)
        for i in range(2):
            m = 2 ** i
            self.add_module(f"down{i}_conv", conv(ngf * m, ngf * m * 2, 3,
                                                  stride=2, pad=1, bias=False))
            self.add_module(f"down{i}_norm", make_norm(norm, ngf * m * 2))
        for i in range(n_blocks):
            self.add_module(f"block{i}",
                            ResnetBlock(ngf * 4, norm, i == n_blocks - 1))

    def forward(self, x):
        x = F.pad(x.permute(0, 3, 1, 2), (3,) * 4, mode="reflect")
        x = F.relu(self.norm_stem(self.conv_stem(x)))
        for i in range(2):
            x = F.relu(getattr(self, f"down{i}_norm")(
                getattr(self, f"down{i}_conv")(x)))
        for i in range(self.n_blocks):
            x = getattr(self, f"block{i}")(x)
        return [(x.permute(0, 2, 3, 1),)]


def _hr_norm(norm, channels):
    return make_norm(norm, channels, adaptive_groups(channels))


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin, planes, norm):
        super().__init__()
        self.conv1 = conv(cin, planes, 3, 1, 1, bias=False)
        self.bn1 = _hr_norm(norm, planes)
        self.conv2 = conv(planes, planes, 3, pad=1, bias=False)
        self.bn2 = _hr_norm(norm, planes)
        self.project = cin != planes
        if self.project:
            self.down_conv = conv(cin, planes, 1, bias=False)
            self.down_bn = _hr_norm(norm, planes)

    def forward(self, x):
        out = self.bn2(self.conv2(F.relu(self.bn1(self.conv1(x)))))
        res = self.down_bn(self.down_conv(x)) if self.project else x
        return F.relu(out + res)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin, planes, norm):
        super().__init__()
        self.conv1 = conv(cin, planes, 1, bias=False)
        self.bn1 = _hr_norm(norm, planes)
        self.conv2 = conv(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = _hr_norm(norm, planes)
        self.conv3 = conv(planes, planes * 4, 1, bias=False)
        self.bn3 = _hr_norm(norm, planes * 4)
        self.project = cin != planes * 4
        if self.project:
            self.down_conv = conv(cin, planes * 4, 1, bias=False)
            self.down_bn = _hr_norm(norm, planes * 4)

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        res = self.down_bn(self.down_conv(x)) if self.project else x
        return F.relu(out + res)


_BLOCKS = {"Basic": BasicBlock, "Bottleneck": Bottleneck}


class HighResolutionModule(nn.Module):
    """Parallel branches, then all-to-all fusion (1x1 conv + norm +
    nearest upsample from lower resolutions, strided 3x3 convs from
    higher ones)."""

    def __init__(self, n, block, num_blocks, cin, num_channels, norm):
        super().__init__()
        blk = _BLOCKS[block]
        self.n, self.num_blocks = n, tuple(num_blocks)
        chans = []
        for i in range(n):
            c = cin[i]
            for k in range(num_blocks[i]):
                self.add_module(f"branch{i}_block{k}",
                                blk(c, num_channels[i], norm))
                c = num_channels[i] * blk.expansion
            chans.append(c)
        self.out_channels = tuple(chans)
        if n == 1:
            return
        for i in range(n):
            for j in range(n):
                if j > i:
                    self.add_module(f"fuse{i}_{j}_conv",
                                    conv(chans[j], chans[i], 1, bias=False))
                    self.add_module(f"fuse{i}_{j}_bn", _hr_norm(norm, chans[i]))
                elif j < i:
                    for k in range(i - j):
                        c_out = chans[i] if k == i - j - 1 else chans[j]
                        self.add_module(f"fuse{i}_{j}_conv{k}", conv(
                            chans[j], c_out, 3, 2, 1, bias=False))
                        self.add_module(f"fuse{i}_{j}_bn{k}",
                                        _hr_norm(norm, c_out))

    def forward(self, xs):
        outs = []
        for i in range(self.n):
            y = xs[i]
            for k in range(self.num_blocks[i]):
                y = getattr(self, f"branch{i}_block{k}")(y)
            outs.append(y)
        if self.n == 1:
            return outs
        fused = []
        for i in range(self.n):
            acc = None
            for j in range(self.n):
                y = outs[j]
                if j > i:
                    y = getattr(self, f"fuse{i}_{j}_bn")(
                        getattr(self, f"fuse{i}_{j}_conv")(y))
                    y = interpolate_nchw(y, outs[i].shape[-2:], "nearest")
                elif j < i:
                    for k in range(i - j):
                        y = getattr(self, f"fuse{i}_{j}_bn{k}")(
                            getattr(self, f"fuse{i}_{j}_conv{k}")(y))
                        if k != i - j - 1:
                            y = F.relu(y)
                acc = y if acc is None else acc + y
            fused.append(F.relu(acc))
        return fused


class HRNet(nn.Module):
    """HRNet-V2 from its stage config; without a last layer the output is
    one stage of the last stage's branches (strides 4 to 32)."""

    def __init__(self, cfg: dict, norm: str):
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
            self.add_module(f"layer1_{k}", block(c, s1["NUM_CHANNELS"][0],
                                                 norm))
            c = s1["NUM_CHANNELS"][0] * block.expansion
        prev = [c]
        self.stages = []
        for si in (2, 3, 4):
            sc = cfg[f"STAGE{si}"]
            block = _BLOCKS[sc["BLOCK"]]
            chans = [ch * block.expansion for ch in sc["NUM_CHANNELS"]]
            trans = []
            for i in range(sc["NUM_BRANCHES"]):
                if i < len(prev) and prev[i] == chans[i]:
                    trans.append(False)
                    continue
                new = i >= len(prev)
                self.add_module(f"t{si}_{i}_conv", conv(
                    prev[-1] if new else prev[i], chans[i], 3,
                    2 if new else 1, 1, bias=False))
                self.add_module(f"t{si}_{i}_bn", _hr_norm(norm, chans[i]))
                trans.append(True)
            cin = chans
            for m in range(sc["NUM_MODULES"]):
                mod = HighResolutionModule(sc["NUM_BRANCHES"], sc["BLOCK"],
                                           sc["NUM_BLOCKS"], cin, chans, norm)
                self.add_module(f"stage{si}_m{m}", mod)
                cin = mod.out_channels
            self.stages.append((si, tuple(trans), sc["NUM_MODULES"]))
            prev = list(cin)

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x.permute(0, 3, 1, 2))))
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
        return [tuple(y.permute(0, 2, 3, 1) for y in ys)]


def hrnet_small_v2_cfg(c2, c3, c4) -> dict:
    """HRNetFilters.py's small-v2 stage layout at the given widths."""
    return {
        "STAGE1": {"NUM_MODULES": 1, "NUM_BRANCHES": 1, "NUM_BLOCKS": [2],
                   "NUM_CHANNELS": [64], "BLOCK": "Bottleneck"},
        "STAGE2": {"NUM_MODULES": 1, "NUM_BRANCHES": 2, "NUM_BLOCKS": [2, 2],
                   "NUM_CHANNELS": list(c2), "BLOCK": "Basic"},
        "STAGE3": {"NUM_MODULES": 3, "NUM_BRANCHES": 3,
                   "NUM_BLOCKS": [2, 2, 2], "NUM_CHANNELS": list(c3),
                   "BLOCK": "Basic"},
        "STAGE4": {"NUM_MODULES": 2, "NUM_BRANCHES": 4,
                   "NUM_BLOCKS": [2, 2, 2, 2], "NUM_CHANNELS": list(c4),
                   "BLOCK": "Basic"},
    }


def load_file(path: str):
    """The module of the Python file ``path``, executed once a process."""
    name = "cardbench_reference_" + "".join(
        c if c.isalnum() else "_" for c in os.path.abspath(path))
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(name, path)
        module = importlib.util.module_from_spec(spec)
        sys.modules[name] = module
        try:
            spec.loader.exec_module(module)
        except BaseException:
            del sys.modules[name]
            raise
    return sys.modules[name]


def backbone(spec: dict, directory: str | None = None) -> nn.Module:
    """The backbone a configuration file's ``backbone`` entry names: one
    of the three here, else ``build(spec)`` of ``<IMF>.py`` in
    ``directory`` (``BACKBONE_DIR`` when None)."""
    imf, norm = spec["IMF"], spec.get("norm", "group")
    if imf == "PIFuHGFilters":
        return HGFilter(spec["num_stack"], spec["num_hourglass"],
                        spec["hourglass_dim"], norm)
    if imf == "PIFuResBlkFilters":
        return ResnetFilter(spec.get("ngf", 64), spec.get("n_blocks", 6), norm)
    if imf == "HRNetV2_W18_small_v2":
        return HRNet(hrnet_small_v2_cfg(*spec["widths"]), norm)
    path = os.path.join(directory or BACKBONE_DIR, f"{imf}.py")
    if not os.path.isfile(path):
        raise ValueError(f"no reference backbone {imf!r}")
    return load_file(path).build(spec)


def _anchor_positions(k: int) -> np.ndarray:
    if k > 1:
        return np.linspace(0.0, 1.0, k, dtype=np.float32)
    return np.zeros((1,), np.float32)


# -- the net -----------------------------------------------------------------
class ImplicitNet(nn.Module):
    """Backbone + head of one net (netG or netC) of a configuration file:
    ``filter`` then the per-point or anchored query of the last stage."""

    def __init__(self, spec: dict):
        super().__init__()
        if spec.get("projection", "orthogonal") != "orthogonal":
            raise ValueError("the reference is orthographic")
        self.image_filter = backbone(spec["backbone"])
        self.surface_classifier = SurfaceClassifier(
            spec["head"]["widths"], spec["head"]["last_op"])

    def filter(self, images, feat_prior=None):
        stages = self.image_filter(images)
        if feat_prior is not None:
            h, w = stages[0][0].shape[1:3]
            prior = interpolate_2d(feat_prior, (h, w), "nearest")
            stages = [[torch.cat([prior, f], dim=-1) for f in fs]
                      for fs in stages]
        return stages[-1]

    def query(self, feats, points, calib):
        """[B, N, 3] world points -> [B, N, C_out]."""
        xyz = orthogonal(points, calib)
        xy = xyz[..., :2]
        x = torch.cat([index(f, xy) for f in feats]
                      + [xyz[..., 2:3] * Z_SCALE], dim=-1)
        pred = self.surface_classifier(x)
        return in_image(xy[..., 0], xy[..., 1])[..., None].to(pred.dtype) * pred

    def query_anchored(self, feats, xy_world, z_world, calib, anchors: int):
        """Anchored ray query: [B, R, 2] + [B, R, T] -> [B, R, T, C_out].
        Every tap is projected exactly; features are sampled at ``anchors``
        evenly spaced points of the ray's image chord, and a tap takes the
        hat-weighted mix of its two bracketing anchors."""
        b, r, t = z_world.shape
        k = anchors
        base = torch.cat([xy_world[:, :, None].expand(b, r, t, 2),
                          z_world[..., None]], dim=-1)
        xyz = orthogonal(base.reshape(b, r * t, 3), calib).reshape(b, r, t, 3)
        uv = xyz[..., :2]
        uv0 = uv[..., :1, :]
        duv = uv[..., -1:, :] - uv0
        denom = (duv * duv).sum(-1)
        alpha = torch.where(denom > 1e-12, ((uv - uv0) * duv).sum(-1)
                            / torch.clamp(denom, min=1e-12),
                            torch.zeros_like(denom))
        pos_k = _constant(_anchor_positions, (k,), uv.device, torch.float32)
        uv_k = uv0 + pos_k[:, None] * duv
        feat_k = torch.cat([index(f, uv_k.reshape(b, r * k, 2)) for f in feats],
                           dim=-1).reshape(b, r, k, -1)
        pos = alpha[..., None] * (k - 1) - torch.arange(
            k, dtype=torch.float32, device=uv.device)
        w = torch.clamp(1.0 - torch.abs(pos), min=0.0)
        x = torch.cat([torch.matmul(w, feat_k),
                       (xyz[..., 2] * Z_SCALE)[..., None]], dim=-1)
        pred = self.surface_classifier(x.reshape(b, r * t, -1)).reshape(
            b, r, t, -1)
        return in_image(uv[..., 0], uv[..., 1])[..., None].to(pred.dtype) * pred
