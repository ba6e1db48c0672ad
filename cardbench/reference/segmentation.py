"""The benchmark's plain reference of the served demo's segment stage: the
matte of a frame and the region it is kept in, in plain PyTorch, float32
(TF32 off), from the committed checkpoints read with numpy.

MatteNet, a U-Net (four stride-2 encoder blocks, a bottleneck, four
decoder blocks on the skips, each decoder first upsampling by two with
bilinear half-pixel sampling), gives the matte's logits of the frame in
[-1, 1]. DetectNet, a strided encoder to a grid of 1/16 the frame with
three 1x1 heads (centre logit, log box size, sub-cell offset), gives the
person boxes: the cells that are the maximum of their 3x3 neighbourhood,
the four best by score (the lowest cell first among ties), each box its
cell's centre plus offset, exp(size) cells wide. The region is the union
of the boxes scoring over 0.3, padded by 0.15 of its size and clipped to
the frame, else the fixed prior box; the alpha is the matte's sigmoid
inside the region (edges included) and 0 outside. Every block is a 3x3
convolution without bias under flax's "SAME" padding (the smaller half
before), a GroupNorm of min(groups, C) groups (eps 1e-5) and a ReLU.
Imports nothing of the system under test.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F

PRIOR_BOX = (50.0, 0.0, 450.0, 500.0)
MIN_PROB = 0.3
BOX_PAD = 0.15
MAX_DET = 4


def load_npz(path: str, device) -> tuple[dict, dict]:
    """(params by '/'-joined name without the 'params/' root, f32 on
    ``device``; the ``__meta__`` integers)."""
    params, meta = {}, {}
    with np.load(path) as data:
        for name in data.files:
            if name.startswith("__"):
                meta[name.strip("_")] = int(data[name])
                continue
            key = name[len("params/"):] if name.startswith("params/") else name
            params[key] = torch.as_tensor(np.asarray(data[name], np.float32),
                                          device=device)
    return params, meta


def _same(x: torch.Tensor, k: int, stride: int) -> torch.Tensor:
    pads = []
    for n in (x.shape[3], x.shape[2]):
        total = max((-(-n // stride) - 1) * stride + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


def _same_value(x: torch.Tensor) -> torch.Tensor:
    return x


def _conv(p: dict, name: str, x: torch.Tensor, stride: int = 1,
          rnd=_same_value):
    """flax Conv ``name`` (HWIO kernel, optional bias) under SAME padding,
    on input and kernel rounded by ``rnd``."""
    k = p[f"{name}/kernel"]
    return F.conv2d(rnd(_same(x, k.shape[0], stride)),
                    rnd(k.permute(3, 2, 0, 1)), p.get(f"{name}/bias"),
                    stride=stride)


def _block(p: dict, name: str, x: torch.Tensor, stride: int,
           max_groups: int, rnd=_same_value) -> torch.Tensor:
    x = _conv(p, f"{name}/Conv_0", x, stride, rnd)
    c = x.shape[1]
    x = F.group_norm(x, min(max_groups, c), p[f"{name}/GroupNorm_0/scale"],
                     p[f"{name}/GroupNorm_0/bias"], eps=1e-5)
    return torch.relu(x)


def upsample2(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """NCHW bilinear resize to [h, w] with half-pixel centres, the source
    index clamped at the edges."""
    def axis(n_in, n_out):
        src = ((torch.arange(n_out, dtype=torch.float32, device=x.device)
                + 0.5) * (n_in / n_out) - 0.5).clamp(min=0.0)
        i0 = src.floor().long().clamp(max=n_in - 1)
        i1 = (i0 + 1).clamp(max=n_in - 1)
        return i0, i1, src - i0
    y0, y1, fy = axis(x.shape[2], h)
    x0, x1, fx = axis(x.shape[3], w)
    rows = (x[:, :, y0] * (1 - fy)[:, None] + x[:, :, y1] * fy[:, None])
    return rows[..., x0] * (1 - fx) + rows[..., x1] * fx


def matte_logits(p: dict, x: torch.Tensor, rnd=_same_value) -> torch.Tensor:
    """MatteNet: [B, H, W, 3] in [-1, 1] -> [B, H, W] logits."""
    x = x.permute(0, 3, 1, 2)
    skips = []
    for i in range(4):
        x = _block(p, f"_ConvBNRelu_{2 * i}", x, 1, 32, rnd)
        skips.append(x)
        x = _block(p, f"_ConvBNRelu_{2 * i + 1}", x, 2, 32, rnd)
    x = _block(p, "_ConvBNRelu_8", x, 1, 32, rnd)
    for i, skip in enumerate(reversed(skips)):
        x = upsample2(x, skip.shape[2], skip.shape[3])
        x = _block(p, f"_ConvBNRelu_{9 + i}", torch.cat([x, skip], 1), 1, 32,
                   rnd)
    return _conv(p, "Conv_0", x, 1, rnd)[:, 0]


def detect(p: dict, meta: dict, x: torch.Tensor, rnd=_same_value):
    """DetectNet and its decode: [B, S, S, 3] in [-1, 1] -> (boxes [B, 4,
    4] xyxy pixels, scores [B, 4]), best first."""
    stride = meta.get("stride", 16)
    n_blocks = 2 * int(np.log2(stride)) + 1
    f = x.permute(0, 3, 1, 2)
    for i in range(n_blocks):
        f = _block(p, f"_ConvGNRelu_{i}", f, 2 if i < n_blocks - 1 and
                   i % 2 == 0 else 1, 16, rnd)
    heat, size, off = (_conv(p, f"Conv_{k}", f, 1, rnd) for k in range(3))
    b, _, g, _ = heat.shape
    prob = torch.sigmoid(heat[:, 0])
    peak = F.max_pool2d(prob[:, None], 3, stride=1, padding=1)[:, 0]
    score = torch.where(prob >= peak, prob, 0.0).reshape(b, g * g)
    order = torch.sort(score, dim=1, descending=True, stable=True)
    top, idx = order.values[:, :MAX_DET], order.indices[:, :MAX_DET]
    iy, ix = idx // g, idx % g
    bi = torch.arange(b, device=x.device)[:, None]
    cx = (ix + 0.5 + off[bi, 0, iy, ix]) * stride
    cy = (iy + 0.5 + off[bi, 1, iy, ix]) * stride
    half_w = torch.exp(size[bi, 0, iy, ix].clamp(-4.0, 4.0)) * stride / 2
    half_h = torch.exp(size[bi, 1, iy, ix].clamp(-4.0, 4.0)) * stride / 2
    boxes = torch.stack([cx - half_w, cy - half_h, cx + half_w, cy + half_h],
                        dim=-1)
    return boxes, top


def region(boxes: torch.Tensor, scores: torch.Tensor, s: int) -> torch.Tensor:
    """[B, 4]: the union of the confident boxes, padded and clipped; the
    prior box where none is confident."""
    out = []
    for bx, sc in zip(boxes, scores):
        conf = bx[sc > MIN_PROB]
        if len(conf) == 0:
            out.append(torch.tensor(PRIOR_BOX, device=boxes.device))
            continue
        x1, y1 = conf[:, 0].min(), conf[:, 1].min()
        x2, y2 = conf[:, 2].max(), conf[:, 3].max()
        w, h = x2 - x1, y2 - y1
        out.append(torch.stack([x1 - BOX_PAD * w, y1 - BOX_PAD * h,
                                x2 + BOX_PAD * w, y2 + BOX_PAD * h]
                               ).clamp(0.0, s - 1.0))
    return torch.stack(out)


class Segmenter:
    """The segment stage's reference: images [B, H, W, 3] in [0, 1] ->
    alpha [B, H, W] in [0, 1]. ``rnd``: the rounding of every
    convolution's input and kernel (none; the control's, one precision
    step below f32)."""

    def __init__(self, matte_path: str, detect_path: str, device,
                 rnd=_same_value):
        self.matte, _ = load_npz(matte_path, device)
        self.det, self.det_meta = load_npz(detect_path, device)
        self.rnd = rnd

    @torch.no_grad()
    def __call__(self, images: torch.Tensor) -> torch.Tensor:
        x = images.float() * 2.0 - 1.0
        b, h, w, _ = x.shape
        box = region(*detect(self.det, self.det_meta, x, self.rnd), h)
        ys = torch.arange(h, dtype=torch.float32, device=x.device)
        xs = torch.arange(w, dtype=torch.float32, device=x.device)
        inside = ((xs[None, None] >= box[:, 0, None, None])
                  & (xs[None, None] <= box[:, 2, None, None])
                  & (ys[None, :, None] >= box[:, 1, None, None])
                  & (ys[None, :, None] <= box[:, 3, None, None]))
        return torch.sigmoid(matte_logits(self.matte, x, self.rnd)) \
            * inside.float()


def segmenter(serve: dict, root: str, device, rnd=_same_value) -> Segmenter:
    """The reference segmenter of a configuration's ``serve`` entry."""
    return Segmenter(os.path.join(root, serve["mattenet"]),
                     os.path.join(root, serve["detectnet"]), device, rnd)
