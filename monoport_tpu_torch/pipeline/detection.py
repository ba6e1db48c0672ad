"""Person detection (port of ``monoport_tpu/pipeline/detection.py``,
inference): the region the segmenter focuses on.

Anchor-free centre-point detection: a small strided conv encoder (flax
"SAME" padding reproduced exactly: a 3x3 stride-2 convolution on an even
input pads one row and column below / right, none above / left) to a
G = S / stride grid with three 1x1 heads (centre heatmap, log box size,
sub-cell offset), decoded by a 3x3 max-pool peak test and the top k by a
stable sort (the lowest index first among equal scores, as ``lax.top_k``).
Static shapes, no host sync. The training loss is
``training/detection.detection_loss``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..weights import load_module, load_params

STRIDE = 16
MAX_DET = 4  # instance slots


def same_pad(x: torch.Tensor, k: int, stride: int) -> torch.Tensor:
    """flax ``padding="SAME"`` on NCHW: total max((ceil(n/s) - 1) s + k - n,
    0) per spatial axis, the smaller half before."""
    pads = []
    for n in (x.shape[3], x.shape[2]):                 # W then H (F.pad order)
        total = max((-(-n // stride) - 1) * stride + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads) if any(pads) else x


class ConvNormRelu(nn.Module):
    """3x3 conv (no bias, SAME) -> GroupNorm(min(max_groups, C), eps 1e-5)
    -> ReLU; NCHW. Its children carry the flax names."""

    def __init__(self, cin: int, features: int, stride: int = 1,
                 max_groups: int = 16):
        super().__init__()
        self.stride = stride
        self.Conv_0 = nn.Conv2d(cin, features, 3, stride=stride, bias=False)
        self.GroupNorm_0 = nn.GroupNorm(min(max_groups, features), features,
                                        eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.Conv_0(same_pad(x, 3, self.stride))
        return F.relu(self.GroupNorm_0(x))


class DetectNet(nn.Module):
    """[B,S,S,3] (in [-1,1]) -> (heat [B,G,G,1] logits, size [B,G,G,2] (log
    w, h in grid units), offset [B,G,G,2]), G = S // stride; NHWC in and out,
    NCHW inside."""

    def __init__(self, width: int = 16, stride: int = 16):
        super().__init__()
        n_down = int(math.log2(stride))
        if not (2 ** n_down == stride and 2 <= n_down <= 4):
            raise ValueError(f"stride {stride}: a power of two, 4 to 16")
        w, cin, i = width, 3, 0
        for mult in (1, 2, 4, 4)[:n_down]:
            for s in (2, 1):
                setattr(self, f"_ConvGNRelu_{i}",
                        ConvNormRelu(cin, w * mult, stride=s))
                cin, i = w * mult, i + 1
        setattr(self, f"_ConvGNRelu_{i}", ConvNormRelu(cin, w * 4))
        self.n_blocks = i + 1
        self.Conv_0 = nn.Conv2d(w * 4, 1, 1)
        self.Conv_1 = nn.Conv2d(w * 4, 2, 1)
        self.Conv_2 = nn.Conv2d(w * 4, 2, 1)

    def forward(self, x: torch.Tensor):
        x = x.permute(0, 3, 1, 2)
        for i in range(self.n_blocks):
            x = getattr(self, f"_ConvGNRelu_{i}")(x)
        nhwc = lambda t: t.permute(0, 2, 3, 1)
        return nhwc(self.Conv_0(x)), nhwc(self.Conv_1(x)), nhwc(self.Conv_2(x))


def gaussian_heatmap(cx, cy, w, h, valid, g: int):
    """Splat per-instance Gaussians -> [B,G,G] target heatmap. cx/cy/w/h
    [B,K] in grid units; sigma ~1/6 of the smaller box side; the cell
    containing each centre is snapped to exactly 1."""
    dev = cx.device
    ys = torch.arange(g, dtype=torch.float32, device=dev) + 0.5
    xs = torch.arange(g, dtype=torch.float32, device=dev) + 0.5
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")              # [G,G]
    sigma = torch.clamp(torch.minimum(w, h) / 6.0, min=0.75)    # [B,K]
    d2 = ((gx[None, None] - cx[..., None, None]) ** 2
          + (gy[None, None] - cy[..., None, None]) ** 2)        # [B,K,G,G]
    heat = torch.exp(-d2 / (2.0 * sigma[..., None, None] ** 2))
    ii = torch.arange(g, dtype=torch.float32, device=dev)
    in_x = (torch.floor(cx.clamp(0, g - 1))[..., None, None]
            == ii[None, None, None, :])                         # [B,K,1,G]
    in_y = (torch.floor(cy.clamp(0, g - 1))[..., None, None]
            == ii[None, None, :, None])                         # [B,K,G,1]
    heat = torch.maximum(heat, (in_x & in_y).to(heat.dtype))
    heat = heat * valid[..., None, None].to(heat.dtype)
    return heat.amax(dim=1)                                     # [B,G,G]


def decode(heat, size, off, stride: int = STRIDE, k: int = MAX_DET):
    """Head outputs -> (boxes [B,k,4] xyxy pixels, probs [B,k]): the cells
    that survive the 3x3 max-pool test, the top k by score (a stable
    descending sort: the lowest index first among ties, as ``lax.top_k``)."""
    b, g = heat.shape[:2]
    p = torch.sigmoid(heat[..., 0])                              # [B,G,G]
    pmax = F.max_pool2d(p[:, None], 3, stride=1, padding=1)[:, 0]
    score = torch.where(p >= pmax, p, torch.zeros_like(p)).reshape(b, g * g)
    order = torch.sort(score, dim=1, descending=True, stable=True)
    top, idx = order.values[:, :k], order.indices[:, :k]
    iy, ix = idx // g, idx % g
    bi = torch.arange(b, device=heat.device)[:, None]
    ox, oy = off[bi, iy, ix, 0], off[bi, iy, ix, 1]
    wg = torch.exp(size[bi, iy, ix, 0].clamp(-4.0, 4.0))
    hg = torch.exp(size[bi, iy, ix, 1].clamp(-4.0, 4.0))
    cx = (ix + 0.5 + ox) * stride
    cy = (iy + 0.5 + oy) * stride
    boxes = torch.stack([cx - wg * stride / 2, cy - hg * stride / 2,
                         cx + wg * stride / 2, cy + hg * stride / 2], dim=-1)
    return boxes, top


class Detection:
    """images [B,S,S,3] in [0,1] -> (boxes [B,MAX_DET,4] xyxy px, probs
    [B,MAX_DET]), by score descending. ``variables``: DetectNet's flax
    params tree (numpy leaves), carried across by ``weights.load_module``.
    ``device``: None = ``cuda`` (raises when CUDA is absent)."""

    def __init__(self, variables, width: int = 16, stride: int = STRIDE,
                 device=None):
        self.stride = stride
        self.net = load_module(DetectNet(width=width, stride=stride),
                               variables, device)
        self.device = next(self.net.parameters()).device

    @classmethod
    def load_default(cls, ckpt_path: Optional[str] = None, device=None
                     ) -> Optional["Detection"]:
        """The detector on the committed weights (``detectnet.npz``); None
        if the checkpoint is absent."""
        import os

        from ..weights import DATA

        ckpt_path = ckpt_path or os.path.join(DATA, "detectnet.npz")
        if not os.path.exists(ckpt_path):
            return None
        params, meta = load_params(ckpt_path)
        return cls(params, width=meta.get("width", 16),
                   stride=meta.get("stride", 16), device=device)

    def heads(self, images: torch.Tensor):
        with torch.inference_mode():
            return self.net(images.to(self.device) * 2.0 - 1.0)

    def __call__(self, images: torch.Tensor):
        return decode(*self.heads(images), stride=self.stride)

    def person_box(self, images: torch.Tensor, pad: float = 0.15,
                   min_prob: float = 0.3,
                   fallback: Optional[torch.Tensor] = None) -> torch.Tensor:
        """[B,S,S,3] -> [B,4] one detection region for the segmenter: the
        union of the confident instance boxes, padded by ``pad`` x its
        size, clipped to the frame; ``fallback`` (or the full frame) when
        nothing is confident."""
        s = images.shape[1]
        boxes, probs = self(images)
        if fallback is None:   # the full frame, made on the device (no copy)
            fallback = torch.full((4,), s - 1.0, device=boxes.device)
            fallback[:2] = 0.0
        fallback = torch.as_tensor(fallback, dtype=torch.float32,
                                   device=boxes.device)
        conf = probs > min_prob                                  # [B,K]
        big = 1e9
        lo = lambda c: torch.where(conf, boxes[..., c], big).amin(dim=1)
        hi = lambda c: torch.where(conf, boxes[..., c], -big).amax(dim=1)
        x1, y1, x2, y2 = lo(0), lo(1), hi(2), hi(3)
        w, h = x2 - x1, y2 - y1
        out = torch.stack([x1 - pad * w, y1 - pad * h,
                           x2 + pad * w, y2 + pad * h], dim=-1)
        out = out.clamp(0.0, s - 1.0)
        found = conf.any(dim=1)[:, None]
        return torch.where(found, out, fallback.expand_as(out))
