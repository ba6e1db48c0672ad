"""Human segmentation / matting (port of
``monoport_tpu/pipeline/segmentation.py``, inference).

``Segmentation(images [B,H,W,3] in [0,1]) -> (segm [B,H,W,4], bboxes [B,4],
probs [B])``: segm channels 0:3 are the RGB in [-1, 1], channel 3 the alpha
matte in [0, 1], the product of ``MatteNet``'s matte and the detection
region's box (``DetectNet``'s person box when the detector is loaded, else
a fixed prior box; without MatteNet weights the box alone). bboxes /
probs: the matte's own extent and mean confidence. NHWC in and out, NCHW
inside; MatteNet's decoder upsamples by exactly 2 with bilinear
half-pixel sampling (``jax.image.resize``'s, and ``F.interpolate``'s with
``align_corners=False`` there). ``matting_loss`` (and the BCE it is built
on, ``optax_sigmoid_bce``) trains MatteNet (``training/matting.py``).
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..weights import DATA, load_module, load_params, resolve_device
from .detection import ConvNormRelu, Detection, same_pad


class MatteNet(nn.Module):
    """U-Net alpha-matte network: [B, H, W, 3] -> [B, H, W, 1] logits (H, W
    multiples of 16)."""

    def __init__(self, width: int = 32):
        super().__init__()
        w = width
        block = lambda i, cin, cout, s=1: setattr(
            self, f"_ConvBNRelu_{i}", ConvNormRelu(cin, cout, s, 32))
        cin = 3
        for i, mult in enumerate((1, 2, 4, 8)):
            block(2 * i, cin, w * mult)
            block(2 * i + 1, w * mult, w * mult, 2)
            cin = w * mult
        block(8, w * 8, w * 8)
        for i, (mult, skip) in enumerate(zip((8, 4, 2, 1), (8, 4, 2, 1))):
            block(9 + i, cin + w * skip, w * mult)
            cin = w * mult
        self.Conv_0 = nn.Conv2d(w, 1, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        blk = lambda i: getattr(self, f"_ConvBNRelu_{i}")
        x = x.permute(0, 3, 1, 2)
        skips = []
        for i in range(4):
            x = blk(2 * i)(x)
            skips.append(x)
            x = blk(2 * i + 1)(x)
        x = blk(8)(x)
        for i, skip in enumerate(reversed(skips)):
            x = F.interpolate(x, size=skip.shape[2:], mode="bilinear",
                              align_corners=False)
            x = blk(9 + i)(torch.cat([x, skip], dim=1))
        return self.Conv_0(same_pad(x, 3, 1)).permute(0, 2, 3, 1)


def alpha_to_bbox(alpha: torch.Tensor, threshold: float = 0.5):
    """[B, H, W] alpha -> ([B, 4] xyxy bbox, [B] mean confidence over the
    pixels above ``threshold``); zeros where nothing is."""
    b, h, w = alpha.shape
    mask = alpha > threshold
    any_row = mask.any(dim=2)            # [B, H]
    any_col = mask.any(dim=1)            # [B, W]
    rows = torch.arange(h, device=alpha.device)
    cols = torch.arange(w, device=alpha.device)
    big = torch.iinfo(torch.int32).max
    y1 = torch.where(any_row, rows, big).amin(dim=1)
    y2 = torch.where(any_row, rows, -1).amax(dim=1)
    x1 = torch.where(any_col, cols, big).amin(dim=1)
    x2 = torch.where(any_col, cols, -1).amax(dim=1)
    found = any_row.any(dim=1)
    bbox = torch.stack([x1, y1, x2, y2], dim=1)
    bbox = torch.where(found[:, None], bbox, 0).float()
    denom = mask.flatten(1).sum(dim=1).clamp(min=1)
    probs = torch.where(found, alpha.flatten(1).sum(dim=1) / denom, 0.0)
    return bbox, probs


def _box_mask(box: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """[B, 4] xyxy boxes -> [B, H, W] 0/1 inside masks (edges included)."""
    ys = torch.arange(h, dtype=torch.float32, device=box.device)[None, :, None]
    xs = torch.arange(w, dtype=torch.float32, device=box.device)[None, None, :]
    x1, y1, x2, y2 = (box[:, i, None, None] for i in range(4))
    return ((xs >= x1) & (xs <= x2) & (ys >= y1) & (ys <= y2)).float()


class Segmentation:
    """The segmenter (NHWC).

    Args:
      variables: MatteNet's flax params tree (numpy leaves); None -> the
        box alone.
      scaled_boxes: the default detection-region prior [4] xyxy (the
        demo's [50, 0, 450, 500] on 512x512 frames).
      detector: optional ``Detection``; when set and no boxes are passed
        per call, the region is its person box.
      device: None = ``cuda`` (raises when CUDA is absent); pass ``"cpu"``
        to run on the CPU.
    """

    def __init__(self, variables=None, width: int = 32,
                 scaled_boxes: Optional[Sequence[float]] = None,
                 detector: Optional[Detection] = None, device=None):
        self.net = (load_module(MatteNet(width=width), variables, device)
                    if variables is not None else None)
        self.detector = detector
        self.device = resolve_device(device)
        self.default_box = torch.tensor(
            [scaled_boxes or [50.0, 0.0, 450.0, 500.0]], dtype=torch.float32,
            device=self.device)

    @classmethod
    def load_default(cls, ckpt_path: Optional[str] = None,
                     scaled_boxes: Optional[Sequence[float]] = None,
                     device=None) -> "Segmentation":
        """The segmenter on MatteNet's checkpoint (default: the committed
        ``mattenet.npz``) and the committed detector; the box prior where a
        checkpoint is absent."""
        ckpt_path = ckpt_path or os.path.join(DATA, "mattenet.npz")
        detector = Detection.load_default(device=device)
        if not os.path.exists(ckpt_path):
            return cls(variables=None, scaled_boxes=scaled_boxes,
                       detector=detector, device=device)
        params, meta = load_params(ckpt_path)
        return cls(variables=params, width=meta["width"],
                   scaled_boxes=scaled_boxes, detector=detector,
                   device=device)

    def logits(self, images: torch.Tensor) -> torch.Tensor:
        """MatteNet's [B, H, W, 1] logits of images in [0, 1]."""
        with torch.inference_mode():
            return self.net(images.to(self.device) * 2.0 - 1.0)

    def __call__(self, images: torch.Tensor, scaled_boxes=None):
        """images: [B, H, W, 3] RGB in [0, 1] -> (segm [B, H, W, 4],
        bboxes [B, 4], probs [B])."""
        with torch.inference_mode():
            images = images.to(self.device)
            if scaled_boxes is not None:
                boxes = torch.as_tensor(scaled_boxes, dtype=torch.float32,
                                        device=self.device)
            elif self.detector is not None:
                boxes = self.detector.person_box(
                    images, fallback=self.default_box[0])
            else:
                boxes = self.default_box
            b, h, w, _ = images.shape
            boxes = boxes.reshape(-1, 4).expand(b, 4)
            alpha = _box_mask(boxes, h, w)
            if self.net is not None:
                alpha = torch.sigmoid(self.logits(images)[..., 0]) * alpha
            segm = torch.cat([images * 2.0 - 1.0, alpha[..., None]], dim=-1)
            bbox, probs = alpha_to_bbox(alpha)
            return segm, bbox, probs


def optax_sigmoid_bce(logits: torch.Tensor,
                      labels: torch.Tensor) -> torch.Tensor:
    """Elementwise sigmoid binary cross-entropy, as
    ``optax.sigmoid_binary_cross_entropy``: -labels log sigmoid(x) -
    (1 - labels) log sigmoid(-x)."""
    return (-labels * F.logsigmoid(logits)
            - (1.0 - labels) * F.logsigmoid(-logits))


def matting_loss(net: MatteNet, images: torch.Tensor,
                 alpha_gt: torch.Tensor) -> torch.Tensor:
    """MatteNet's training loss on images [B, H, W, 3] in [0, 1] and mattes
    [B, H, W]: the mean BCE of the logits plus half the mean absolute
    difference of the edge magnitudes |diff| along W and along H."""
    logits = net(images * 2.0 - 1.0)[..., 0]
    bce = optax_sigmoid_bce(logits, alpha_gt).mean()
    alpha = torch.sigmoid(logits)
    gx = (torch.abs(torch.diff(alpha, dim=2))
          - torch.abs(torch.diff(alpha_gt, dim=2)))
    gy = (torch.abs(torch.diff(alpha, dim=1))
          - torch.abs(torch.diff(alpha_gt, dim=1)))
    return bce + 0.5 * (torch.abs(gx).mean() + torch.abs(gy).mean())
