"""Dataset utilities: numpy projection, image loading + augmentation (a
copy of ``monoport_tpu/training/datasets/utils.py``).

Reference contract: monoport/lib/dataset/utils.py — PIL pipeline of
ColorJitter -> CenterCrop(512/scale) -> Resize(512) -> Normalize, random
Gaussian blur, mask from alpha or file, image pre-multiplied by mask>0.5.
Implemented with PIL only (no torchvision in this environment); color
jitter uses PIL ImageEnhance with the same (1±aug) factor ranges.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


def projection(points: np.ndarray, calib: np.ndarray) -> np.ndarray:
    """[N, 3] x [4, 4] -> [N, 3] (reference dataset/utils.py:10-12)."""
    return points @ calib[:3, :3].T + calib[:3, 3]


@dataclasses.dataclass
class AugConfig:
    aug_bri: float = 0.4
    aug_con: float = 0.4
    aug_sat: float = 0.4
    aug_hue: float = 0.0
    blur: float = 1.0


def load_image(image_path: str, mask_path: Optional[str] = None,
               crop_size: int = 512, input_size: int = 512,
               mean: tuple = (0.5, 0.5, 0.5), std: tuple = (0.5, 0.5, 0.5),
               blur: float = 0.0, brightness: float = 0.0,
               contrast: float = 0.0, saturation: float = 0.0,
               hue: float = 0.0, rng: Optional[np.random.RandomState] = None):
    """-> (image [H, W, 3] normalized float32, mask [H, W, 1] float32).

    NHWC analog of reference dataset/utils.py:14-71: jitter -> blur ->
    center crop(crop_size) -> resize(input_size) -> normalize -> premultiply
    by mask>0.5.
    """
    from PIL import Image, ImageEnhance, ImageFilter

    rng = rng or np.random.RandomState()
    img = Image.open(image_path)

    if mask_path is not None:
        mask = Image.open(mask_path).convert("L")
        img = img.convert("RGB")
    else:
        assert img.mode == "RGBA", f"need alpha for mask: {image_path}"
        mask = img.split()[-1]
        img = img.convert("RGB")

    # color jitter (factor ranges match torchvision semantics)
    for aug, enhancer in ((brightness, ImageEnhance.Brightness),
                          (contrast, ImageEnhance.Contrast),
                          (saturation, ImageEnhance.Color)):
        if aug > 0:
            img = enhancer(img).enhance(
                rng.uniform(max(0.0, 1 - aug), 1 + aug))
    if hue > 0:
        h, s, v = img.convert("HSV").split()
        shift = int(rng.uniform(-hue, hue) * 255)
        h = h.point(lambda px: (px + shift) % 256)
        img = Image.merge("HSV", (h, s, v)).convert("RGB")
    if blur > 0 and rng.rand() < 0.5:
        img = img.filter(ImageFilter.GaussianBlur(rng.uniform(0, blur)))

    def center_crop(im, size):
        w, h = im.size
        x0 = (w - size) // 2
        y0 = (h - size) // 2
        return im.crop((x0, y0, x0 + size, y0 + size))

    img = center_crop(img, crop_size).resize((input_size, input_size),
                                             Image.BILINEAR)
    mask = center_crop(mask, crop_size).resize((input_size, input_size),
                                               Image.NEAREST)

    image = np.asarray(img, np.float32) / 255.0
    image = (image - np.asarray(mean, np.float32)) / np.asarray(
        std, np.float32)
    m = (np.asarray(mask, np.float32) / 255.0 > 0.5).astype(np.float32)
    image = image * m[..., None]
    return image, m[..., None]


def make_batches(dataset, batch_size: int, shuffle: bool = True,
                 seed: int = 0, drop_last: bool = True):
    """Minimal batcher: dataset[i] -> dict of arrays; yields stacked dicts."""
    idx = np.arange(len(dataset))
    if shuffle:
        np.random.RandomState(seed).shuffle(idx)
    n = (len(idx) // batch_size) * batch_size if drop_last else len(idx)
    for s in range(0, n, batch_size):
        items = [dataset[int(i)] for i in idx[s:s + batch_size]]
        yield {k: np.stack([it[k] for it in items]) for k in items[0]}
