"""Frame sources: webcam / video / image-list streamers (the port's copy of
``monoport_tpu/pipeline/streamer.py``; host-side numpy).

Plain Python iterators yielding float32 numpy RGB frames [H, W, 3] in
[0, 1], centre-cropped (or letterboxed) and resized to ``size``. cv2 is
optional (gated import); ImageListStreamer falls back to PIL.
"""

from __future__ import annotations

import glob
import os
from typing import Iterator, Sequence

import numpy as np

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None


def _center_square_resize(img: np.ndarray, size: int,
                          pad: bool = False) -> np.ndarray:
    h, w = img.shape[:2]
    if pad:  # letterbox to square instead of cropping (streamer pad=True)
        s = max(h, w)
        canvas = np.zeros((s, s, img.shape[2]), img.dtype)
        y0, x0 = (s - h) // 2, (s - w) // 2
        canvas[y0:y0 + h, x0:x0 + w] = img
        img = canvas
    else:
        s = min(h, w)
        y0, x0 = (h - s) // 2, (w - s) // 2
        img = img[y0:y0 + s, x0:x0 + s]
    if cv2 is not None:
        img = cv2.resize(img, (size, size), interpolation=cv2.INTER_AREA)
    else:  # pragma: no cover
        from PIL import Image
        img = np.asarray(Image.fromarray(img).resize((size, size)))
    return img


def _to_float_rgb(img_bgr_or_rgb: np.ndarray, bgr: bool) -> np.ndarray:
    img = img_bgr_or_rgb[..., ::-1] if bgr else img_bgr_or_rgb
    return np.ascontiguousarray(img).astype(np.float32) / 255.0


class CaptureStreamer:
    """Webcam frames (streamer_pytorch.CaptureStreamer equivalent)."""

    def __init__(self, device: int = 0, size: int = 512, pad: bool = False):
        assert cv2 is not None, "cv2 required for camera capture"
        self.device = device
        self.size = size
        self.pad = pad

    def __iter__(self) -> Iterator[np.ndarray]:
        cap = cv2.VideoCapture(self.device)
        try:
            while True:
                ok, frame = cap.read()
                if not ok:
                    return
                yield _center_square_resize(
                    _to_float_rgb(frame, bgr=True), self.size, self.pad)
        finally:
            cap.release()


class VideoListStreamer:
    """Frames from a list of video files."""

    def __init__(self, files: Sequence[str], size: int = 512):
        assert cv2 is not None, "cv2 required for video decoding"
        self.files = list(files)
        self.size = size

    def __iter__(self) -> Iterator[np.ndarray]:
        for path in self.files:
            cap = cv2.VideoCapture(path)
            try:
                while True:
                    ok, frame = cap.read()
                    if not ok:
                        break
                    yield _center_square_resize(
                        _to_float_rgb(frame, bgr=True), self.size)
            finally:
                cap.release()


class ImageListStreamer:
    """Frames from a list of image files (the headless input mode)."""

    def __init__(self, files: Sequence[str], size: int = 512):
        self.files = list(files)
        self.size = size

    def __iter__(self) -> Iterator[np.ndarray]:
        for path in self.files:
            if cv2 is not None:
                img = cv2.imread(path, cv2.IMREAD_COLOR)
                if img is None:
                    raise FileNotFoundError(path)
                img = _to_float_rgb(img, bgr=True)
            else:  # pragma: no cover
                from PIL import Image
                img = np.asarray(Image.open(path).convert("RGB"))
                img = img.astype(np.float32) / 255.0
            yield _center_square_resize(img, self.size)


def open_stream(camera: bool = False, videos: Sequence[str] = (),
                images: Sequence[str] = (), image_folder: str | None = None,
                loop: bool = False, size: int = 512):
    """CLI-style source selection: camera, videos, images, or a folder's
    *.jpg then *.png files; ``loop`` repeats the list."""
    if camera:
        return CaptureStreamer(size=size)
    if videos:
        return VideoListStreamer(list(videos) * (10 if loop else 1),
                                 size=size)
    if images:
        return ImageListStreamer(list(images) * (10000 if loop else 1),
                                 size=size)
    if image_folder is not None:
        files = sorted(glob.glob(os.path.join(image_folder, "*.jpg")))
        files += sorted(glob.glob(os.path.join(image_folder, "*.png")))
        return ImageListStreamer(files * (10 if loop else 1), size=size)
    raise ValueError("no input source specified")
