"""The benchmark's plain reference of a frame of the served demo: what
``apps/rtl_main``'s three stages must serve for a camera frame, in plain
PyTorch, float32 (TF32 off), from the frame, its place in the stream and
the weights.

1. The segment stage: the alpha matte (``segmentation.Segmenter``), netG's
   input ((image - mean) / std) x alpha and netC's (2 image - 1) x alpha;
   the camera of the frame's place n in the stream: the scene's auto orbit
   (yaw ``yaw``, pitch ``pitch_step`` x n degrees, about x then y, the
   camera ``distance`` in front; the scene keeps the rotation in float32)
   over the scene's orthographic intrinsic, and the PIFu calib of the two.
2. The device stage: the reference frame of the configuration's profile
   (``frame.reference_frame``) at that calib and the hint given.
3. The composite stage: the floor prop (``floor.Floor``) seen by the camera
   at the scene's size; the displayed texture render (the normal render
   in the 'NORM' mode) cut to whole 1/255 steps, over the floor where the
   subject's mask is set (a pixel of the texture render, or of the normal
   render without netC, that is not white in every channel), cut to
   uint8.

Imports nothing of the system under test.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from .floor import Floor
from .frame import reference_frame
from .segmentation import segmenter

_PIFU = np.diag([1.0, -1.0, 1.0, 1.0])


def _rotation(yaw: float, pitch: float) -> np.ndarray:
    sx, cx = math.sin(math.radians(yaw)), math.cos(math.radians(yaw))
    sy, cy = math.sin(math.radians(pitch)), math.cos(math.radians(pitch))
    r_x = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    r_y = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    return r_x @ r_y


def camera(scene: dict, n: int) -> tuple[np.ndarray, np.ndarray]:
    """(extrinsic, intrinsic) of the stream's frame n."""
    cam = scene["camera"]
    ext = np.eye(4, dtype=np.float32)
    ext[2, 3] = -cam["distance"]
    ext[:3, :3] = _rotation(cam["yaw"], cam["pitch_step"] * n)
    near, far, scale = cam["near"], cam["far"], cam["scale"]
    intr = np.eye(4)
    intr[0, 0] = intr[1, 1] = 2.0 / scale
    intr[2, 2] = -2.0 / (far - near)
    intr[2, 3] = -(far + near) / (far - near)
    return ext, intr


def calib(extrinsic: np.ndarray, intrinsic: np.ndarray) -> np.ndarray:
    """[1, 4, 4] float32 PIFu calib: the inverse of the intrinsic (its z
    row scaled as x, untranslated) times the rotation times the y-flip."""
    intr = np.array(intrinsic, np.float64)
    intr[2, 2], intr[2, 3] = intr[0, 0], 0.0
    ext = np.array(extrinsic, np.float64)
    ext[2, 3] = 0.0
    return np.linalg.inv(intr @ ext @ _PIFU)[None].astype(np.float32)


def _steps(x: torch.Tensor) -> torch.Tensor:
    """[0, 1] values cut to whole 1/255 steps."""
    return torch.floor((x * 255.0).clamp(0.0, 255.0)) / 255.0


class ServedFrame:
    """``(image [1, S, S, 3] in [0, 1], n, hint) ->`` {alpha, depth, valid,
    render_norm, render_tex, mask, served (uint8), calib}, on the nets
    given (a configuration's reference nets, or its control's)."""

    def __init__(self, config: dict, nets: dict, root: str, device,
                 segment=None):
        self.config = config
        self.scene = config["serve"]
        self.segment = segment or segmenter(self.scene, root, device)
        self.frame = reference_frame(config, nets)
        tex = np.load(os.path.join(root, self.scene["floor_texture"]))
        with tex:
            texture = tex[self.scene["floor"]]
        self.floor = Floor(os.path.join(root, self.scene["floor_obj"]),
                           texture, self.scene["size"], device)
        self.mean = torch.tensor(config["netG"]["mean"], device=device)
        self.std = torch.tensor(config["netG"]["std"], device=device)

    def hint_after(self, out: dict) -> float:
        return self.frame.hint_after(out)

    @torch.no_grad()
    def __call__(self, image: torch.Tensor, n: int, hint=None) -> dict:
        alpha = self.segment(image)[..., None]
        ext, intr = camera(self.scene, n)
        c = calib(ext, intr)
        image_g = (image - self.mean) / self.std * alpha
        image_c = (image * 2.0 - 1.0) * alpha
        out = dict(self.frame(image_g, image_c, c, hint))
        tex = out.get("render_tex", out["render_norm"]).float()
        mask = (~(tex >= 1.0).all(dim=-1, keepdim=True)).float()
        shown = tex if self.scene["server_mode"] == "TEXTURE" \
            else out["render_norm"].float()
        shown = torch.nan_to_num(shown, nan=1.0)
        bg = self.floor.render(ext, intr)
        served = (mask * _steps(shown) + (1.0 - mask) * bg).clamp(0.0, 1.0)
        out.update(alpha=alpha[0, ..., 0], mask=mask[..., 0] > 0,
                   served=torch.floor(served * 255.0).to(torch.uint8),
                   calib=c)
        return out
