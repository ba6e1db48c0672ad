"""The one generator of every traffic mix: a traffic file's parameters and
a seed -> the images, the calibs and the order the window shows them in.

A mix is ``bodies`` capsule bodies drawn from the seed on the device
(``capsule.body`` under the file's ``body`` distribution) and rendered
at the configuration's input size, and a camera: ``identity`` (the
frontal view) or ``orbit`` (the demo's auto-orbit: a fixed yaw, the pitch
stepping by ``pitch_step`` degrees a frame through ``poses`` poses, from a
start pose drawn from the seed). Frame i shows body i mod bodies from pose
(start + i) mod poses, so every seed runs the same poses, in another
order. ``hint``: ``previous_valid`` feeds each frame the compaction hint
of the previous frame's valid fraction, as the demo app does.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from . import capsule

_PIFU = np.diag([1.0, -1.0, 1.0, 1.0])


def _rotate(rx: float, ry: float) -> np.ndarray:
    sx, sy = math.sin(rx), math.sin(ry)
    cx, cy = math.cos(rx), math.cos(ry)
    r_x = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    r_y = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    return r_x @ r_y


def orbit_calib(yaw_deg: float, pitch_deg: float) -> np.ndarray:
    """[1, 4, 4] calib of the orbit camera (yaw about x, then pitch about
    y) over the scene's orthographic intrinsic, through the PIFu y-flip."""
    ext = np.eye(4)
    ext[:3, :3] = _rotate(math.radians(yaw_deg), 0.0) @ _rotate(
        0.0, math.radians(pitch_deg))
    return np.linalg.inv(ext @ _PIFU)[None].astype(np.float32)


@dataclasses.dataclass
class Traffic:
    images: torch.Tensor          # [bodies, S, S, 3] f32 on the device
    calibs: list                  # [1, 4, 4] float32 host arrays, by pose
    start: int                    # the first frame's pose
    hint: str | None

    def frame(self, i: int) -> tuple[int, int]:
        """(body, pose) of frame i."""
        return i % len(self.images), (self.start + i) % len(self.calibs)


def generate(spec: dict, seed: int, size: int, device) -> Traffic:
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    n = spec["bodies"]
    u = torch.rand((n, capsule.N_UNIFORMS), generator=gen, device=device)
    images = torch.stack([capsule.render_front(*capsule.body(u[i],
                                                             spec["body"]),
                                               size) for i in range(n)])
    cam = spec["camera"]
    rng = np.random.default_rng(int(seed))
    if cam["kind"] == "identity":
        calibs, start = [np.eye(4, dtype=np.float32)[None]], 0
    elif cam["kind"] == "orbit":
        calibs = [orbit_calib(cam["yaw"], cam["pitch_step"] * k)
                  for k in range(cam["poses"])]
        start = int(rng.integers(cam["poses"]))
    else:
        raise ValueError(f"unknown camera {cam['kind']!r}")
    return Traffic(images, calibs, start, spec.get("hint"))
