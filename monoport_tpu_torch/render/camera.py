"""The orbit camera's extrinsic (port copy of ``make_rotate`` and
``orbit_extrinsic`` of ``monoport_tpu/render/camera.py``; numpy only). The
camera classes of that file come with the render slice (ROADMAP queue 1
item 10).
"""

from __future__ import annotations

import math

import numpy as np


def make_rotate(rx: float, ry: float, rz: float) -> np.ndarray:
    """Rz @ Ry @ Rx from Euler radians."""
    sx, sy, sz = np.sin([rx, ry, rz])
    cx, cy, cz = np.cos([rx, ry, rz])
    Rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    Rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return Rz @ Ry @ Rx


def orbit_extrinsic(yaw_deg: float, pitch_deg: float,
                    distance: float = 2.0) -> np.ndarray:
    """Auto-orbit extrinsic: yaw about x then pitch about y (the demo's
    convention), the camera ``distance`` in front of the subject."""
    ext = np.eye(4, dtype=np.float32)
    ext[2, 3] = -distance
    ext[:3, :3] = make_rotate(math.radians(yaw_deg), 0, 0) @ make_rotate(
        0, math.radians(pitch_deg), 0)
    return ext
