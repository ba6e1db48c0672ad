"""Cameras, host-side numpy (port copy of ``monoport_tpu/render/camera.py``):
the orthographic camera by magnification, the perspective camera, the
look-at pose, and the demo's orbit extrinsic."""

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


class BaseCamera:
    """Orthographic camera by x / y magnification and near / far."""

    def __init__(self):
        self.magnification_x = 1.0
        self.magnification_y = 1.0
        self.aspect_ratio = 1.0
        self.near = 0.01
        self.far = 10000.0

    def set_parameters(self, magnification_x, magnification_y=None):
        if magnification_y is None:
            magnification_y = magnification_x / self.aspect_ratio
        self.magnification_x = magnification_x
        self.magnification_y = magnification_y

    def get_projection_mat(self) -> np.ndarray:
        proj = np.eye(4)
        proj[0, 0] = 2 / self.magnification_x
        proj[1, 1] = 2 / self.magnification_y
        proj[2, 2] = -2 / (self.far - self.near)
        proj[2, 3] = -(self.far + self.near) / (self.far - self.near)
        return proj


class PerspectiveCamera(BaseCamera):
    """Perspective camera (a -1 w row); set by field of view or by a 35 mm
    equivalent focal length."""

    def get_projection_mat(self) -> np.ndarray:
        proj = np.eye(4)
        proj[0, 0] = 2 / self.magnification_x
        proj[1, 1] = 2 / self.magnification_y
        proj[2, 2] = -(self.far + self.near) / (self.far - self.near)
        proj[2, 3] = -(2 * self.far * self.near) / (self.far - self.near)
        proj[3, 2] = -1.0
        proj[3, 3] = 0.0
        return proj

    def set_by_field_of_view(self, fov_x, fov_y=None):
        if fov_y is None:
            fov_y = fov_x
        self.set_parameters(2 * math.tan(fov_x / 2), 2 * math.tan(fov_y / 2))

    def set_by_35mm_equivalent_focal_length(self, focal_x, focal_y=None):
        if focal_y is None:
            focal_y = focal_x
        film_h = math.sqrt((36 ** 2 + 24 ** 2) / (1 + self.aspect_ratio ** 2))
        film_w = film_h * self.aspect_ratio
        self.set_parameters(film_w / focal_x, film_h / focal_y)


class CameraPose:
    """Model-view matrix from a center, a front direction and an up hint."""

    def __init__(self, center=(0.0, 0.0, 1.0), front=(0.0, 0.0, 1.0),
                 up=(0.0, 1.0, 0.0)):
        self.center = np.asarray(center, float).reshape(-1)
        self.front = self._normalize(np.asarray(front, float).reshape(-1))
        up = np.asarray(up, float).reshape(-1)
        self.right = self._normalize(np.cross(up, self.front))
        self.up = self._normalize(np.cross(self.front, self.right))

    @staticmethod
    def _normalize(v):
        n = np.linalg.norm(v)
        return v if n == 0 else v / n

    def get_rotation_matrix(self) -> np.ndarray:
        rot = np.eye(3)
        rot[0], rot[1], rot[2] = self.right, self.up, self.front
        return rot

    def get_model_view_mat(self) -> np.ndarray:
        mv = np.eye(4)
        rot = self.get_rotation_matrix()
        mv[:3, :3] = rot
        mv[:3, 3] = -rot @ self.center
        return mv


def orbit_extrinsic(yaw_deg: float, pitch_deg: float,
                    distance: float = 2.0) -> np.ndarray:
    """Auto-orbit extrinsic: yaw about x then pitch about y (the demo's
    convention), the camera ``distance`` in front of the subject."""
    ext = np.eye(4, dtype=np.float32)
    ext[2, 3] = -distance
    ext[:3, :3] = make_rotate(math.radians(yaw_deg), 0, 0) @ make_rotate(
        0, math.radians(pitch_deg), 0)
    return ext
