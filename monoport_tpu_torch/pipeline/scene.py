"""Background scene: a textured floor and the auto-orbiting virtual camera
(port of ``monoport_tpu/pipeline/scene.py``).

``MonoPortScene`` loads a floor prop, orbits the camera (yaw 20, pitch += 3
a frame) or reads a WebXR extrinsic, and renders the floor through the
Albedo pass on the device. The props' geometry is the JAX package's
committed OBJ files (``monoport_tpu/data/floor``, read as files); their
textures are the decoded JPEGs, committed as uint8 in
``data/floor_textures.npz`` (written by ``python tests/test_torch_render.py
--write``), so the scene needs no image library. ``shift_floor`` cycles
the five props; a procedural checkerboard quad is the fallback.
"""

from __future__ import annotations

import glob
import json
import math
import os

import numpy as np
import torch

from ..render.camera import BaseCamera, make_rotate
from ..render.rasterizer import AlbedoRender
from ..utils.mesh import load_obj_mesh
from ..weights import DATA

FLOOR_DIR = os.path.join(DATA, "floor")
FLOOR_TEXTURES = os.path.join(os.path.dirname(__file__), os.pardir, "data",
                              "floor_textures.npz")


def floor_textures(path: str = FLOOR_TEXTURES) -> dict[str, np.ndarray]:
    """Prop name -> its texture, [H, W, 3] uint8 RGB."""
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def checkerboard_texture(size: int = 256, tiles: int = 8,
                         c0=(0.35, 0.4, 0.45), c1=(0.65, 0.7, 0.72)):
    ij = np.arange(size) // (size // tiles)
    board = (ij[:, None] + ij[None, :]) % 2
    tex = np.where(board[..., None] == 0, np.asarray(c0), np.asarray(c1))
    return tex.astype(np.float32)


def floor_quad(floor_size: float = 3.0, center=(0.0, -0.9, 0.0)):
    """Two-triangle floor in the xz-plane -> (vert_data [6,3], uv_data [6,2])."""
    s = floor_size / 2
    cx, cy, cz = center
    corners = np.array([
        [cx - s, cy, cz - s], [cx + s, cy, cz - s],
        [cx + s, cy, cz + s], [cx - s, cy, cz + s]], np.float32)
    uv = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    idx = [0, 1, 2, 0, 2, 3]
    return corners[idx], uv[idx]


def load_floor(mesh_path: str, texture: np.ndarray, floor_size: float = 3.0,
               floor_center=(0.0, -0.9, 0.0)):
    """A floor prop: its OBJ (axes swapped y <-> z, cm -> scene units,
    recentred) and its texture image -> (vert_data, uv_data, texture)."""
    verts, faces, _, _, textures, face_textures = load_obj_mesh(
        mesh_path, with_normal=True, with_texture=True)
    verts = verts[:, [0, 2, 1]]
    verts = verts / 150.0 * floor_size
    verts = verts - verts.mean(axis=0) + np.asarray(floor_center, np.float32)
    vert_data = verts[faces.reshape(-1)]
    # vt rows may carry a third (w) component; the renderer wants [N, 2]
    uv_data = textures[face_textures.reshape(-1)][:, :2]
    return vert_data, uv_data, texture


def load_intrinsic(near: float = 0.0, far: float = 10.0,
                   scale: float = 2.0) -> np.ndarray:
    """Orthographic scene intrinsic."""
    cam = BaseCamera()
    cam.near = near
    cam.far = far
    cam.set_parameters(scale, scale)
    return cam.get_projection_mat()


class MonoPortScene:
    """The floor background and the virtual camera. ``floor_assets``: an
    (OBJ path, uint8 texture) pair in place of a committed prop.
    ``device``: None = ``cuda`` (raises when CUDA is absent); pass
    ``"cpu"`` to render on the CPU."""

    def __init__(self, size=(256, 256), floor_assets: tuple | None = None,
                 webxr_path: str | None = None, floor_style: str = "floor",
                 device=None):
        self.size = size
        self._textures = (floor_textures() if os.path.exists(FLOOR_TEXTURES)
                          else {})
        self.prop_sets = sorted(
            os.path.splitext(os.path.basename(p))[0]
            for p in glob.glob(os.path.join(FLOOR_DIR, "*.obj"))
            if os.path.splitext(os.path.basename(p))[0] in self._textures)
        if floor_assets is None and floor_style in self.prop_sets:
            floor_assets = self._prop(floor_style)
        if floor_assets is not None:
            self.vert_data, self.uv_data, self.texture_image = load_floor(
                *floor_assets)
        else:
            self.vert_data, self.uv_data = floor_quad()
            self.texture_image = checkerboard_texture()
        self.intrinsic = load_intrinsic()
        self.webxr_path = webxr_path

        self.renderer = AlbedoRender(width=size[0], height=size[1],
                                     multi_sample_rate=1, device=device)
        self._set_floor()
        self.extrinsic = np.array([
            [1.0, 0.0, 0.0, 0.0],
            [0.0, 1.0, 0.0, 0.0],
            [0.0, 0.0, 1.0, -2.0],
            [0.0, 0.0, 0.0, 1.0]], np.float32)
        self.step = 0
        self._prop_idx = 0

    def _prop(self, name: str) -> tuple:
        return os.path.join(FLOOR_DIR, f"{name}.obj"), self._textures[name]

    def _set_floor(self) -> None:
        self.renderer.set_attrib(0, self.vert_data)
        self.renderer.set_attrib(1, self.uv_data)
        self.renderer.set_texture("TargetTexture", self.texture_image)

    def shift_floor(self):
        """Cycle the floor look (the demo's hotkey 'g'): the next committed
        prop set; without them a re-tint of the current texture."""
        if len(self.prop_sets) > 1:
            self._prop_idx = (self._prop_idx + 1) % len(self.prop_sets)
            self.vert_data, self.uv_data, self.texture_image = load_floor(
                *self._prop(self.prop_sets[self._prop_idx]))
            self._set_floor()
            return
        rng = np.random.RandomState(self.step)
        if not hasattr(self, "_texture0"):
            t = self.texture_image
            self._texture0 = (t.astype(np.float32) / 255.0
                              if t.dtype == np.uint8 else t.copy())
        tint = rng.uniform(0.6, 1.15, 3).astype(np.float32)
        self.texture_image = np.clip(self._texture0 * tint, 0.0, 1.0)
        self.renderer.set_texture("TargetTexture", self.texture_image)

    def update_camera(self, load: bool = False):
        """Auto-orbit (yaw 20, pitch += 3 a frame) or the WebXR extrinsic
        -> (extrinsic, intrinsic)."""
        if not load:
            yaw, pitch = 20, self.step
            self.extrinsic[:3, :3] = (
                make_rotate(math.radians(yaw), 0, 0)
                @ make_rotate(0, math.radians(pitch), 0))
            self.step += 3
            return self.extrinsic, self.intrinsic
        with open(self.webxr_path) as f:
            ext = np.array(json.load(f)["data"]).reshape(4, 4).T
        return ext, self.intrinsic

    def render(self, extrinsic, intrinsic) -> torch.Tensor:
        """The floor seen from (extrinsic, intrinsic): [H, W, 3] f32 on the
        scene's device."""
        self.renderer.draw({"ModelMat": extrinsic, "PerspMat": intrinsic})
        return self.renderer.get_color()
