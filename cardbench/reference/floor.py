"""The benchmark's plain reference of the served demo's background: a
floor prop (an OBJ of textured triangles) seen by the scene's camera, in
plain PyTorch, float32.

The prop: its vertices with y and z swapped, scaled from centimetres to
the scene (x 3 / 150), recentred on (0, -0.9, 0) by their mean. A
triangle's corners go through the projection times the model matrix to
clip space, then to pixels (x from the left over W - 1, y from the top
over H - 1; pixel centres at whole coordinates). A pixel shows the
nearest triangle (smallest depth in normalised device coordinates, the
first of the file among equal ones) whose barycentrics are all >= 0, its
uv interpolated perspective-correctly, the texture sampled bilinearly at
(u mod 1) (W_t - 1), (1 - v mod 1) (H_t - 1) with the next texel clamped
to the edge; a pixel no triangle covers is black. Imports nothing of
the system under test.
"""

from __future__ import annotations

import numpy as np
import torch

FLOOR_SIZE = 3.0
FLOOR_CENTRE = (0.0, -0.9, 0.0)


def read_obj(path: str):
    """(vertices [V, 3], uvs [T, 2], faces [F, 3], face uvs [F, 3]) of an
    OBJ, polygons split into fans, indices from 0."""
    v, vt, f, ft = [], [], [], []
    with open(path) as fh:
        for line in fh:
            parts = line.split()
            if not parts or parts[0].startswith("#"):
                continue
            if parts[0] == "v":
                v.append([float(x) for x in parts[1:4]])
            elif parts[0] == "vt":
                vt.append([float(x) for x in parts[1:3]])
            elif parts[0] == "f":
                idx = [[int(i) for i in p.split("/")[:2]] for p in parts[1:]]
                for k in range(1, len(idx) - 1):
                    tri = (idx[0], idx[k], idx[k + 1])
                    f.append([c[0] - 1 for c in tri])
                    ft.append([c[1] - 1 for c in tri])
    return (np.asarray(v, np.float32), np.asarray(vt, np.float32),
            np.asarray(f, np.int64), np.asarray(ft, np.int64))


def prop(path: str):
    """(corners [F, 3, 3], corner uvs [F, 3, 2]) of a floor prop, placed in
    the scene."""
    v, vt, f, ft = read_obj(path)
    v = v[:, [0, 2, 1]] / np.float32(150.0) * np.float32(FLOOR_SIZE)
    v = v - v.mean(axis=0) + np.asarray(FLOOR_CENTRE, np.float32)
    return v[f], vt[ft]


def sample(texture: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    th, tw, _ = texture.shape
    u = torch.remainder(uv[..., 0], 1.0) * (tw - 1)
    v = (1.0 - torch.remainder(uv[..., 1], 1.0)) * (th - 1)
    x0, y0 = torch.floor(u), torch.floor(v)
    fx, fy = (u - x0)[..., None], (v - y0)[..., None]
    x0, y0 = x0.long(), y0.long()
    x1, y1 = (x0 + 1).clamp(max=tw - 1), (y0 + 1).clamp(max=th - 1)
    top = texture[y0, x0] * (1 - fx) + texture[y0, x1] * fx
    bottom = texture[y1, x0] * (1 - fx) + texture[y1, x1] * fx
    return top * (1 - fy) + bottom * fy


class Floor:
    """A floor prop and its texture ([H, W, 3] uint8) -> its render."""

    def __init__(self, obj_path: str, texture: np.ndarray, size: int, device):
        corners, uvs = prop(obj_path)
        self.corners = torch.as_tensor(corners, device=device)
        self.uvs = torch.as_tensor(uvs, device=device)
        self.texture = torch.as_tensor(
            np.asarray(texture, np.float32) / 255.0, device=device)
        self.size = size

    @torch.no_grad()
    def render(self, extrinsic: np.ndarray, intrinsic: np.ndarray):
        """[S, S, 3] in [0, 1] seen through ``intrinsic @ extrinsic``."""
        dev, s = self.corners.device, self.size
        mvp = torch.as_tensor(np.asarray(intrinsic, np.float32)
                              @ np.asarray(extrinsic, np.float32), device=dev)
        hom = torch.cat([self.corners, torch.ones_like(self.corners[..., :1])],
                        dim=-1)
        clip = hom @ mvp.T                                   # [F, 3, 4]
        w = clip[..., 3]
        ndc = clip[..., :3] / w[..., None]
        px = (ndc[..., 0] + 1.0) * 0.5 * (s - 1)
        py = (1.0 - ndc[..., 1]) * 0.5 * (s - 1)
        ys = torch.arange(s, dtype=torch.float32, device=dev)[:, None]
        xs = torch.arange(s, dtype=torch.float32, device=dev)[None, :]
        depth = torch.full((s, s), float("inf"), device=dev)
        uv_img = torch.zeros((s, s, 2), device=dev)
        for t in range(len(clip)):
            (ax, bx, cx), (ay, by, cy) = px[t], py[t]
            area = (cx - ax) * (by - ay) - (cy - ay) * (bx - ax)
            if not bool(area.abs() > 1e-10) or not bool(
                    (w[t].abs() > 1e-8).all()):
                continue
            b0 = ((xs - bx) * (cy - by) - (ys - by) * (cx - bx)) / area
            b1 = ((xs - cx) * (ay - cy) - (ys - cy) * (ax - cx)) / area
            b2 = ((xs - ax) * (by - ay) - (ys - ay) * (bx - ax)) / area
            inside = (b0 >= 0) & (b1 >= 0) & (b2 >= 0)
            z = b0 * ndc[t, 0, 2] + b1 * ndc[t, 1, 2] + b2 * ndc[t, 2, 2]
            nearer = inside & (z < depth)
            inv_w = 1.0 / w[t]
            pw = b0 * inv_w[0] + b1 * inv_w[1] + b2 * inv_w[2]
            uv = (b0[..., None] * self.uvs[t, 0] * inv_w[0]
                  + b1[..., None] * self.uvs[t, 1] * inv_w[1]
                  + b2[..., None] * self.uvs[t, 2] * inv_w[2]) / pw[..., None]
            depth = torch.where(nearer, z, depth)
            uv_img = torch.where(nearer[..., None], uv, uv_img)
        color = sample(self.texture, uv_img)
        return torch.where(torch.isfinite(depth)[..., None], color,
                           torch.zeros_like(color))
