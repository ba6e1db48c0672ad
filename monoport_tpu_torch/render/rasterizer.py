"""Triangle rasterizer and render passes on the device (port of
``monoport_tpu/render/rasterizer.py``).

Triangles go through a running z-buffer in chunks of ``chunk``: each chunk
evaluates its barycentrics over the whole [C, H, W] canvas, keeps each
pixel's nearest triangle (the first among equals), and replaces the
buffer's pixel where that triangle is strictly nearer. Attributes are
interpolated with perspective correction; the "fragment shaders" are
tensor functions (the texture lookup gathers its four texels by hand, with
REPEAT wrap and a flipped v; SH shading is ``render/sh.py``). Library
tensor code, one loop over chunks: no kernel of ours stands behind it.

The render passes keep the reference renderers' API (``set_attrib`` /
``set_texture`` / ``draw(uniforms)`` / ``get_color``); ``get_color``
returns the [H, W, 3] image as a tensor on the renderer's device.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..ops.constants import upload_async
from ..weights import resolve_device


def _viewport(ndc_xy: torch.Tensor, width: int, height: int) -> torch.Tensor:
    """NDC [-1,1] -> pixel coords; y flipped (image row 0 = top)."""
    x = (ndc_xy[..., 0] + 1.0) * 0.5 * (width - 1)
    y = (1.0 - ndc_xy[..., 1]) * 0.5 * (height - 1)
    return torch.stack([x, y], -1)


def _edge(ax, ay, bx, by, px, py):
    return (px - ax) * (by - ay) - (py - ay) * (bx - ax)


def rasterize(tris_clip: torch.Tensor, attrs: torch.Tensor, height: int,
              width: int, chunk: int = 64):
    """Rasterize clip-space triangles with attribute interpolation.

    Args:
      tris_clip: [F, 3, 4] clip-space positions (after MVP).
      attrs:     [F, 3, A] per-corner attributes.
      height/width: output size.
      chunk: triangles per z-buffer merge step.

    Returns:
      (attr_img [H, W, A], depth [H, W] (inf = empty), mask [H, W] bool)
    """
    f = tris_clip.shape[0]
    a_dim = attrs.shape[-1]
    dev = tris_clip.device
    pad = (-f) % chunk
    # degenerate padding tris (w = 0) fail the valid test below
    tris_clip = torch.nn.functional.pad(tris_clip, (0, 0, 0, 0, 0, pad))
    attrs = torch.nn.functional.pad(attrs, (0, 0, 0, 0, 0, pad))
    n_chunks = tris_clip.shape[0] // chunk

    w = tris_clip[..., 3:4]
    valid_tri = (w[..., 0].abs() > 1e-8).all(dim=-1)              # [F]
    safe_w = torch.where(w.abs() > 1e-8, w, torch.ones_like(w))
    ndc = tris_clip[..., :3] / safe_w
    pix = _viewport(ndc, width, height)                           # [F, 3, 2]
    inv_w = 1.0 / safe_w[..., 0]                                  # [F, 3]

    ys = torch.arange(height, dtype=torch.float32, device=dev)[:, None]
    xs = torch.arange(width, dtype=torch.float32, device=dev)[None, :]
    tris_c = pix.reshape(n_chunks, chunk, 3, 2)
    z_c = ndc[..., 2].reshape(n_chunks, chunk, 3)
    invw_c = inv_w.reshape(n_chunks, chunk, 3)
    attr_c = attrs.reshape(n_chunks, chunk, 3, a_dim)
    valid_c = valid_tri.reshape(n_chunks, chunk)
    big = torch.tensor(float("inf"), device=dev)

    depth = torch.full((height, width), float("inf"), device=dev)
    attr_img = torch.zeros((height, width, a_dim), device=dev)
    for i in range(n_chunks):
        t, tz, tw, ta = tris_c[i], z_c[i], invw_c[i], attr_c[i]
        ax, ay = t[:, 0, 0, None, None], t[:, 0, 1, None, None]
        bx, by = t[:, 1, 0, None, None], t[:, 1, 1, None, None]
        cx, cy = t[:, 2, 0, None, None], t[:, 2, 1, None, None]
        # signed areas -> barycentrics (no backface culling)
        area = _edge(ax, ay, bx, by, cx, cy)                      # [C, 1, 1]
        w0 = _edge(bx, by, cx, cy, xs, ys)
        w1 = _edge(cx, cy, ax, ay, xs, ys)
        w2 = _edge(ax, ay, bx, by, xs, ys)
        ok_area = area.abs() > 1e-10
        denom = torch.where(ok_area, area, torch.ones_like(area))
        b0, b1, b2 = w0 / denom, w1 / denom, w2 / denom
        inside = ((b0 >= 0) & (b1 >= 0) & (b2 >= 0) & ok_area
                  & valid_c[i][:, None, None])                    # [C, H, W]
        zpix = (b0 * tz[:, 0, None, None] + b1 * tz[:, 1, None, None]
                + b2 * tz[:, 2, None, None])
        zpix = torch.where(inside, zpix, big)

        # nearest triangle within the chunk per pixel (first among equals)
        best = torch.argmin(zpix, dim=0)                          # [H, W]
        take = lambda arr: torch.gather(arr, 0, best[None])[0]
        bz, bb0, bb1, bb2 = take(zpix), take(b0), take(b1), take(b2)
        tw_best = tw[best]                                        # [H, W, 3]
        ta_best = ta[best]                                        # [H, W, 3, A]
        # perspective-correct interpolation
        pw = (bb0 * tw_best[..., 0] + bb1 * tw_best[..., 1]
              + bb2 * tw_best[..., 2])
        num = (bb0[..., None] * ta_best[..., 0, :] * tw_best[..., 0:1]
               + bb1[..., None] * ta_best[..., 1, :] * tw_best[..., 1:2]
               + bb2[..., None] * ta_best[..., 2, :] * tw_best[..., 2:3])
        safe_pw = torch.where(pw.abs() > 1e-12, pw, torch.ones_like(pw))
        battr = num / safe_pw[..., None]

        closer = bz < depth
        depth = torch.where(closer, bz, depth)
        attr_img = torch.where(closer[..., None], battr, attr_img)
    return attr_img, depth, torch.isfinite(depth)


def sample_texture(texture: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Bilinear texture lookup with REPEAT wrap: [th, tw, 3], [..., 2]; v is
    flipped (GL's uv origin is the bottom row)."""
    th, tw, _ = texture.shape
    u = torch.remainder(uv[..., 0], 1.0) * (tw - 1)
    v = (1.0 - torch.remainder(uv[..., 1], 1.0)) * (th - 1)
    x0 = torch.floor(u)
    y0 = torch.floor(v)
    fx, fy = (u - x0)[..., None], (v - y0)[..., None]
    x0, y0 = x0.long(), y0.long()
    x1 = (x0 + 1).clamp(0, tw - 1)
    y1 = (y0 + 1).clamp(0, th - 1)
    top = texture[y0, x0] * (1 - fx) + texture[y0, x1] * fx
    bot = texture[y1, x0] * (1 - fx) + texture[y1, x1] * fx
    return top * (1 - fy) + bot * fy


class _BaseRender:
    """Common draw plumbing. ``device``: None = ``cuda`` (raises when CUDA is
    absent); pass ``"cpu"`` to render on the CPU."""

    def __init__(self, width: int = 256, height: int = 256,
                 multi_sample_rate: int = 1, device=None):
        self.width = width
        self.height = height
        self.ss = max(1, int(multi_sample_rate))  # supersampling factor
        self.device = resolve_device(device)
        self.attribs: dict[int, torch.Tensor] = {}
        self.textures: dict[str, torch.Tensor] = {}
        self._color: Optional[torch.Tensor] = None

    def set_attrib(self, idx: int, data: np.ndarray) -> None:
        self.attribs[idx] = torch.as_tensor(np.asarray(data, np.float32),
                                            device=self.device)

    def set_texture(self, name: str, image: np.ndarray) -> None:
        img = np.asarray(image)
        if img.dtype == np.uint8:
            img = img.astype(np.float32) / 255.0
        self.textures[name] = torch.as_tensor(np.asarray(img, np.float32),
                                              device=self.device)

    def _upload(self, x: np.ndarray) -> torch.Tensor:
        """A per-draw host matrix on the device without a stream sync."""
        return upload_async(np.asarray(x, np.float32), self.device)

    def _mvp(self, uniforms: dict) -> np.ndarray:
        model = np.asarray(uniforms["ModelMat"], np.float32)
        persp = np.asarray(uniforms["PerspMat"], np.float32)
        return persp @ model

    def _transform(self, mvp: np.ndarray) -> torch.Tensor:
        v = self.attribs[0].reshape(-1, 3, 3)
        hom = torch.cat([v, torch.ones_like(v[..., :1])], dim=-1)
        return torch.einsum("ij,fvj->fvi", self._upload(mvp), hom)

    def _finish(self, color: torch.Tensor) -> None:
        if self.ss > 1:
            color = color.reshape(self.height, self.ss, self.width,
                                  self.ss, 3).mean(dim=(1, 3))
        self._color = color

    def _canvas(self) -> tuple[int, int]:
        return self.height * self.ss, self.width * self.ss

    def get_color(self) -> torch.Tensor:
        if self._color is None:
            raise RuntimeError("call draw() first")
        return self._color


def _unit(n: torch.Tensor) -> torch.Tensor:
    return n / torch.clamp(torch.linalg.norm(n, dim=-1, keepdim=True),
                           min=1e-8)


class AlbedoRender(_BaseRender):
    """Textured render: attrib 0 = flattened triangle vertices [F*3, 3],
    attrib 1 = uvs [F*3, 2], texture 'TargetTexture'."""

    def draw(self, uniforms: dict) -> None:
        tris = self._transform(self._mvp(uniforms))
        uvs = self.attribs[1].reshape(-1, 3, 2)
        attr_img, _, mask = rasterize(tris, uvs, *self._canvas())
        color = sample_texture(self.textures["TargetTexture"], attr_img)
        self._finish(torch.where(mask[..., None], color,
                                 torch.zeros_like(color)))


class NormalRender(_BaseRender):
    """Camera-space normal render: attrib 1 = normals."""

    def draw(self, uniforms: dict) -> None:
        model = np.asarray(uniforms["ModelMat"], np.float32)
        tris = self._transform(self._mvp(uniforms))
        normals = self.attribs[1].reshape(-1, 3, 3) @ self._upload(
            model[:3, :3].T)
        attr_img, _, mask = rasterize(tris, normals, *self._canvas())
        color = _unit(attr_img) * 0.5 + 0.5
        self._finish(torch.where(mask[..., None], color,
                                 torch.zeros_like(color)))


class ShRender(_BaseRender):
    """SH-lit albedo render: attrib 1 = normals, attrib 2 = uvs, texture
    'AlbedoMap', uniform SHCoeffs [9, 3]."""

    def draw(self, uniforms: dict) -> None:
        from .sh import shade_sh

        tris = self._transform(self._mvp(uniforms))
        attrs = torch.cat([self.attribs[1].reshape(-1, 3, 3),
                           self.attribs[2].reshape(-1, 3, 2)], dim=-1)
        attr_img, _, mask = rasterize(tris, attrs, *self._canvas())
        albedo = sample_texture(self.textures["AlbedoMap"], attr_img[..., 3:5])
        color = albedo * shade_sh(_unit(attr_img[..., :3]),
                                  uniforms["SHCoeffs"])
        self._finish(torch.where(mask[..., None], color,
                                 torch.zeros_like(color)))


class PrtRender(_BaseRender):
    """Precomputed radiance transfer render: attrib 1 = uvs, attrib 2 =
    per-vertex PRT coefficients [F*3, 9]; the environment's coefficients are
    rotated with the model by the exact 9x9 SH rotation.

    ``draw(..., uv_space=True)`` rasterizes the triangles at their UV
    positions instead (the texture-space unwrap)."""

    def draw(self, uniforms: dict, uv_space: bool = False) -> None:
        from .sh import sh_rotation_matrix

        model = np.asarray(uniforms["ModelMat"], np.float32)
        uvs = self.attribs[1].reshape(-1, 3, 2)
        if uv_space:
            tris = torch.cat([uvs * 2.0 - 1.0, torch.zeros_like(uvs[..., :1]),
                              torch.ones_like(uvs[..., :1])], dim=-1)
        else:
            tris = self._transform(self._mvp(uniforms))
        attrs = torch.cat([uvs, self.attribs[2].reshape(-1, 3, 9)],
                          dim=-1)
        attr_img, _, mask = rasterize(tris, attrs, *self._canvas())
        env = np.asarray(uniforms["SHCoeffs"], np.float32)      # [9, 3]
        env_rot = sh_rotation_matrix(model[:3, :3]).numpy() @ env
        shading = attr_img[..., 2:11] @ self._upload(env_rot)
        albedo = sample_texture(self.textures["AlbedoMap"], attr_img[..., :2])
        color = albedo * shading
        self._finish(torch.where(mask[..., None], color,
                                 torch.zeros_like(color)))
