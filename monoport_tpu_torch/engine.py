"""ReconEngine — the frontal real-time frame on the card (port of
``monoport_tpu/engine.py``, frontal grid path).

One frame: netG ``HGFilter`` over the image, the volume-free
``ray_pyramid`` (dense march, refines through the march levels and the
windowed fine pass), normal shading, netC ``ResnetFilter`` with netG's last
feature map as its prior, the windowed grid colour query, and the display
resize. Every occupancy and colour query goes through the separable grid
sampling and the fused ray MLP (``ops/cuda/fused_ray_mlp.py``): 4 kernel
launches a frame at the real-time operating point.

The path is chosen on the host from the numpy calib, as the JAX engine
does, so no per-frame device sync appears. Calibs that do not pass
``_calib_grid_ok`` (rotated views, in-plane rotations), ``mode='dense'``,
``frames()`` and meshes belong to later slices and raise.

Dtype policy (JAX ``_cast`` / ``_feats_f32``): the backbones run in the
compute dtype, their feature maps are upcast to f32 before the queries,
and the MLP runs in the compute dtype inside the kernel with f32
accumulation. The head operands are packed once, at construction. f32
parity with the JAX package (which pins full f32 precision) needs TF32
off on the card: ``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32`` False, as ``chip_smoke.py`` sets them.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Optional

import numpy as np
import torch

from .config import CN
from .models import MonoPortNet
from .ops.constants import upload_async
from .ops.cuda.fused_ray_mlp import apply_ray, pack_ray_mlp_params
from .recon.depth_peel import SurfaceMaps, shade_normal, visualize
from .recon.hierarchy import HierarchicalRecon
from .recon.ray_refine import _axis_window, _f32, _sample_grid, ray_pyramid
from .weights import resolve_device

ROTATED_TODO = ("rotated-view calibs are not ported yet (ROADMAP queue 1 "
                "item 7: rotated free-viewpoint slice)")
DENSE_TODO = ("the dense/hierarchy path, frames() and meshes are not ported "
              "yet (ROADMAP queue 1 item 8)")


@dataclasses.dataclass(frozen=True)
class RayCfg:
    """Reconstruction-path shape (see the JAX ``RayCfg``). Only
    ``mode='ray'`` with ``march_levels`` is ported."""
    mode: str = "dense"
    fine_res: int = 257
    taps: int = 6
    window: Optional[int] = None
    march_levels: Optional[tuple] = None


@dataclasses.dataclass(frozen=True)
class EngineCfg:
    """render_size: output canvas; compute_dtype: backbone/MLP operand
    dtype (the feature maps feeding the queries are upcast to f32). The
    JAX ``RotatedCfg`` / ``TextureCfg`` knobs and ``use_ray_query`` come
    with the rotated slice (ROADMAP queue 1 item 7), with the code that
    reads them."""
    render_size: int = 256
    direction: str = "front"
    compute_dtype: torch.dtype = torch.float32
    ray: RayCfg = RayCfg()


class ReconEngine:
    """Frame program: (images, calib) -> rendered maps, with the weights
    held by the nets.

    Args:
      netG / netC: MonoPortNet modules (netC optional: texture off).
      recon: HierarchicalRecon (b_min / b_max / balance_value are read).
      config: EngineCfg.
      device: ``None`` = ``cuda`` (raises when CUDA is absent); pass
        ``"cpu"`` to run on the CPU, where the ray MLP takes its plain twin.
    """

    def __init__(self, netG: MonoPortNet, netC: Optional[MonoPortNet] = None,
                 recon: Optional[HierarchicalRecon] = None,
                 config: Optional[EngineCfg] = None, device=None):
        cfg = config or EngineCfg()
        self.config = cfg
        self.device = resolve_device(device)
        if cfg.ray.mode != "ray" or not cfg.ray.march_levels:
            raise NotImplementedError(DENSE_TODO)
        if cfg.direction != "front":
            raise NotImplementedError(ROTATED_TODO)
        self.recon = recon or HierarchicalRecon()
        self.compute_dtype = cfg.compute_dtype
        self.render_size = cfg.render_size
        self.fine_res = cfg.ray.fine_res
        self.ray_taps = cfg.ray.taps
        self.ray_window = cfg.ray.window
        self.march_levels = tuple(cfg.ray.march_levels)
        # the compute-dtype copies of the nets (JAX ``_cast`` of params)
        self.netG = self._cast(netG)
        self.netC = self._cast(netC) if netC is not None else None
        self.head_g = self._ray_head(self.netG)
        self.head_c = (self._ray_head(self.netC)
                       if self.netC is not None else None)

    def _cast(self, net: MonoPortNet) -> MonoPortNet:
        """The net in the compute dtype on the engine's device (a copy
        unless f32)."""
        net = copy.deepcopy(net) if self.compute_dtype != torch.float32 \
            else net
        return net.to(device=self.device, dtype=self.compute_dtype).eval()

    def _calib_taps_ok(self, calibs) -> bool:
        """True iff every calib has z-free image-plane rows (host check on
        the numpy calib) and the net can build the ray head."""
        if CN(self.netG.opt_net).projection != "orthogonal":
            return False
        c = np.asarray(calibs)
        return bool(np.abs(c[..., :2, 2]).max() < 1e-6)

    def _calib_grid_ok(self, calibs) -> bool:
        """True iff the calib's image rows are diagonal and z-free (u from x
        alone, v from y alone): the condition of the separable query."""
        if not self._calib_taps_ok(calibs):
            return False
        c = np.asarray(calibs)
        return bool(max(np.abs(c[..., 0, 1]).max(),
                        np.abs(c[..., 1, 0]).max()) < 1e-6)

    def _ray_head(self, net: MonoPortNet):
        """The fused ray MLP over this net's head, packed once."""
        packed = pack_ray_mlp_params(net.surface_classifier,
                                     dtype=self.compute_dtype,
                                     device=self.device)
        return lambda feat, z: apply_ray(packed, feat, z)

    def _feats_f32(self, feats):
        if self.compute_dtype == torch.float32:
            return feats
        return [[f.float() for f in fs] for fs in feats]

    def _query_grid_fn(self, feats, calib):
        def query_grid(xw, yw, wz):
            return self.netG.query_taps_grid(
                feats, xw[None], yw[None], wz[None], calib,
                head_taps_fn=self.head_g)[0, ..., 0]
        return query_grid

    def _grid_color_fn(self, feats, calib):
        def color_grid(xw, yw, zw):
            return self.netC.query_taps_grid(
                feats, xw[None], yw[None], zw[None, ..., None], calib,
                head_taps_fn=self.head_c)[0, :, :, 0, :]
        return color_grid

    def _texture_canvas(self, maps: SurfaceMaps, resolution: int,
                        color_grid) -> torch.Tensor:
        """Texture canvas through the grid colour query, on a window^2
        lattice over the subject's bbox when a window is set (resampled
        back: an exact gather at stride 1, bilinear colours beyond)."""
        r = resolution
        dev = maps.depth.device
        b_min = _f32(self.recon.b_min, dev)
        b_max = _f32(self.recon.b_max, dev)
        sr = (b_max - b_min) / r
        w = self.ray_window
        fr = torch.arange(r, dtype=torch.float32, device=dev)
        if w is None or w >= r:
            color = color_grid(fr * sr[0] + b_min[0], fr * sr[1] + b_min[1],
                               (float(r) - maps.depth) * sr[2] + b_min[2])
        else:
            x0, sx = _axis_window(maps.valid.any(dim=1), r, r, 1.0, w)
            y0, sy = _axis_window(maps.valid.any(dim=0), r, r, 1.0, w)
            ar = torch.arange(w, dtype=torch.float32, device=dev)
            aw = x0 + ar * sx
            bw = y0 + ar * sy
            depth_w = _sample_grid(maps.depth, aw, bw)
            color_w = color_grid(aw * sr[0] + b_min[0], bw * sr[1] + b_min[1],
                                 (float(r) - depth_w) * sr[2] + b_min[2])
            u = torch.clamp((fr - x0) / sx, 0.0, w - 1)
            v = torch.clamp((fr - y0) / sy, 0.0, w - 1)
            color = torch.stack([_sample_grid(color_w[..., k], u, v)
                                 for k in range(3)], dim=-1)
        color = color * 0.5 + 0.5
        return torch.where(maps.valid[..., None], color,
                           torch.ones_like(color))

    @torch.no_grad()
    def frame(self, image_g: torch.Tensor,
              image_c: Optional[torch.Tensor] = None, calib=None) -> dict:
        """One frame. images NHWC [1, H, W, 3]; calib a host [1, 4, 4]
        array (numpy; identity when None). -> {'depth', 'valid',
        'render_norm', 'mask'} (+ 'render_tex' with netC and image_c)."""
        if calib is None:
            calib = np.eye(4, dtype=np.float32)[None]
        if isinstance(calib, torch.Tensor):
            calib = calib.detach().cpu().numpy()
        if not self._calib_grid_ok(calib):
            raise NotImplementedError(ROTATED_TODO)
        calib_t = upload_async(np.asarray(calib, np.float32), self.device)
        dt = self.compute_dtype
        image_g = image_g.to(device=self.device, dtype=dt)
        feats_g = self._feats_f32(self.netG.filter(image_g))

        maps = ray_pyramid(None, self.fine_res, levels=self.march_levels,
                           taps=self.ray_taps,
                           balance_value=self.recon.balance_value,
                           b_min=self.recon.b_min, b_max=self.recon.b_max,
                           window=self.ray_window,
                           query_grid_fn=self._query_grid_fn(feats_g, calib_t),
                           device=self.device)
        render_norm, mask = visualize(shade_normal(maps), self.render_size)
        out = {"depth": maps.depth, "valid": maps.valid,
               "render_norm": render_norm, "mask": mask}
        if self.netC is not None and image_c is not None:
            image_c = image_c.to(device=self.device, dtype=dt)
            # the f32 prior promotes the concatenated maps to f32, as in
            # the JAX engine
            feat_prior = feats_g[-1][-1]
            feats_c = self._feats_f32(self.netC.filter(image_c, feat_prior))
            tex = self._texture_canvas(maps, self.fine_res,
                                       self._grid_color_fn(feats_c, calib_t))
            render_tex, mask_tex = visualize(tex, self.render_size)
            out.update({"render_tex": render_tex, "mask": mask_tex})
        return out

    def frames(self, *args, **kwargs):
        raise NotImplementedError(DENSE_TODO)
