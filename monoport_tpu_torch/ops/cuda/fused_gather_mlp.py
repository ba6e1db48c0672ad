"""Ray MLP with the bilinear feature gather inside the kernel: the
hand-written Hopper kernel and its plain version.

``apply_gather_ray`` replaces ``monoport_tpu/ops/pallas/fused_gather_mlp.py
::_gather_ray_kernel``: pixel-aligned sampling and the surface MLP in one
kernel. A ray's feature is the 4-tap bilinear sample of the feature map,
read as a ``[H*W, C]`` row table (align_corners=True, a tap outside the
image has weight 0: ``ops/sampling.index``'s taps); the T z-taps of the ray
share it, as in ``fused_ray_mlp``. With T = 1 it is a per-point gather +
MLP. The table is cast to the compute dtype, so in bf16 the taps combine
bf16 rows in f32: the bf16-feature-map variant of the query, not the f32
maps the engine's queries sample. No engine path calls it, here as in the
JAX package; its entry point is ``profile_gather.py``, which measures it
against ``index`` -> ``apply_ray`` and ``index_grid`` -> ``apply_ray``.

The kernel (``csrc/fused_gather_mlp.cu`` over ``csrc/mlp_tiles.cuh``;
design and bound in their headers) gathers and combines inside the kernel:
the gathered ``[R, C]`` rows live in shared memory only. The wrapper passes
the table, the taps' indices and weights (``bilinear_taps``, R x 4 each)
and z. It launches the kernel for CUDA tensors and runs
``apply_gather_plain`` for CPU tensors; any other device raises, and a
failed build or launch raises.
"""

from __future__ import annotations

import torch

from .fused_ray_mlp import (RayMlpPacked, _check_taps, _no_path,
                            apply_ray_plain, launch_packed)

LIBRARY = "fused_gather_mlp"


def bilinear_taps(uv: torch.Tensor, h: int, w: int):
    """[B, R, 2] normalized coords -> flat tap indices [B, R, 4] int32 and
    weights [B, R, 4] f32 (align_corners=True, zeros padding). The f32
    operations keep the JAX package's order, so ``floor`` lands on the
    same texel at a boundary."""
    u, v = uv[..., 0].float(), uv[..., 1].float()
    x = (u + 1.0) * 0.5 * (w - 1)
    y = (v + 1.0) * 0.5 * (h - 1)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx1 = x - x0
    wy1 = y - y0
    idxs, wgts = [], []
    for yi, wy in ((y0, 1.0 - wy1), (y0 + 1.0, wy1)):
        for xi, wx in ((x0, 1.0 - wx1), (x0 + 1.0, wx1)):
            valid = (xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)
            xc = torch.clamp(xi, 0, w - 1).to(torch.int32)
            yc = torch.clamp(yi, 0, h - 1).to(torch.int32)
            idxs.append(yc * w + xc)
            wgts.append(wy * wx * valid.float())
    return torch.stack(idxs, dim=-1), torch.stack(wgts, dim=-1)


def _table(p: RayMlpPacked, feat_map: torch.Tensor) -> torch.Tensor:
    """The map as a [B, H*W, C] row table in the compute dtype."""
    b, h, w, c = feat_map.shape
    if c != p.c_f:
        raise ValueError(f"feature width {c} != head's {p.c_f}")
    return feat_map.reshape(b, h * w, c).to(p.dtype)


def apply_gather_plain(p: RayMlpPacked, feat_map: torch.Tensor,
                       uv: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Plain-PyTorch version of the kernel, with its rounding points: the
    table in the compute dtype, the four tap rows gathered, multiplied by
    their f32 weights and added in tap order in f32, one rounding to the
    compute dtype, then ``apply_ray_plain``.
    feat_map [B, H, W, C], uv [B, R, 2], z [B, R, T] -> [B, R, T, out]."""
    b, h, w, c = feat_map.shape
    idx, wgt = bilinear_taps(uv, h, w)
    rows = torch.take_along_dim(
        _table(p, feat_map), idx.reshape(b, -1, 1).long(), dim=1).reshape(
            b, uv.shape[1], 4, c).float()
    feat = rows[:, :, 0] * wgt[:, :, 0, None]
    for k in range(1, 4):
        feat = feat + rows[:, :, k] * wgt[:, :, k, None]
    return apply_ray_plain(p, feat.to(p.dtype), z)


def _launch(p: RayMlpPacked, feat_map: torch.Tensor, uv: torch.Tensor,
            z: torch.Tensor) -> torch.Tensor:
    _, h, w, _ = feat_map.shape
    r = uv.shape[1]
    taps = _check_taps(1, r, z)
    table = _table(p, feat_map)[0]
    if p.widths[0] > p.c_f:
        table = torch.nn.functional.pad(table, (0, p.widths[0] - p.c_f))
    idx, wgt = bilinear_taps(uv, h, w)
    out = launch_packed(
        LIBRARY, "fused_gather_mlp_forward", p, table.contiguous(), r, taps,
        z=z.to(torch.float32).reshape(r, taps).contiguous(),
        gather=(idx.reshape(r, 4).contiguous(),
                wgt.reshape(r, 4).contiguous()))
    apply_gather_ray.launches += 1
    return out.reshape(1, r, taps, p.out_dim)


def apply_gather_ray(p: RayMlpPacked, feat_map: torch.Tensor,
                     uv: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """feat_map [1, H, W, C] + uv [1, R, 2] normalized + z [1, R, T] ->
    [1, R, T, out_dim] f32, the gather inside the kernel: the CUDA kernel
    for CUDA tensors, the plain version for CPU tensors. ``p`` is
    ``pack_ray_mlp_params``' packing. One frame a call."""
    if feat_map.shape[0] != 1 or uv.shape[0] != 1:
        raise ValueError("the gathering kernel takes batch 1: got "
                         f"{feat_map.shape[0]} maps, {uv.shape[0]} ray sets")
    if feat_map.device.type == "cuda":
        return _launch(p, feat_map, uv, z)
    if feat_map.device.type == "cpu":
        return apply_gather_plain(p, feat_map, uv, z)
    raise _no_path(feat_map.device)


apply_gather_ray.launches = 0
