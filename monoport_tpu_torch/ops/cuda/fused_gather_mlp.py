"""Ray MLP with the bilinear feature gather: the hand-written Hopper
kernels and their plain version.

``apply_gather_ray`` replaces ``monoport_tpu/ops/pallas/fused_gather_mlp.py
::_gather_ray_kernel``, which does pixel-aligned sampling and the surface
MLP in one TPU kernel. A ray's feature is the 4-tap bilinear sample of the
feature map, read as a ``[H*W, C]`` row table (align_corners=True, a tap
outside the image has weight 0: ``ops/sampling.index``'s taps); the T
z-taps of the ray share it, as in ``fused_ray_mlp``. With T = 1 it is a
per-point gather + MLP. The table is cast to the compute dtype, so in bf16
the taps combine bf16 rows in f32: the bf16-feature-map variant of the
query, not the f32 maps the engine's queries sample. No engine path calls it, here as in the
JAX package; its entry point is ``profile_gather.py``, which measures it
against ``index`` -> ``apply_ray`` and ``index_grid`` -> ``apply_ray``.

Two routes, by the packed dtype (``csrc/fused_gather_mlp.cu``; design and
bound in its header and in the device code it includes):

* bf16: the weighted-row pass (``csrc/mix_rows.cuh``, bound by bytes)
  combines each ray's four tap rows of the bf16 table into its feature row
  [R, C_f] bf16, in f32 in tap order with one rounding: exactly the JAX
  kernel's combine-then-round, so no new rounding point. Then the ray MLP's
  wgmma kernel (``fused_ray_mlp.launch_ray_wgmma``, ``RayEpilogue``) runs
  on those rows with the T taps. Two launches, one counted call.
* f32: the parity route on plain FMA (``csrc/mlp_tiles.cuh``): the gather
  is the loader of the projection pass, the gathered rows live in shared
  memory only, then the layer kernel; both run the f32 route's
  register-blocked, ring-fed block GEMM (``fused_ray_mlp``).

Bound: operations, the MLP's (as for ``apply_ray``); the pass alone by
bytes (the table rows the rays touch, the taps and its [R, C_f] output:
~25 MB at 36,864 rays of netG's 256 columns, ~7 us at 3.35 TB/s). The
bf16 route replaced the gather inside the projection pass of
``mlp_tiles.cuh`` and mma.sync layers, which took 3.6x as long at
36,864 rays x 6 taps on an H100 (PERF.md).

The wrapper passes the table, the taps' indices and weights
(``bilinear_taps``, R x 4 each) and z. It launches the kernels for CUDA
tensors and runs ``apply_gather_plain`` for CPU tensors; any other device
raises, and a failed check, build or launch raises.
"""

from __future__ import annotations

import torch

from . import fused_ray_mlp as tray
from . import mix_rows
from .fused_ray_mlp import (RayMlpPacked, _check_taps, _no_path,
                            apply_ray_plain, launch_packed)

LIBRARY = "fused_gather_mlp"


def bilinear_taps(uv: torch.Tensor, h: int, w: int):
    """[B, R, 2] normalized coords -> flat tap indices [B, R, 4] int32 and
    weights [B, R, 4] f32 (align_corners=True, zeros padding), taps in the
    order (y0, x0), (y0, x1), (y1, x0), (y1, x1). The f32 operations keep
    the JAX package's order, so ``floor`` lands on the same texel at a
    boundary; the four taps go through each operation together (a few
    launches, not four times as many)."""
    u, v = uv[..., 0].float(), uv[..., 1].float()
    x = (u + 1.0) * 0.5 * (w - 1)
    y = (v + 1.0) * 0.5 * (h - 1)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx1 = x - x0
    wy1 = y - y0
    x1, y1, wx0, wy0 = x0 + 1.0, y0 + 1.0, 1.0 - wx1, 1.0 - wy1
    xi = torch.stack([x0, x1, x0, x1], dim=-1)
    yi = torch.stack([y0, y0, y1, y1], dim=-1)
    wx = torch.stack([wx0, wx1, wx0, wx1], dim=-1)
    wy = torch.stack([wy0, wy0, wy1, wy1], dim=-1)
    valid = (xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)
    xc = torch.clamp(xi, 0, w - 1).to(torch.int32)
    yc = torch.clamp(yi, 0, h - 1).to(torch.int32)
    return yc * w + xc, wy * wx * valid.float()


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
    compute dtype (``mix_rows_plain``), then ``apply_ray_plain``.
    feat_map [B, H, W, C], uv [B, R, 2], z [B, R, T] -> [B, R, T, out]."""
    b, h, w, c = feat_map.shape
    idx, wgt = bilinear_taps(uv, h, w)
    table = _table(p, feat_map)
    feat = torch.stack([
        mix_rows.mix_rows_plain(table[i], wgt[i], idx=idx[i])
        for i in range(b)])
    return apply_ray_plain(p, feat, z)


def mix_gather_rows(p: RayMlpPacked, table: torch.Tensor, idx: torch.Tensor,
                    wgt: torch.Tensor) -> torch.Tensor:
    """The bf16 route's pass: table [H*W, c_f] bf16 + idx [R, 4] int32 +
    wgt [R, 4] f32 -> the rays' feature rows [R, widths[0]] bf16."""
    return mix_rows.launch_mix_rows(LIBRARY, "mix_gather_rows", table, wgt,
                                    p.widths[0], idx=idx)


def _launch(p: RayMlpPacked, feat_map: torch.Tensor, uv: torch.Tensor,
            z: torch.Tensor) -> torch.Tensor:
    _, h, w, _ = feat_map.shape
    r = uv.shape[1]
    taps = _check_taps(1, r, z)
    table = _table(p, feat_map)[0]
    idx, wgt = bilinear_taps(uv, h, w)
    idx, wgt = idx.reshape(r, 4).contiguous(), wgt.reshape(r, 4).contiguous()
    zz = z.to(torch.float32).reshape(r, taps).contiguous()
    if p.dtype == torch.bfloat16:
        tray.check_wgmma_pack(p)
        out = tray.launch_ray_wgmma(p, mix_gather_rows(p, table, idx, wgt),
                                    zz)
    else:
        if p.widths[0] > p.c_f:
            table = torch.nn.functional.pad(table, (0, p.widths[0] - p.c_f))
        out = launch_packed(LIBRARY, "fused_gather_mlp_forward", p,
                            table.contiguous(), r, taps, z=zz,
                            gather=(idx, wgt))
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
