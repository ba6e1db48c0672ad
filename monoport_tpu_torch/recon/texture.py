"""The texture stage: netC's colour query over the fine ray lattice, as a
canvas of colours where the surface maps are valid and white elsewhere
(the colour half of ``monoport_tpu/engine.py``'s ``_texture_canvas``).

With a window the colours are queried on the window^2 ray lattice over
the subject's bbox and resampled back onto the full lattice (an exact
gather at stride 1). A frontal frame queries that lattice through the
separable grid query; every other frame queries points: either at the
rays the last refine level gathered (its ``RayCompaction``), or at the
window's valid rays padded to a static budget, or at the whole window.
Shapes stay static and nothing here synchronises the stream.
"""

from __future__ import annotations

from typing import Callable

import torch

from .depth_peel import SurfaceMaps, colorize
from .ray_refine import (RayCompaction, axis_window, compact_budget,
                         f32_constant, sample_grid, valid_indices)


def texture_canvas(maps: SurfaceMaps, resolution: int, b_min, b_max,
                   window: int | None = None,
                   color_grid: Callable | None = None,
                   query_color: Callable | None = None,
                   compact: float | None = None,
                   telemetry: list | None = None,
                   reuse: RayCompaction | None = None) -> torch.Tensor:
    """Texture canvas [r, r, 3] of ``maps`` (an r^2 ray lattice, r =
    ``resolution``, over the recon bounds ``b_min`` / ``b_max``) through
    one of the two colour queries, on the ``window``^2 ray lattice over
    the subject's bbox when a window is set.

    ``color_grid`` (frontal frames): the separable grid query (xw [h], yw
    [w], zw [h, w]) -> [h, w, 3].
    ``query_color`` (every other frame): the per-point query [1, K, 3] ->
    [1, K, 3] on the same window lattice. ``compact``: query just the
    window pixels whose ray is valid, padded to this fraction of the
    window lattice; the rest stay background white and are masked by
    ``maps.valid`` anyway. ``reuse``: the last refine level's compaction;
    the colour query runs at that level's gathered rays and refined
    depths. World coordinates step by 1/r here, not by the refine's
    1/(r-1). ``telemetry``: a list that receives the compacted query's
    dropped valid pixels as a 0-d int32 device tensor."""
    r = resolution
    dev = maps.depth.device
    lo = f32_constant(b_min, dev)
    hi = f32_constant(b_max, dev)
    sr = (hi - lo) / r
    w = reuse.w if reuse is not None else window
    fr = torch.arange(r, dtype=torch.float32, device=dev)

    def finish(color):
        color = color * 0.5 + 0.5
        return torch.where(maps.valid[..., None], color,
                           torch.ones_like(color))

    def from_window(color_w, x0, sx, y0, sy):
        u = torch.clamp((fr - x0) / sx, 0.0, w - 1)
        v = torch.clamp((fr - y0) / sy, 0.0, w - 1)
        return finish(torch.stack([sample_grid(color_w[..., k], u, v)
                                   for k in range(3)], dim=-1))

    if w is None or w >= r:
        if color_grid is not None:
            return finish(color_grid(
                fr * sr[0] + lo[0], fr * sr[1] + lo[1],
                (float(r) - maps.depth) * sr[2] + lo[2]))
        return colorize(maps, query_color, r, b_min, b_max)
    if reuse is not None:
        if telemetry is not None:
            # a ray dropped at the refine level loses its texture too
            telemetry.append(reuse.dropped)
        xw = reuse.aw * sr[0] + lo[0]
        yw = reuse.bw * sr[1] + lo[1]
        zw_sel = (float(r) - reuse.z) * sr[2] + lo[2]              # [K]
        safe = reuse.safe
        pts = torch.stack([xw[safe // w], yw[safe % w], zw_sel],
                          dim=-1)[None]                            # [1, K, 3]
        color_w = _scatter_colors(query_color(pts)[0], reuse.idx, w)
        return from_window(color_w, reuse.x0, reuse.sx, reuse.y0, reuse.sy)
    x0, sx = axis_window(maps.valid.any(dim=1), r, r, 1.0, w)
    y0, sy = axis_window(maps.valid.any(dim=0), r, r, 1.0, w)
    ar = torch.arange(w, dtype=torch.float32, device=dev)
    aw = x0 + ar * sx
    bw = y0 + ar * sy
    depth_w = sample_grid(maps.depth, aw, bw)
    xw = aw * sr[0] + lo[0]
    yw = bw * sr[1] + lo[1]
    zw = (float(r) - depth_w) * sr[2] + lo[2]
    budget = None if color_grid is not None else compact_budget(compact, w,
                                                                w)
    if color_grid is not None:
        color_w = color_grid(xw, yw, zw)
    elif budget:
        v_w = sample_grid(maps.valid.float(), aw, bw) > 0.0
        if telemetry is not None:
            # valid pixels beyond the budget keep the white background
            telemetry.append(torch.clamp(
                v_w.sum(dtype=torch.int32) - budget, min=0))
        idx = valid_indices(v_w.reshape(-1), budget)
        safe = torch.where(idx < w * w, idx, torch.zeros_like(idx))
        pts = torch.stack([xw[safe // w], yw[safe % w],
                           zw.reshape(-1)[safe]], dim=-1)[None]
        color_w = _scatter_colors(query_color(pts)[0], idx, w)
    else:
        pts = torch.stack([xw[:, None].expand(w, w),
                           yw[None, :].expand(w, w), zw],
                          dim=-1).reshape(1, -1, 3)
        color_w = query_color(pts)[0].reshape(w, w, 3)
    return from_window(color_w, x0, sx, y0, sy)


def _scatter_colors(col: torch.Tensor, idx: torch.Tensor,
                    w: int) -> torch.Tensor:
    """Colours [K, 3] at the flat window indices ``idx`` on a white
    [w, w, 3] lattice (fill entries of ``idx`` are dropped)."""
    buf = torch.ones(w * w + 1, 3, dtype=col.dtype, device=col.device)
    buf.index_put_((idx,), col)
    return buf[:w * w].reshape(w, w, 3)
