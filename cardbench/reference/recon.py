"""The plain surface localization and shading of the benchmark's
reference: a frozen copy of the real-time frame's march pyramid in plain
PyTorch, float32.

A dense first-crossing march at the first level, then refine passes
through the remaining levels and the fine lattice (the last inside a
window over the subject's coarse bounding box), each querying T z-taps a
ray around the upsampled coarse depth. Rotated views query only the
coarse-valid rays of each refine level, the first ``budget`` of them in
scan order (the budget a fraction of the lattice, rounded up to 256 rays);
rays beyond it keep the coarse silhouette. Normal shading, the texture
canvas and the display resize follow.

The host rules of a frame are here too: the hint a frame's valid share
gives the next, the budget rung a ``compact_hint`` snaps to, and the
anchor count of each rotated refine level that the calib implies.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .nets import interpolate_2d, resize_axis

COMPACT_LADDER = (0.25, 0.375, 0.5, 0.625)
HINT_SAFETY = 1.3


class SurfaceMaps(NamedTuple):
    depth: torch.Tensor
    normal: torch.Tensor
    valid: torch.Tensor


# -- host rules ------------------------------------------------------------
def snap_budget(hint: float, ceiling: float) -> float:
    """The smallest ladder rung >= ``hint``, capped at the ceiling."""
    for rung in COMPACT_LADDER:
        if rung >= hint:
            return min(rung, ceiling)
    return ceiling


def hint_from_valid(valid_fraction: float, fine_res: int, window) -> float:
    """The demo's budget hint from a frame's valid share of the fine
    lattice: rescaled to the window the budgets are fractions of, with
    headroom for the subject's growth between frames."""
    w = window or fine_res
    return valid_fraction * (fine_res / float(w)) ** 2 * HINT_SAFETY


def compact_rays(compact, h: int, w: int):
    """Ray budget of a compacted pass: ``compact`` x the lattice, rounded up
    to a multiple of 256 (None / >= 1 -> dense)."""
    if not compact or compact >= 1.0:
        return None
    return min(-(-int(h * w * compact) // 256) * 256, h * w)


def taps_ok(calib: np.ndarray) -> bool:
    """True iff the calib's image rows are z-free (the frontal and in-plane
    paths; every other calib takes the rotated path)."""
    return bool(np.abs(np.asarray(calib)[..., :2, 2]).max() < 1e-6)


def anchor_plan(calib: np.ndarray, image_h: int, pairs, taps: int,
                anchor_texels: float, b_min, b_max) -> tuple:
    """Anchor count of each rotated refine level (None: exact per point):
    the most feature texels a level's tap span sweeps in the image, over
    a 5 x 5 grid of probe rays at three depths, split into lerp segments
    of at most ``anchor_texels`` texels."""
    c = np.asarray(calib, np.float64).reshape(-1, 4, 4)[0]
    feat_hw = max(image_h // 4, 2)
    b_min = np.asarray(b_min, np.float64)
    b_max = np.asarray(b_max, np.float64)
    ax = np.linspace(0.0, 1.0, 5)
    gx, gy = np.meshgrid(ax, ax, indexing="ij")
    xy = np.stack([b_min[0] + gx.ravel() * (b_max[0] - b_min[0]),
                   b_min[1] + gy.ravel() * (b_max[1] - b_min[1])], -1)

    def uv(pts):
        return (pts @ c[:3, :3].T + c[:3, 3])[..., :2]

    z_range = float(b_max[2] - b_min[2])
    plan = []
    for rc, rf in pairs:
        pad = math.ceil((rf - 1) / (rc - 1)) + 1
        world_span = (2 * pad + 1) * z_range / (rf - 1)
        span = 0.0
        for z0f in (0.0, 0.5, 1.0 - world_span / z_range):
            p0 = np.concatenate(
                [xy, np.full((len(xy), 1), b_min[2] + z0f * z_range)], -1)
            p1 = p0.copy()
            p1[:, 2] += world_span
            span = max(span, float(
                np.linalg.norm(uv(p1) - uv(p0), axis=-1).max()))
        k = max(2, math.ceil(span * 0.5 * (feat_hw - 1) / anchor_texels) + 1)
        plan.append(k if k < taps else None)
    return tuple(plan)


# -- the march pyramid -------------------------------------------------------
def _vec(x, device):
    return torch.tensor(tuple(x), dtype=torch.float32, device=device)


def _first_crossing(vals, c_taps, bal):
    taps = vals.shape[-1]
    occ = vals > bal
    hit = occ.any(dim=-1)
    weights = torch.arange(taps, 0, -1, dtype=torch.int32, device=vals.device)
    first = torch.argmax(occ.to(torch.int32) * weights, dim=-1)
    prev = torch.clamp(first - 1, min=0)

    def take(m, i):
        return torch.gather(m, -1, i[..., None])[..., 0]

    v1, v2 = take(vals, first), take(vals, prev)
    c1, c2 = take(c_taps, first), take(c_taps, prev)
    denom = v2 - v1
    z = (c2 * (bal - v1) + c1 * (v2 - bal)) / torch.where(
        torch.abs(denom) > 1e-12, denom, torch.ones_like(denom))
    return z, hit, v1, v2, c1, c2


def _shift2(z, dim):
    n = z.shape[dim]
    idx = torch.clamp(torch.arange(n, device=z.device) - 2, min=0)
    return torch.index_select(z, dim, idx)


def _normals(z, dvdz, nz, valid, spacing) -> SurfaceMaps:
    norm = torch.stack([(z - _shift2(z, 0)) * dvdz / spacing[0],
                        (z - _shift2(z, 1)) * dvdz / spacing[1], nz], dim=-1)
    norm = norm / torch.clamp(torch.linalg.vector_norm(
        norm, dim=-1, keepdim=True), min=1e-9)
    return SurfaceMaps(z, norm, valid)


def sample_grid(img, xi, yi):
    """Separable bilinear sample of img [H, W] at xi [h] x yi [w]."""
    h, w = img.shape
    x0 = torch.clamp(torch.floor(xi).long(), 0, h - 1)
    x1 = torch.clamp(x0 + 1, max=h - 1)
    fx = torch.clamp(xi - x0, 0.0, 1.0)
    rows = img[x0] * (1.0 - fx)[:, None] + img[x1] * fx[:, None]
    y0 = torch.clamp(torch.floor(yi).long(), 0, w - 1)
    y1 = torch.clamp(y0 + 1, max=w - 1)
    fy = torch.clamp(yi - y0, 0.0, 1.0)
    return rows[:, y0] * (1.0 - fy)[None, :] + rows[:, y1] * fy[None, :]


def first_valid(flat_valid, budget: int):
    """The first ``budget`` set positions of ``flat_valid``, ascending,
    filled with n."""
    n = flat_valid.shape[0]
    pos = torch.nonzero(flat_valid).reshape(-1)[:budget]
    return torch.cat([pos, pos.new_full((budget - pos.shape[0],), n)])


def _scatter(init, idx, upd):
    h, w = init.shape
    flat = torch.cat([init.reshape(-1), init.new_zeros(1)])
    return flat.scatter(0, idx, upd.to(init.dtype))[:h * w].reshape(h, w)


class Queries(NamedTuple):
    occ: object            # points [1, N, 3] -> occupancy [N]
    taps: object           # one entry a refine level: (xy, z) -> [R, T]


def _point_taps(q_occ, xy, wz):
    r, t = wz.shape
    pts = torch.stack([xy[:, None, 0].expand(r, t), xy[:, None, 1].expand(r, t),
                       wz], dim=-1)
    return q_occ(pts.reshape(1, -1, 3)).reshape(r, t)


def _refine(q: Queries, level: int, depth_f, valid_f, ax, by, rf, taps,
            scale, bal, b_min, b_max, spacing, budget, state):
    dev = depth_f.device
    pad = math.ceil(scale) + 1
    offsets = torch.as_tensor(np.linspace(-pad, pad + 1, taps).astype(
        np.float32), device=dev)
    b_min = _vec(b_min, dev)
    step = (_vec(b_max, dev) - b_min) / (rf - 1)
    h, w = depth_f.shape
    xw1 = ax * step[0] + b_min[0]
    yw1 = by * step[1] + b_min[1]
    taps_fn = q.taps[level] or (lambda xy, wz: _point_taps(q.occ, xy, wz))
    if not budget:
        c_taps = torch.clamp(depth_f[..., None] + offsets, 0.0, rf - 1)
        wz = ((rf - 1) - c_taps) * step[2] + b_min[2]
        xy = torch.stack([xw1[:, None].expand(h, w),
                          yw1[None, :].expand(h, w)], dim=-1).reshape(-1, 2)
        vals = taps_fn(xy, wz.reshape(-1, taps)).reshape(h, w, taps)
        z, hit, v1, v2, c1, c2 = _first_crossing(vals, c_taps, bal)
        z = torch.where(hit, torch.clamp(z, 0.0, float(rf)), depth_f)
        dvdz = (v1 - v2) / torch.clamp(c1 - c2, min=1e-6)
        return _normals(z, dvdz, v2 - v1, hit & valid_f, spacing)
    n = h * w
    flat_valid = valid_f.reshape(-1)
    dropped = torch.clamp(flat_valid.sum() - budget, min=0)
    idx = first_valid(flat_valid, budget)
    sel_ok = idx < n
    safe = torch.where(sel_ok, idx, torch.zeros_like(idx))
    d_sel = depth_f.reshape(-1)[safe]
    c_taps = torch.clamp(d_sel[:, None] + offsets, 0.0, rf - 1)
    wz = ((rf - 1) - c_taps) * step[2] + b_min[2]
    xy = torch.stack([xw1[safe // w], yw1[safe % w]], dim=-1)
    vals = taps_fn(xy, wz)
    z, hit, v1, v2, c1, c2 = _first_crossing(vals, c_taps, bal)
    z = torch.where(hit, torch.clamp(z, 0.0, float(rf)), d_sel)
    dvdz = (v1 - v2) / torch.clamp(c1 - c2, min=1e-6)
    if state is not None:
        state.update(idx=idx, safe=safe, z=z, dropped=dropped)
    z_full = _scatter(depth_f, idx, z)
    hit_full = _scatter(torch.zeros_like(valid_f), idx, hit)
    queried = _scatter(torch.zeros_like(valid_f), idx, sel_ok)
    dvdz_full = _scatter(torch.zeros_like(depth_f), idx, dvdz)
    nz_full = _scatter(torch.full_like(depth_f, -1.0), idx, v2 - v1)
    valid = torch.where(queried, hit_full, valid_f) & valid_f
    return _normals(z_full, dvdz_full, nz_full, valid, spacing)


def _axis_window(any_valid, rc, rf, scale, window):
    idx = torch.arange(rc, dtype=torch.float32, device=any_valid.device)
    lo = torch.where(any_valid, idx, torch.full_like(idx, float(rc))).min()
    hi = torch.where(any_valid, idx, torch.full_like(idx, -1.0)).max()
    has = hi >= lo
    lo = torch.where(has, lo, torch.zeros_like(lo))
    hi = torch.where(has, hi, torch.full_like(hi, rc - 1.0))
    margin = 1.5 * scale
    f_lo = torch.clamp(lo * scale - margin, min=0.0)
    f_hi = torch.clamp(hi * scale + margin, max=rf - 1.0)
    stride = torch.clamp((f_hi - f_lo) / (window - 1), min=1.0)
    start = (f_lo + f_hi) * 0.5 - stride * (window - 1) * 0.5
    start = torch.minimum(torch.clamp(start, min=0.0),
                          rf - 1 - stride * (window - 1))
    start = torch.where(stride <= 1.0, torch.round(start), start)
    return start, stride


def _refine_level(q, level, coarse, rc, rf, taps, bal, b_min, b_max, window,
                  compact, state):
    dev = coarse.depth.device
    scale = (rf - 1) / (rc - 1)
    v = coarse.valid.float()
    d = torch.nan_to_num(coarse.depth, nan=0.0) * v

    def up(img):
        return interpolate_2d(img[None, ..., None], (rf, rf))[0, ..., 0]

    wsum = up(v)
    depth_f = torch.where(wsum > 1e-6, up(d) / torch.clamp(wsum, min=1e-6),
                          torch.zeros_like(wsum)) * scale
    valid_f = wsum > 0.0
    if window is None or window >= rf:
        a = torch.arange(rf, dtype=torch.float32, device=dev)
        return _refine(q, level, depth_f, valid_f, a, a, rf, taps, scale, bal,
                       b_min, b_max, (1.0, 1.0), compact_rays(compact, rf, rf),
                       None)
    x0, sx = _axis_window(coarse.valid.any(dim=1), rc, rf, scale, window)
    y0, sy = _axis_window(coarse.valid.any(dim=0), rc, rf, scale, window)
    ar_w = torch.arange(window, dtype=torch.float32, device=dev)
    aw, bw = x0 + ar_w * sx, y0 + ar_w * sy
    d_w = sample_grid(depth_f, aw, bw)
    v_w = sample_grid(valid_f.float(), aw, bw) > 0.0
    core: dict = {}
    maps_w = _refine(q, level, d_w, v_w, aw, bw, rf, taps, scale, bal, b_min,
                     b_max, (sx, sy), compact_rays(compact, window, window),
                     core)
    if core and state is not None:
        state.update(core, w=window, x0=x0, sx=sx, y0=y0, sy=sy, aw=aw, bw=bw)
    ar = torch.arange(rf, dtype=torch.float32, device=dev)
    u, vv = (ar - x0) / sx, (ar - y0) / sy
    inside = (((u >= 0) & (u <= window - 1))[:, None]
              & ((vv >= 0) & (vv <= window - 1))[None, :])
    uc = torch.clamp(u, 0.0, window - 1)
    vc = torch.clamp(vv, 0.0, window - 1)
    depth = torch.where(inside, sample_grid(maps_w.depth, uc, vc), depth_f)
    fallback = torch.zeros(rf, rf, 3, device=dev)
    fallback[..., 2] = -1.0
    norm_w = torch.stack([sample_grid(maps_w.normal[..., k], uc, vc)
                          for k in range(3)], dim=-1)
    norm_w = norm_w / torch.clamp(torch.linalg.vector_norm(
        norm_w, dim=-1, keepdim=True), min=1e-9)
    norm = torch.where(inside[..., None], norm_w, fallback)
    valid_w = sample_grid(maps_w.valid.float(), uc, vc) > 0.5
    return SurfaceMaps(depth, norm, torch.where(inside, valid_w, valid_f))


def march(q: Queries, res: int, bal, b_min, b_max, device) -> SurfaceMaps:
    """Dense first crossing of res^2 frontal rays over res z-taps."""
    b_min_t = _vec(b_min, device)
    step = (_vec(b_max, device) - b_min_t) / (res - 1)
    a = torch.arange(res, dtype=torch.float32, device=device)
    c_taps = a.expand(res, res, res)
    wz = ((res - 1) - c_taps) * step[2] + b_min_t[2]
    xw1, yw1 = a * step[0] + b_min_t[0], a * step[1] + b_min_t[1]
    pts = torch.stack([xw1[:, None, None].expand(res, res, res),
                       yw1[None, :, None].expand(res, res, res), wz], dim=-1)
    vals = q.occ(pts.reshape(1, -1, 3)).reshape(res, res, res)
    z, hit, *_ = _first_crossing(vals, c_taps, bal)
    z = torch.where(hit, torch.clamp(z, 0.0, float(res)), torch.zeros_like(z))
    norm = torch.zeros(res, res, 3, device=device)
    norm[..., 2] = -1.0
    return SurfaceMaps(z, norm, hit)


def pyramid(q: Queries, fine_res, levels, taps, bal, b_min, b_max, window,
            compact, state, device) -> SurfaceMaps:
    """March at levels[0], refine through the other levels, then at
    ``fine_res`` inside the window."""
    maps = march(q, levels[0], bal, b_min, b_max, device)
    for i, (rc, rl) in enumerate(zip(levels[:-1], levels[1:])):
        maps = _refine_level(q, i, maps, rc, rl, taps, bal, b_min, b_max,
                             None, compact, None)
    return _refine_level(q, len(levels) - 1, maps, levels[-1], fine_res, taps,
                         bal, b_min, b_max, window, compact, state)


# -- shading and texture -------------------------------------------------------
def shade_normal(maps: SurfaceMaps) -> torch.Tensor:
    color = torch.clamp((maps.normal + 1.0) * 0.5, 0.0, 1.0)
    return torch.where(maps.valid[..., None], color, torch.ones_like(color))


def visualize(canvas, size: int):
    """rot90, nearest resize to ``size`` -> the image [S, S, 3] in [0, 1]."""
    img = torch.rot90(canvas, 1, dims=(0, 1))
    return resize_axis(resize_axis(img, 0, size, "nearest"), 1, size,
                       "nearest")


def texture_canvas(maps: SurfaceMaps, r: int, window, q_color, b_min, b_max,
                   state) -> torch.Tensor:
    """Colours of the surface points on a window^2 lattice over the
    subject's bbox, resampled back onto the r^2 canvas; with ``state`` (the
    fine level's compaction) only its rays at their refined depth."""
    dev = maps.depth.device
    b_min_t, b_max_t = _vec(b_min, dev), _vec(b_max, dev)
    sr = (b_max_t - b_min_t) / r
    fr = torch.arange(r, dtype=torch.float32, device=dev)

    def finish(color_w, x0, sx, y0, sy, n):
        u = torch.clamp((fr - x0) / sx, 0.0, n - 1)
        v = torch.clamp((fr - y0) / sy, 0.0, n - 1)
        color = torch.stack([sample_grid(color_w[..., k], u, v)
                             for k in range(3)], dim=-1) * 0.5 + 0.5
        return torch.where(maps.valid[..., None], color,
                           torch.ones_like(color))

    if state:
        w = state["w"]
        xw = state["aw"] * sr[0] + b_min_t[0]
        yw = state["bw"] * sr[1] + b_min_t[1]
        zw = (float(r) - state["z"]) * sr[2] + b_min_t[2]
        safe = state["safe"]
        pts = torch.stack([xw[safe // w], yw[safe % w], zw], dim=-1)[None]
        buf = torch.ones(w * w + 1, 3, device=dev)
        buf.index_put_((state["idx"],), q_color(pts))
        return finish(buf[:w * w].reshape(w, w, 3), state["x0"], state["sx"],
                      state["y0"], state["sy"], w)
    x0, sx = _axis_window(maps.valid.any(dim=1), r, r, 1.0, window)
    y0, sy = _axis_window(maps.valid.any(dim=0), r, r, 1.0, window)
    ar = torch.arange(window, dtype=torch.float32, device=dev)
    aw, bw = x0 + ar * sx, y0 + ar * sy
    depth_w = sample_grid(maps.depth, aw, bw)
    xw, yw = aw * sr[0] + b_min_t[0], bw * sr[1] + b_min_t[1]
    zw = (float(r) - depth_w) * sr[2] + b_min_t[2]
    pts = torch.stack([xw[:, None].expand(window, window),
                       yw[None, :].expand(window, window), zw], dim=-1)
    color_w = q_color(pts.reshape(1, -1, 3)).reshape(window, window, 3)
    return finish(color_w, x0, sx, y0, sy, window)
