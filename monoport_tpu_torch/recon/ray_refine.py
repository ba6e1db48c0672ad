"""Per-ray surface localization: the march pyramid of the real-time
frames, frontal and rotated, and the fine pass over a coarse volume (port
of ``monoport_tpu/recon/ray_refine.py``).

``ray_refine`` peels a coarse hierarchy volume into per-ray maps and
refines them at ``fine_res``. ``ray_pyramid`` needs no volume: it runs a dense first-crossing march at a coarse level, then
refines through the remaining levels and finally ``fine_res`` inside an
optional subject-bbox window. Each pass queries T z-taps per ray through
the grid-structured query (separable sampling + the fused ray MLP), a
ray-structured query (shared-feature taps, or the anchored query of a
rotated view), or a per-point ``query_fn``. All of it is 2D map work on
``[R, R]`` tensors; the pyramid holds no 3D volume.

Rotated views lose the outer-product lattice, so their refine levels are
compacted: only the coarse-valid rays are queried, padded to a static
budget. Shapes stay static and nothing here synchronises the stream: the
valid rays are selected with ``ops/compaction.select_k`` (no ``nonzero``),
and the dropped-ray counts stay device scalars.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..ops.compaction import select_k
from ..ops.constants import device_constant, float_array
from ..ops.resize import interpolate_2d
from ..utils import profiling
from .depth_peel import SurfaceMaps, depth_peel


def f32_constant(x, device) -> torch.Tensor:
    """The f32 vector ``x`` (a host sequence, e.g. a recon bound) as a
    cached constant on ``device`` (``ops/constants.device_constant``)."""
    return device_constant(float_array, (tuple(x),), device, torch.float32)


class RayCompaction(NamedTuple):
    """The last refine level's compaction on its window, which a per-point
    texture query reuses (``recon/texture.texture_canvas``). Built by
    ``refine_from_maps`` alone; every tensor is on the device.

    idx: [K] the gathered flat window indices, ascending, filled with w*w
      (``valid_indices``); safe: idx with the fill entries at 0.
    z: [K] the refined depth of each gathered ray, in fine voxels.
    dropped: 0-d int32, the valid rays beyond the budget.
    w: the window's side; x0 / sx, y0 / sy: its start and stride along
      each axis in fine units (``axis_window``); aw / bw: [w] its ray
      coordinates along each axis, in fine units."""
    idx: torch.Tensor
    safe: torch.Tensor
    z: torch.Tensor
    dropped: torch.Tensor
    w: int
    x0: torch.Tensor
    sx: torch.Tensor
    y0: torch.Tensor
    sy: torch.Tensor
    aw: torch.Tensor
    bw: torch.Tensor


def _tap_offsets(pad: int, taps: int) -> np.ndarray:
    return np.linspace(-pad, pad + 1, taps).astype(np.float32)


def _first_crossing(vals: torch.Tensor, c_taps: torch.Tensor,
                    balance_value: float):
    """First iso-crossing along the tap axis: vals/c_taps [..., T] ->
    (z sub-tap crossing depth, hit mask, v1, v2, c1, c2)."""
    taps = vals.shape[-1]
    occ = vals > balance_value
    hit = occ.any(dim=-1)
    weights = torch.arange(taps, 0, -1, dtype=torch.int32, device=vals.device)
    first = torch.argmax(occ.to(torch.int32) * weights, dim=-1)
    prev = torch.clamp(first - 1, min=0)

    def take(m, i):
        return torch.gather(m, -1, i[..., None])[..., 0]

    v1, v2 = take(vals, first), take(vals, prev)
    c1, c2 = take(c_taps, first), take(c_taps, prev)
    denom = v2 - v1
    z = (c2 * (balance_value - v1) + c1 * (v2 - balance_value)) / torch.where(
        torch.abs(denom) > 1e-12, denom, torch.ones_like(denom))
    return z, hit, v1, v2, c1, c2


def _refine_core(query_fn: Callable | None, depth_f: torch.Tensor,
                 valid_f: torch.Tensor, ax: torch.Tensor, by: torch.Tensor,
                 rf: int, taps: int, scale: float, balance_value: float,
                 b_min, b_max, spacing=(1.0, 1.0),
                 query_taps_fn: Callable | None = None,
                 query_grid_fn: Callable | None = None,
                 budget: int | None = None,
                 telemetry: list | None = None):
    """Fine pass over the outer-product ray grid ax [H] x by [W] with the
    upsampled coarse maps depth_f/valid_f [H, W]; ``spacing`` is the ray
    pitch in fine units along each axis. ``budget``: query only the
    coarse-valid rays, padded to this static count
    (``_refine_core_compact``, which also documents ``telemetry``); the
    grid path ignores it, its lattice must stay an outer product.
    -> (SurfaceMaps, the compact pass's gathered rays or None)."""
    dev = depth_f.device
    pad = math.ceil(scale) + 1
    offsets = device_constant(_tap_offsets, (pad, taps), dev, torch.float32)
    b_min = f32_constant(b_min, dev)
    step = (f32_constant(b_max, dev) - b_min) / (rf - 1)
    h, w = depth_f.shape
    xw1 = ax * step[0] + b_min[0]                               # [H]
    yw1 = by * step[1] + b_min[1]                               # [W]

    if budget and query_grid_fn is None:
        return _refine_core_compact(query_fn, depth_f, valid_f, xw1, yw1,
                                    rf, offsets, balance_value, step, b_min,
                                    spacing, budget,
                                    query_taps_fn=query_taps_fn,
                                    telemetry=telemetry)

    c_taps = torch.clamp(depth_f[..., None] + offsets, 0.0, rf - 1)
    # vol index i = rf-1-c; world z from it
    wz = ((rf - 1) - c_taps) * step[2] + b_min[2]               # [H, W, T]
    vals = _query_lattice(query_fn, query_taps_fn, query_grid_fn, xw1, yw1,
                          wz)

    z, hit, v1, v2, c1, c2 = _first_crossing(vals, c_taps, balance_value)
    z = torch.clamp(z, 0.0, float(rf))
    # rays whose taps missed the surface fall back to the coarse depth
    z = torch.where(hit, z, depth_f)
    # the refined silhouette is the tap-verified one
    valid = hit & valid_f
    dvdz = (v1 - v2) / torch.clamp(c1 - c2, min=1e-6)
    return _normals_from_maps(z, dvdz, v2 - v1, valid, h, w, spacing), None


def _query_lattice(query_fn, query_taps_fn, query_grid_fn, xw1, yw1, wz):
    """Occupancy at the lattice xw1 [H] x yw1 [W] x wz [H, W, T] -> [H, W, T]
    through the first query form given: grid, ray taps, per point."""
    h, w, taps = wz.shape
    if query_grid_fn is not None:
        return query_grid_fn(xw1, yw1, wz).float()
    if query_taps_fn is not None:
        xy = torch.stack([xw1[:, None].expand(h, w),
                          yw1[None, :].expand(h, w)], dim=-1)
        vals = query_taps_fn(xy.reshape(1, -1, 2), wz.reshape(1, -1, taps))
        return vals.reshape(h, w, taps).float()
    pts = torch.stack([xw1[:, None, None].expand(h, w, taps),
                       yw1[None, :, None].expand(h, w, taps), wz], dim=-1)
    return query_fn(pts.reshape(1, -1, 3))[0, :, 0].reshape(h, w, taps).float()


def valid_indices(flat_valid: torch.Tensor, budget: int) -> torch.Tensor:
    """The first ``budget`` indices at which ``flat_valid`` [n] is set,
    ascending, filled with n (``flatnonzero`` with a static size); no
    count reaches the host."""
    return select_k(flat_valid, budget)[0]


def _scatter_rows(init: torch.Tensor, idx: torch.Tensor,
                  upd: torch.Tensor) -> torch.Tensor:
    """``init`` [h, w] with ``upd`` [K] written at the flat indices ``idx``;
    fill entries of ``idx`` (= h * w) go to a spare slot that is cut."""
    h, w = init.shape
    flat = torch.cat([init.reshape(-1), init.new_zeros(1)])
    return flat.scatter(0, idx, upd.to(init.dtype))[:h * w].reshape(h, w)


def _refine_core_compact(query_fn: Callable | None, depth_f, valid_f, xw1,
                         yw1, rf: int, offsets, balance_value: float, step,
                         b_min, spacing, budget: int,
                         query_taps_fn: Callable | None = None,
                         telemetry: list | None = None):
    """Compacted fine pass: gather the coarse-valid rays (padded to
    ``budget``), query only their taps, scatter the crossings back onto
    the lattice. The ray batch rides ``query_taps_fn`` when given (the
    anchored rotated query takes any [1,R,2] + [1,R,T] ray batch) else the
    per-point ``query_fn``. Valid-ray results equal the dense pass (their
    taps are the same points); rays beyond the budget keep the coarse
    silhouette, never a hole.
    ``telemetry``: a list that receives the dropped-ray count (valid rays
    beyond the budget) as a 0-d int32 device tensor.
    -> (SurfaceMaps, (idx, safe, z, dropped)): the gathered index set,
    its in-range copy, the refined per-ray depth and the dropped count,
    from which ``refine_from_maps`` builds a ``RayCompaction``."""
    h, w = depth_f.shape
    n = h * w
    flat_valid = valid_f.reshape(-1)
    dropped = torch.clamp(flat_valid.sum(dtype=torch.int32) - budget, min=0)
    if telemetry is not None:
        telemetry.append(dropped)
    idx = valid_indices(flat_valid, budget)                      # [K]
    sel_ok = idx < n
    safe = torch.where(sel_ok, idx, torch.zeros_like(idx))
    d_sel = depth_f.reshape(-1)[safe]                            # [K]
    c_taps = torch.clamp(d_sel[:, None] + offsets, 0.0, rf - 1)  # [K, T]
    wz = ((rf - 1) - c_taps) * step[2] + b_min[2]
    wx = xw1[safe // w]
    wy = yw1[safe % w]
    taps = offsets.shape[0]
    if query_taps_fn is not None:
        xy = torch.stack([wx, wy], dim=-1)[None]                 # [1, K, 2]
        vals = query_taps_fn(xy, wz[None])[0].float()
    else:
        pts = torch.stack([wx[:, None].expand(budget, taps),
                           wy[:, None].expand(budget, taps), wz],
                          dim=-1).reshape(1, -1, 3)
        vals = query_fn(pts)[0, :, 0].reshape(budget, taps).float()

    z, hit, v1, v2, c1, c2 = _first_crossing(vals, c_taps, balance_value)
    z = torch.where(hit, torch.clamp(z, 0.0, float(rf)), d_sel)
    dvdz = (v1 - v2) / torch.clamp(c1 - c2, min=1e-6)

    # unqueried rays keep the coarse depth and a viewer-facing normal, and
    # on budget overflow only, the coarse silhouette instead of a hole
    z_full = _scatter_rows(depth_f, idx, z)
    hit_full = _scatter_rows(torch.zeros_like(valid_f), idx, hit)
    queried = _scatter_rows(torch.zeros_like(valid_f), idx, sel_ok)
    dvdz_full = _scatter_rows(torch.zeros_like(depth_f), idx, dvdz)
    nz_full = _scatter_rows(torch.full_like(depth_f, -1.0), idx, v2 - v1)
    valid = torch.where(queried, hit_full, valid_f) & valid_f
    return (_normals_from_maps(z_full, dvdz_full, nz_full, valid, h, w,
                               spacing), (idx, safe, z, dropped))


def ray_refine(query_fn: Callable | None, vol_coarse: torch.Tensor,
               fine_res: int, taps: int = 6, balance_value: float = 0.5,
               b_min=(-1.0, -1.0, -1.0), b_max=(1.0, 1.0, 1.0),
               direction: str = "front", window: int | None = None,
               query_taps_fn: Callable | None = None,
               query_grid_fn: Callable | None = None) -> SurfaceMaps:
    """Coarse volume -> SurfaceMaps at ``fine_res`` ray resolution (depth
    in fine voxels along the viewing axis, ``depth_peel``'s convention):
    the coarse volume is peeled into per-ray maps and refined by
    ``refine_from_maps`` (which documents ``window`` and the queries)."""
    with profiling.span("recon.peel"):
        coarse = depth_peel(vol_coarse, direction, balance_value)
    rc = vol_coarse.shape[0]
    with profiling.span("recon.refine", **{"from": rc, "to": fine_res}):
        return refine_from_maps(query_fn, coarse, rc, fine_res, taps=taps,
                                balance_value=balance_value, b_min=b_min,
                                b_max=b_max, window=window,
                                query_taps_fn=query_taps_fn,
                                query_grid_fn=query_grid_fn)


def compact_budget(compact: float | None, h: int, w: int) -> int | None:
    """Ray budget of a compacted pass: ``compact`` x the lattice size,
    rounded up to a multiple of 256 (None / >= 1.0 -> dense)."""
    if not compact or compact >= 1.0:
        return None
    return min(-(-int(h * w * compact) // 256) * 256, h * w)


def _shift2(z: torch.Tensor, dim: int) -> torch.Tensor:
    """z[i - 2] along ``dim``, edge-clamped (2-sample backward difference)."""
    n = z.shape[dim]
    idx = torch.clamp(torch.arange(n, device=z.device) - 2, min=0)
    return torch.index_select(z, dim, idx)


def _normals_from_maps(z, dvdz, nz, valid, h, w, spacing) -> SurfaceMaps:
    # z-gradient from adjacent taps; x/y from neighbour-ray depth
    # differences: v(x-2) - v(x) at fixed c ~ (z(x-2) - z(x)) * dv/dc
    norm_x = (z - _shift2(z, 0)) * dvdz / spacing[0]
    norm_y = (z - _shift2(z, 1)) * dvdz / spacing[1]
    norm = torch.stack([norm_x, norm_y, nz], dim=-1)
    norm = norm / torch.clamp(torch.linalg.vector_norm(norm, dim=-1,
                                                       keepdim=True), min=1e-9)
    return SurfaceMaps(depth=z, normal=norm, valid=valid)


def _upsampled_coarse(coarse: SurfaceMaps, rf: int, scale: float):
    # valid-WEIGHTED bilinear upsample of the coarse depth: invalid coarse
    # pixels contribute zero weight instead of a zero depth
    v = coarse.valid.float()
    d = torch.nan_to_num(coarse.depth, nan=0.0) * v

    def up(img):
        return interpolate_2d(img[None, ..., None], (rf, rf),
                              "bilinear")[0, ..., 0]

    wsum = up(v)
    depth_f = torch.where(wsum > 1e-6, up(d) / torch.clamp(wsum, min=1e-6),
                          torch.zeros_like(wsum)) * scale
    return depth_f, wsum > 0.0


def refine_from_maps(query_fn: Callable | None, coarse: SurfaceMaps, rc: int,
                     fine_res: int, taps: int = 6,
                     balance_value: float = 0.5,
                     b_min=(-1.0, -1.0, -1.0), b_max=(1.0, 1.0, 1.0),
                     window: int | None = None,
                     query_taps_fn: Callable | None = None,
                     query_grid_fn: Callable | None = None,
                     compact: float | None = None,
                     telemetry: list | None = None,
                     compact_state: list | None = None) -> SurfaceMaps:
    """Fine pass from coarse per-ray maps (rc^2 grid, depth in rc-voxel
    units). ``window``: refine only a window^2 ray block spread over the
    subject's coarse bbox at stride >= 1; outside it the coarse maps stay.
    ``compact``: non-grid paths query just the coarse-valid rays, padded
    to a static budget of this fraction of the lattice; ``telemetry``
    collects the dropped-ray counts. ``compact_state``: a list that
    receives this level's ``RayCompaction`` (windowed compact path only),
    for a texture query that reuses this compaction. Opens no span: its
    callers open ``recon.refine`` around it."""
    rf = fine_res
    dev = coarse.depth.device
    scale = (rf - 1) / (rc - 1)
    depth_f, valid_f = _upsampled_coarse(coarse, rf, scale)

    if window is None or window >= rf:
        a = torch.arange(rf, dtype=torch.float32, device=dev)
        return _refine_core(query_fn, depth_f, valid_f, a, a, rf, taps,
                            scale, balance_value, b_min, b_max,
                            query_taps_fn=query_taps_fn,
                            query_grid_fn=query_grid_fn,
                            budget=compact_budget(compact, rf, rf),
                            telemetry=telemetry)[0]

    x0, sx = axis_window(coarse.valid.any(dim=1), rc, rf, scale, window)
    y0, sy = axis_window(coarse.valid.any(dim=0), rc, rf, scale, window)
    ar_w = torch.arange(window, dtype=torch.float32, device=dev)
    aw = x0 + ar_w * sx
    bw = y0 + ar_w * sy
    d_w = sample_grid(depth_f, aw, bw)
    v_w = sample_grid(valid_f.float(), aw, bw) > 0.0
    maps_w, gathered = _refine_core(
        query_fn, d_w, v_w, aw, bw, rf, taps, scale, balance_value,
        b_min, b_max, spacing=(sx, sy), query_taps_fn=query_taps_fn,
        query_grid_fn=query_grid_fn,
        budget=compact_budget(compact, window, window),
        telemetry=telemetry)
    if compact_state is not None and gathered is not None:
        compact_state.append(RayCompaction(*gathered, w=window, x0=x0,
                                           sx=sx, y0=y0, sy=sy, aw=aw,
                                           bw=bw))

    # resample the refined window back onto the full fine grid (an exact
    # gather at stride 1); outside the window keep the coarse maps
    ar = torch.arange(rf, dtype=torch.float32, device=dev)
    u = (ar - x0) / sx
    v = (ar - y0) / sy
    inside = (((u >= 0) & (u <= window - 1))[:, None]
              & ((v >= 0) & (v <= window - 1))[None, :])
    uc = torch.clamp(u, 0.0, window - 1)
    vc = torch.clamp(v, 0.0, window - 1)
    depth = torch.where(inside, sample_grid(maps_w.depth, uc, vc),
                        depth_f)
    norm_fallback = torch.zeros(rf, rf, 3, device=dev)
    norm_fallback[..., 2] = -1.0
    norm_w = torch.stack([sample_grid(maps_w.normal[..., k], uc, vc)
                          for k in range(3)], dim=-1)
    norm_w = norm_w / torch.clamp(torch.linalg.vector_norm(
        norm_w, dim=-1, keepdim=True), min=1e-9)
    norm = torch.where(inside[..., None], norm_w, norm_fallback)
    valid_w = sample_grid(maps_w.valid.float(), uc, vc) > 0.5
    valid = torch.where(inside, valid_w, valid_f)
    return SurfaceMaps(depth=depth, normal=norm, valid=valid)


def axis_window(any_valid: torch.Tensor, rc: int, rf: int, scale: float,
                window: int):
    """Start (fine units, snapped to the stride lattice) and stride for one
    window axis, covering the subject's coarse-valid extent with margin.
    Both are 0-d device tensors: no host sync."""
    idx = torch.arange(rc, dtype=torch.float32, device=any_valid.device)
    lo = torch.where(any_valid, idx, torch.full_like(idx, float(rc))).min()
    hi = torch.where(any_valid, idx, torch.full_like(idx, -1.0)).max()
    has = hi >= lo
    lo = torch.where(has, lo, torch.zeros_like(lo))
    hi = torch.where(has, hi, torch.full_like(hi, rc - 1.0))
    margin = 1.5 * scale  # the crossing can sit +-1 coarse voxel out
    f_lo = torch.clamp(lo * scale - margin, min=0.0)
    f_hi = torch.clamp(hi * scale + margin, max=rf - 1.0)
    stride = torch.clamp((f_hi - f_lo) / (window - 1), min=1.0)
    center = (f_lo + f_hi) * 0.5
    start = center - stride * (window - 1) * 0.5
    start = torch.minimum(torch.clamp(start, min=0.0),
                          rf - 1 - stride * (window - 1))
    # an integer start when unstrided keeps the fit-in-window path an
    # exact gather
    start = torch.where(stride <= 1.0, torch.round(start), start)
    return start, stride


def ray_march(query_fn: Callable | None, res: int, balance_value: float = 0.5,
              b_min=(-1.0, -1.0, -1.0), b_max=(1.0, 1.0, 1.0),
              query_taps_fn: Callable | None = None,
              query_grid_fn: Callable | None = None,
              device=None) -> SurfaceMaps:
    """Dense first-crossing march: res^2 frontal rays x res z-taps ->
    SurfaceMaps with depth in res-voxel units."""
    device = torch.device(device or "cpu")
    b_min = f32_constant(b_min, device)
    step = (f32_constant(b_max, device) - b_min) / (res - 1)
    a = torch.arange(res, dtype=torch.float32, device=device)
    c_taps = a.expand(res, res, res)                          # [R, R, T]
    wz = ((res - 1) - c_taps) * step[2] + b_min[2]
    xw1 = a * step[0] + b_min[0]
    yw1 = a * step[1] + b_min[1]
    vals = _query_lattice(query_fn, query_taps_fn, query_grid_fn, xw1, yw1,
                          wz)
    z, hit, *_ = _first_crossing(vals, c_taps, balance_value)
    z = torch.where(hit, torch.clamp(z, 0.0, float(res)), torch.zeros_like(z))
    # coarse levels need no normals (the fine pass recomputes them)
    norm = torch.zeros(res, res, 3, device=device)
    norm[..., 2] = -1.0
    return SurfaceMaps(depth=z, normal=norm, valid=hit)


class PyramidStage(NamedTuple):
    """One stage of the march pyramid: the dense march at ``rf`` (``rc``
    None), or the refine of level ``level`` from ``rc`` to ``rf``, windowed
    by ``window`` (the last level's alone)."""
    rc: int | None
    rf: int
    level: int | None
    window: int | None

    def span(self) -> tuple:
        """(name, attributes) of the stage's span."""
        if self.rc is None:
            return "recon.march", {}
        return "recon.refine", {"from": self.rc, "to": self.rf}


def pyramid_stages(levels, fine_res: int,
                   window: int | None = None) -> list:
    """The ``PyramidStage``s of ``ray_pyramid``, in order: the march at
    levels[0], then a refine through each later level and ``fine_res``."""
    lv = list(levels) + [fine_res]
    last = len(levels) - 1
    return [PyramidStage(None, levels[0], None, None)] + [
        PyramidStage(rc, rf, i, window if i == last else None)
        for i, (rc, rf) in enumerate(zip(lv[:-1], lv[1:]))]


def run_stage(stage: PyramidStage, maps: SurfaceMaps | None,
              query_fn: Callable | None,
              query_taps_fn: Callable | None = None,
              query_grid_fn: Callable | None = None, taps: int = 6,
              balance_value: float = 0.5, b_min=(-1.0, -1.0, -1.0),
              b_max=(1.0, 1.0, 1.0), compact: float | None = None,
              telemetry: list | None = None,
              compact_state: list | None = None,
              device=None) -> SurfaceMaps:
    """One stage of the pyramid on the previous stage's ``maps`` (None for
    the march): ``ray_march`` or ``refine_from_maps`` (which documents the
    rest), under no span."""
    if stage.rc is None:
        return ray_march(query_fn, stage.rf, balance_value, b_min, b_max,
                         query_taps_fn=query_taps_fn,
                         query_grid_fn=query_grid_fn, device=device)
    return refine_from_maps(query_fn, maps, stage.rc, stage.rf, taps=taps,
                            balance_value=balance_value, b_min=b_min,
                            b_max=b_max, window=stage.window,
                            query_taps_fn=query_taps_fn,
                            query_grid_fn=query_grid_fn, compact=compact,
                            telemetry=telemetry, compact_state=compact_state)


def ray_pyramid(query_fn: Callable | None, fine_res: int, levels=(33, 65),
                taps: int = 6, balance_value: float = 0.5,
                b_min=(-1.0, -1.0, -1.0), b_max=(1.0, 1.0, 1.0),
                window: int | None = None,
                query_taps_fn=None,
                query_grid_fn: Callable | None = None,
                compact: float | None = None, march_taps: bool = True,
                telemetry: list | None = None,
                compact_state: list | None = None,
                device=None) -> SurfaceMaps:
    """Volume-free coarse-to-fine surface localization: dense march at
    levels[0], then ``refine_from_maps`` through the remaining levels and
    finally ``fine_res`` (with the optional bbox window), each stage
    (``pyramid_stages``) under its span.
    ``compact``: non-grid paths; each refine level queries just its
    coarse-valid rays at this budget fraction.
    ``march_taps``: give the dense march ``query_taps_fn`` too. False for
    the rotated anchored query, whose feature lerp holds only over the
    refine levels' short tap spans: the march then runs the exact
    per-point ``query_fn``.
    ``query_taps_fn`` may be a sequence of one fn (or None) per refine
    level (len(levels) entries: levels[0]->levels[1], ...,
    levels[-1]->fine_res): the anchored query picks its anchor count per
    level, and a level without one runs exact per-point.
    ``compact_state``: a list that receives the last level's
    ``RayCompaction`` when that level is windowed and compacted."""
    if isinstance(query_taps_fn, (list, tuple)):
        if march_taps:
            raise ValueError("per-level taps fns are refine-only (the march "
                             "has no entry)")
        if len(query_taps_fn) != len(levels):
            raise ValueError(f"{len(query_taps_fn)} taps fns for "
                             f"{len(levels)} refine levels")
        fns = list(query_taps_fn)
    else:
        fns = [query_taps_fn] * len(levels)
    maps = None
    for stage in pyramid_stages(levels, fine_res, window):
        if stage.rc is None:
            taps_fn = fns[0] if march_taps else None
        else:
            taps_fn = fns[stage.level]
        name, attrs = stage.span()
        with profiling.span(name, **attrs):
            maps = run_stage(stage, maps, query_fn, taps_fn, query_grid_fn,
                             taps=taps, balance_value=balance_value,
                             b_min=b_min, b_max=b_max, compact=compact,
                             telemetry=telemetry,
                             compact_state=compact_state, device=device)
    return maps


def sample_grid(img: torch.Tensor, xi: torch.Tensor,
                yi: torch.Tensor) -> torch.Tensor:
    """Separable bilinear sample of img [H, W] at the outer-product grid
    xi [h] x yi [w] (float indices, assumed in range) -> [h, w]."""
    h, w = img.shape
    x0 = torch.clamp(torch.floor(xi).long(), 0, h - 1)
    x1 = torch.clamp(x0 + 1, max=h - 1)
    fx = torch.clamp(xi - x0, 0.0, 1.0)
    rows = img[x0] * (1.0 - fx)[:, None] + img[x1] * fx[:, None]   # [h, W]
    y0 = torch.clamp(torch.floor(yi).long(), 0, w - 1)
    y1 = torch.clamp(y0 + 1, max=w - 1)
    fy = torch.clamp(yi - y0, 0.0, 1.0)
    return rows[:, y0] * (1.0 - fy)[None, :] + rows[:, y1] * fy[None, :]
