"""The reference frame of ``mode='dense'``: the exact full-volume path
(``configs/quality.yaml``), in plain PyTorch, float32 (TF32 off).

One frame: netG's backbone; the hierarchical occupancy volume (a frozen
plain copy of the hierarchy's selection rule); the depth peel of that
volume along the view axis; the normal shading; and with netC its
backbone on netG's last feature map as a prior and the colour of every
peeled lattice point.

The hierarchy, over ``resolutions`` r_0 < r_1 < ... (nested 2^k+1 grids,
``vol[z, y, x]``, the ray entering at z = r - 1):

1. every point of the r_0^3 lattice is queried;
2. each finer level upsamples the coarser volume trilinearly (exact on
   the nested grids: even indices copy, odd ones average), marks the
   voxels within ``boundary_tau`` of the iso-level, dilates the marks by
   a 3^3 box ``dilate`` times, and drops the voxels of the coarser
   lattice (all indices even), which are exact already: the candidates;
3. ``select='uncertain'`` orders the candidates within half of
   ``boundary_tau`` first and the rest after, each part in scan order
   (z-major, x fastest); ``'first'`` keeps scan order. The first
   ``budget`` of that order are queried and written into the volume;
   every other voxel keeps its upsampled value.

Besides a frame's maps and renders, ``sdf`` (the volume) and
``valid_margin`` (how far each ray's largest occupancy lies from the
iso-level, in the maps' layout) let ``harness/compare.py`` leave out the
knife edges of the silhouette and the volume.

The rows of each query (r_0^3, then each level's min(candidates, budget))
are the work this path needs for its image: ``queries`` turns them into
the head queries a frame runs, which ``harness/work.py`` counts.

Departures from the port's ``mode='dense'`` frame, none of them in what a
frame computes: the candidates are listed with ``nonzero`` and written by
index (the port ranks them with a prefix sum into a padded static batch of
``budget`` rows, and writes back through the rank field); the dilation is
a max-pool (the port's is separable shift-ors); every query runs the plain
head per point in blocks of ``HEAD_ROWS`` (the port's kernels run netG's
levels in one launch each and netC's colour as a separable grid query on
frontal calibs).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from cardbench.reference import recon
from cardbench.reference.nets import HEAD_ROWS, resize_axis


def _world(flat: torch.Tensor, r: int, b_min, b_max) -> torch.Tensor:
    """Flat positions of an r^3 volume (z-major, x fastest) -> world [N, 3]."""
    xyz = torch.stack([flat % r, (flat // r) % r, flat // (r * r)], dim=-1)
    lo = torch.tensor(b_min, dtype=torch.float32, device=flat.device)
    hi = torch.tensor(b_max, dtype=torch.float32, device=flat.device)
    return xyz.to(torch.float32) / (r - 1) * (hi - lo) + lo


def _dilate(mask: torch.Tensor, times: int) -> torch.Tensor:
    x = mask.float()[None, None]
    for _ in range(times):
        x = F.max_pool3d(x, 3, stride=1, padding=1)
    return x[0, 0] > 0


def depth_peel(vol: torch.Tensor, bal: float) -> recon.SurfaceMaps:
    """The first occupied voxel of each ray along -z (the largest occupied
    z index), its sub-voxel iso crossing against the voxel two steps
    nearer the viewer, and the normal from two-voxel backward differences
    in x, y and z; maps indexed [x, y]. A ray with no occupied voxel is
    invalid (its numbers are what the formulas give at z index 0)."""
    r = vol.shape[0]
    dev = vol.device
    ar = torch.arange(r, device=dev)
    top = torch.where(vol > bal, ar[:, None, None] + 1, 0).amax(dim=0)
    valid = top > 0
    i1 = torch.clamp(top - 1, min=0)
    c1 = (r - 1) - i1
    c2 = torch.clamp(c1 - 2, 0, r)
    i2 = (r - 1) - c2
    v1 = vol.gather(0, i1[None])[0]
    v2 = vol.gather(0, i2[None])[0]
    z = (c2.float() * (bal - v1) + c1.float() * (v2 - bal)) / (v2 - v1)
    z = torch.clamp(z, 0.0, float(r))
    back = torch.clamp(ar - 2, min=0)
    v3 = vol[i1, back[:, None], ar[None, :]]          # y - 2
    v4 = vol[i1, ar[:, None], back[None, :]]          # x - 2
    n = torch.stack([v4 - v1, v3 - v1, v2 - v1], dim=-1)
    n = n / torch.linalg.vector_norm(n, dim=-1, keepdim=True)
    return recon.SurfaceMaps(z.t(), n.transpose(0, 1), valid.t())


def queries(config: dict, calib: np.ndarray, rows) -> list:
    """(net, kind, rows, taps) of each head query of a frame whose
    hierarchy levels query ``rows`` points (``Frame.rows``): netG per
    point a level, then netC's colour at every lattice point of the last
    level (one tap a ray on a frontal calib's grid)."""
    out = [("netG", "point", int(n), 1) for n in rows]
    if "netC" in config:
        r = config["profile"]["hierarchy"]["resolutions"][-1]
        out.append(("netC", "ray" if recon.taps_ok(calib) else "point",
                    r * r, 1))
    return out


class Frame:
    def __init__(self, config: dict, nets: dict):
        p = config["profile"]
        h = p["hierarchy"]
        if h["select"] not in ("uncertain", "first"):
            raise ValueError(f"unknown selection {h['select']!r}")
        self.resolutions = tuple(h["resolutions"])
        self.budgets = tuple(h["budgets"])
        self.tau, self.dilate, self.select = (h["boundary_tau"], h["dilate"],
                                              h["select"])
        self.bal = p["balance_value"]
        self.b_min, self.b_max = tuple(p["b_min"]), tuple(p["b_max"])
        self.render_size = p["render_size"]
        self.netG = nets["netG"]
        self.netC = nets.get("netC")

    def plan(self, calib: np.ndarray, image_h: int) -> tuple:
        """No anchored level on this path."""
        return ()

    def hint_after(self, out: dict) -> float:
        """The hint this frame's answer gives the next (this path takes
        none: it compacts nothing)."""
        r = self.resolutions[-1]
        return recon.hint_from_valid(float(out["valid"].float().mean()), r,
                                     None)

    def _query(self, net, feats, calib_t, pts: torch.Tensor) -> torch.Tensor:
        """Per-point query of world points [N, 3] -> [N, C], HEAD_ROWS
        points a call."""
        parts = [net.query(feats, pts[None, i:i + HEAD_ROWS], calib_t)[0]
                 for i in range(0, pts.shape[0], HEAD_ROWS)]
        if not parts:
            return pts.new_zeros(0, 1)
        return torch.cat(parts)

    def volume(self, feats, calib_t):
        """(vol [R, R, R], rows of each query) of the hierarchy."""
        dev = calib_t.device
        r = self.resolutions[0]
        flat = torch.arange(r ** 3, device=dev)
        pts = _world(flat, r, self.b_min, self.b_max)
        vol = self._query(self.netG, feats, calib_t, pts)[:, 0].reshape(
            r, r, r)
        rows = [r ** 3]
        for res, budget in zip(self.resolutions[1:], self.budgets[1:]):
            for axis in range(3):
                vol = resize_axis(vol, axis, res, "bilinear")
            dist = torch.abs(vol - self.bal)
            even = torch.arange(res, device=dev) % 2 == 0
            coarse = even[:, None, None] & even[None, :, None] & even[None,
                                                                      None]
            cand = _dilate(dist < self.tau, self.dilate) & ~coarse
            if self.select == "uncertain":
                close = dist < self.tau * 0.5
                order = [cand & close, cand & ~close]
            else:
                order = [cand]
            sel = torch.cat([torch.nonzero(m.reshape(-1))[:, 0]
                             for m in order])[:budget]
            flat_vol = vol.reshape(-1).clone()
            flat_vol[sel] = self._query(
                self.netG, feats, calib_t,
                _world(sel, res, self.b_min, self.b_max))[:, 0]
            vol = flat_vol.reshape(res, res, res)
            rows.append(int(sel.shape[0]))
        return vol, tuple(rows)

    @torch.no_grad()
    def rows(self, image_g, calib: np.ndarray) -> tuple:
        """The rows of each hierarchy level's query for this image."""
        feats = self.netG.filter(image_g.float())
        return self.volume(feats, self._calib(calib, image_g.device))[1]

    @staticmethod
    def _calib(calib, device):
        return torch.as_tensor(np.asarray(calib, np.float32).reshape(1, 4, 4),
                               device=device)

    @torch.no_grad()
    def __call__(self, image_g, image_c, calib: np.ndarray, hint=None):
        calib_t = self._calib(calib, image_g.device)
        feats = self.netG.filter(image_g.float())
        vol, rows = self.volume(feats, calib_t)
        maps = depth_peel(vol, self.bal)
        out = {"depth": maps.depth, "valid": maps.valid, "sdf": vol,
               "rows": rows,
               "valid_margin": (vol.amax(dim=0) - self.bal).abs().t(),
               "render_norm": recon.visualize(recon.shade_normal(maps),
                                              self.render_size)}
        if self.netC is not None and image_c is not None:
            feats_c = self.netC.filter(image_c.float(), feats[-1])
            r = vol.shape[0]
            dev = vol.device
            lo = torch.tensor(self.b_min, dtype=torch.float32, device=dev)
            hi = torch.tensor(self.b_max, dtype=torch.float32, device=dev)
            step = (hi - lo) / r
            a = torch.arange(r, dtype=torch.float32, device=dev)
            pts = torch.stack([(a * step[0] + lo[0])[:, None].expand(r, r),
                               (a * step[1] + lo[1])[None, :].expand(r, r),
                               (float(r) - maps.depth) * step[2] + lo[2]],
                              dim=-1).reshape(-1, 3)
            color = self._query(self.netC, feats_c, calib_t, pts)
            canvas = color.reshape(r, r, 3) * 0.5 + 0.5
            canvas = torch.where(maps.valid[..., None], canvas,
                                 torch.ones_like(canvas))
            out["render_tex"] = recon.visualize(canvas, self.render_size)
        return out
