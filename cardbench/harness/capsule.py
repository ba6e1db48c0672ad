"""The benchmark's capsule bodies: a frozen copy of the articulated
capsule-human generator and its orthographic front render, in plain
PyTorch on the device.

A body is 20 uniforms for the skeleton (10 capsules: torso, head, two
segments a limb), 30 for its clothing folds (amplitude, frequency and
phase of each capsule's radius along its axis) and 8 for its appearance
(base colour and a sinusoidal pattern over world x, y). The render marches
48 depth planes from z = +1 and keeps each ray's first crossing of the
soft occupancy, shaded by depth. Image and occupancy come from the same
field, so the image is what the nets were trained on.
"""

from __future__ import annotations

import math

import numpy as np
import torch

N_SEGMENTS = 10
N_UNIFORMS = 20 + 3 * N_SEGMENTS + 8


def _uniform(u, lo, hi):
    lo32, hi32 = np.float32(lo), np.float32(hi)
    return u * float(hi32 - lo32) + float(lo32)


def skeleton(u, scale_range, pose_spread, z_spread):
    """20 uniforms -> capsules (a [K, 3], b [K, 3], r [K]) in [-1, 1]^3."""
    zero = u.new_zeros(())

    def U(k, lo, hi):
        return _uniform(u[k], lo, hi)

    scale = U(0, *scale_range)
    pelvis = torch.stack([U(1, -0.25, 0.25), U(2, -0.35, 0.0),
                          U(3, -0.15, 0.15)])
    lean = U(4, -0.2 * pose_spread, 0.2 * pose_spread)
    up = torch.stack([-torch.sin(lean), torch.cos(lean), zero])
    neck = pelvis + up * (0.52 * scale)
    head_c = neck + up * (0.16 * scale)
    torso_r = U(5, 0.13, 0.19) * scale
    head_r = U(6, 0.09, 0.12) * scale

    def limb(k0, root, base_angle, spread, l1, l2, r):
        spread = spread * pose_spread
        a1 = base_angle + U(k0, -spread, spread)
        a2 = a1 + U(k0 + 1, -0.8 * pose_spread, 0.8 * pose_spread)
        z1 = U(k0 + 2, -z_spread, z_spread)
        z2 = z1 + U(k0 + 3, -z_spread, z_spread)
        d1 = torch.stack([torch.cos(a1), torch.sin(a1), z1])
        d2 = torch.stack([torch.cos(a2), torch.sin(a2), z2])
        j1 = root + d1 / torch.linalg.vector_norm(d1) * (l1 * scale)
        j2 = j1 + d2 / torch.linalg.vector_norm(d2) * (l2 * scale)
        return [(root, j1, r * scale), (j1, j2, r * scale)]

    down = -math.pi / 2 + lean
    side = torch.stack([up[1], -up[0], zero])
    segs = [(pelvis, neck, torso_r), (head_c, head_c, head_r)]
    segs += limb(7, neck - side * (0.10 * scale), down - 0.5, 0.9, 0.26, 0.24,
                 0.05)
    segs += limb(11, neck + side * (0.10 * scale), down + 0.5, 0.9, 0.26,
                 0.24, 0.05)
    segs += limb(15, pelvis - side * (0.07 * scale), down - 0.1, 0.3, 0.30,
                 0.30, 0.065)
    a1 = down + 0.1 + U(19, -0.3, 0.3)
    d1 = torch.stack([torch.cos(a1), torch.sin(a1), U(18, -0.25, 0.25)])
    hip = pelvis + side * (0.07 * scale)
    j1 = hip + d1 / torch.linalg.vector_norm(d1) * (0.30 * scale)
    j2 = j1 + torch.stack([torch.cos(a1 + 0.2), torch.sin(a1 + 0.2),
                           U(17, -0.25, 0.25)]) * (0.30 * scale)
    segs += [(hip, j1, 0.065 * scale), (j1, j2, 0.065 * scale)]
    return (torch.stack([s[0] for s in segs]), torch.stack([s[1] for s in segs]),
            torch.stack([s[2] for s in segs]))


def occupancy(pts, caps, sharpness: float = 200.0):
    """[..., 3] points -> soft occupancy of the clothed capsules."""
    a, b, r, (amp, freq, phase) = caps
    p = pts[..., None, :] - a
    ab = b - a
    t = torch.clamp((p * ab).sum(-1) / torch.clamp((ab * ab).sum(-1),
                                                   min=1e-9), 0.0, 1.0)
    r_eff = r * (1.0 + amp * torch.sin(freq * t + phase))
    d = torch.linalg.vector_norm(p - t[..., None] * ab, dim=-1) - r_eff
    return torch.sigmoid(-d.min(dim=-1).values * sharpness)


def render_front(caps, app: dict, size: int, n_march: int = 48):
    """-> image [S, S, 3] in [-1, 1], 0 outside the silhouette."""
    dev = caps[0].device
    ax = torch.linspace(-1.0, 1.0, size, device=dev)
    yy, xx = torch.meshgrid(-ax, ax, indexing="ij")
    hit = torch.zeros((size, size), dtype=torch.bool, device=dev)
    depth = torch.zeros((size, size), device=dev)
    for z in np.linspace(1.0, -1.0, n_march, dtype=np.float32).tolist():
        occ = occupancy(torch.stack([xx, yy, torch.full_like(xx, z)], -1),
                        caps) > 0.5
        depth = torch.where(occ & ~hit, z, depth)
        hit = hit | occ
    shade = torch.where(hit, 0.35 + 0.65 * (depth + 1.0) / 2.0, 0.0)
    pat = 1.0 + app["amp"] * (torch.sin(xx[..., None] * app["freq"][0]
                                        + app["phase"][0])
                              * torch.sin(yy[..., None] * app["freq"][1]
                                          + app["phase"][1]))
    image = torch.clamp(shade[..., None] * app["base"] * pat, 0.0, 1.0)
    return (image * 2.0 - 1.0) * hit[..., None]


def body(u, spec: dict):
    """``N_UNIFORMS`` uniforms -> (clothed capsules, appearance) under the
    traffic's body distribution ``spec``."""
    a, b, r = skeleton(u[:20], spec["scale_range"], spec["pose_spread"],
                       spec["z_spread"])
    c = u[20:50].reshape(3, N_SEGMENTS)
    caps = (a, b, r, (_uniform(c[0], *spec["cloth_amp"]),
                      _uniform(c[1], 4.0, 14.0),
                      _uniform(c[2], 0.0, 2.0 * math.pi)))
    v = u[50:58]
    app = {"base": _uniform(v[0:3], 0.35, 0.9), "amp": _uniform(v[3], 0.0, 0.3),
           "freq": _uniform(v[4:6], 3.0, 15.0),
           "phase": _uniform(v[6:8], 0.0, 2.0 * math.pi)}
    return caps, app
