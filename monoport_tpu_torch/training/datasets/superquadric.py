"""Superquadric-limb human bodies — a procedural family disjoint from the
capsule generator, on the device (port of
``monoport_tpu/training/datasets/superquadric.py``).

A body reuses the capsule skeleton (segment endpoints + radii) but replaces
every capsule with a superquadric,
    F = ((|x/ax|^(2/e2) + |y/ay|^(2/e2))^(e2/e1) + |z/az|^(2/e1)) <= 1,
in the segment's local frame (z along the bone): e2 < 1 squares the
cross-section, e1 < 1 flattens the end-caps. Occupancy is exact, so labels
are free. ``mixed_train_batch`` is the committed netC's curriculum: half
capsule, half superquadric bodies.

As in ``capsule``, each generator is a draw from a ``torch.Generator`` and
a deterministic builder (``sq_body_from_uniforms``,
``surface_points_from_draws``, ``points_from_draws``).
"""

from __future__ import annotations

import numpy as np
import torch

from ...ops.constants import device_constant
from .capsule import (N_SEGMENTS, _rand, _randint, _randn, _uniform,
                      render_front_occ, sample_appearance,
                      skeleton_from_uniforms, stack_items,
                      synth_item as capsule_item)


def sq_body_from_uniforms(u_skel: torch.Tensor, u_shape: torch.Tensor,
                          scale_range=(0.5, 1.0), pose_spread: float = 1.2,
                          z_spread: float = 0.3, e_range=(0.4, 1.6),
                          aniso_range=(0.7, 1.4)) -> dict:
    """20 skeleton uniforms and [4, K] shape uniforms -> a body: a/b [K,3]
    segment endpoints, r [K] base radii, e1/e2 [K] exponents, aniso [K]
    cross-section x/y anisotropy, elong [K] end-cap extension."""
    a, b, r = skeleton_from_uniforms(u_skel, scale_range, pose_spread,
                                     z_spread)
    return {"a": a, "b": b, "r": r,
            "e1": _uniform(u_shape[0], *e_range),
            "e2": _uniform(u_shape[1], *e_range),
            "aniso": _uniform(u_shape[2], *aniso_range),
            "elong": _uniform(u_shape[3], 1.0, 1.25)}


def sq_body(gen: torch.Generator, **kwargs) -> dict:
    """A random superquadric humanoid (``sq_body_from_uniforms``)."""
    u_skel = _rand(gen, 20)
    return sq_body_from_uniforms(u_skel, _rand(gen, 4, N_SEGMENTS), **kwargs)


def _eye3() -> np.ndarray:
    return np.eye(3, dtype=np.float32)


def _frames(body):
    """Per-segment orthonormal frames (t1, t2, w) and half-axes."""
    a, b, r = body["a"], body["b"], body["r"]
    ex, ey, ez = device_constant(_eye3, (), a.device, torch.float32)
    ab = b - a
    length = torch.linalg.vector_norm(ab, dim=-1, keepdim=True)   # [K, 1]
    w = ab / torch.clamp(length, min=1e-9)
    # degenerate (point) segments, the head, get a vertical axis
    w = torch.where(length > 1e-6, w, ey)
    up = torch.where(torch.abs(w[..., 2:3]) < 0.9, ez, ex)
    t1 = torch.linalg.cross(w, up)
    t1 = t1 / torch.clamp(torch.linalg.vector_norm(t1, dim=-1, keepdim=True),
                          min=1e-9)
    t2 = torch.linalg.cross(w, t1)
    half = length[..., 0] / 2.0
    ax = r * body["aniso"]
    ay = r / torch.sqrt(body["aniso"])
    az = half * body["elong"] + r
    return t1, t2, w, ax, ay, az


def sq_occupancy(pts: torch.Tensor, body: dict, sharpness: float = 12.0):
    """[..., 3] points x superquadric segments -> soft occupancy [0, 1];
    its 0.5 level set is the analytic surface (F = 1)."""
    t1, t2, w, ax, ay, az = _frames(body)
    c = (body["a"] + body["b"]) / 2.0                          # [K, 3]
    p = pts[..., None, :] - c                                  # [..., K, 3]
    x = torch.abs((p * t1).sum(-1)) / ax + 1e-9
    y = torch.abs((p * t2).sum(-1)) / ay + 1e-9
    z = torch.abs((p * w).sum(-1)) / az + 1e-9
    e1, e2 = body["e1"], body["e2"]
    f = (x ** (2.0 / e2) + y ** (2.0 / e2)) ** (e2 / e1) + z ** (2.0 / e1)
    return torch.sigmoid((1.0 - f.min(dim=-1).values) * sharpness)


def render_front(body: dict, size: int, n_march: int = 48, base_color=None,
                 appearance=None, flat=False):
    """Front render of a superquadric body (the netG input contract)."""
    return render_front_occ(lambda pts: sq_occupancy(pts, body), size,
                            n_march=n_march, base_color=base_color,
                            appearance=appearance, flat=flat,
                            device=body["a"].device)


def surface_points_from_draws(body: dict, seg, t, d):
    """Points on the body surface: from the axis point of segment ``seg``
    [n] at ``t`` [n, 1], along direction ``d`` [n, 3] (normal draws), to
    the F = 1 crossing by 18 bisection steps (to ~1e-3)."""
    a, b = body["a"], body["b"]
    on_axis = a[seg] + t * (b[seg] - a[seg])
    d = d / torch.clamp(torch.linalg.vector_norm(d, dim=-1, keepdim=True),
                        min=1e-9)
    lo = torch.zeros(d.shape[0], device=d.device)
    hi = torch.ones(d.shape[0], device=d.device)
    for _ in range(18):
        mid = (lo + hi) / 2.0
        ins = sq_occupancy(on_axis + mid[:, None] * d, body) > 0.5
        lo, hi = torch.where(ins, mid, lo), torch.where(ins, hi, mid)
    return on_axis + ((lo + hi) / 2.0)[:, None] * d


def surface_draws(gen: torch.Generator, n: int, k: int) -> dict:
    return {"seg": _randint(gen, k, n), "t": _rand(gen, n, 1),
            "d": _randn(gen, n, 3)}


def sample_surface_points(gen: torch.Generator, body: dict, n: int):
    """n points on the body surface (netC's colour supervision sites)."""
    return surface_points_from_draws(
        body, **surface_draws(gen, n, body["r"].shape[0]))


def points_from_draws(body: dict, draws: dict, sigma: float = 0.035):
    """Surface + uniform occupancy samples: 4/5 near the surface (surface
    points plus a normal [n, 3] of ``sigma``), 1/5 uniform in [-1, 1]^3.
    -> (points [n, 3], labels [n, 1])."""
    surf = surface_points_from_draws(body, **draws["surface"])
    surf = surf + draws["radial"] * sigma
    unif = _uniform(draws["unif"], -1.0, 1.0)
    pts = torch.cat([surf, unif], dim=0)
    labels = (sq_occupancy(pts, body) > 0.5).float()
    return pts, labels[:, None]


def sample_points(gen: torch.Generator, body: dict, n: int,
                  sigma: float = 0.035):
    n_surf = (n * 4) // 5
    draws = {"surface": surface_draws(gen, n_surf, body["r"].shape[0]),
             "radial": _randn(gen, n_surf, 3),
             "unif": _rand(gen, n - n_surf, 3)}
    return points_from_draws(body, draws, sigma)


def synth_item(gen: torch.Generator, size: int, n_points: int,
               sigma: float = 0.035, flat_prob: float = 0.25) -> dict:
    """One superquadric training item (``capsule.synth_item``'s dict); a
    ``flat_prob`` share is rendered without depth shading."""
    body = sq_body(gen)
    app = sample_appearance(gen)
    flat = _rand(gen) < flat_prob
    image, _ = render_front(body, size, appearance=app, flat=flat)
    pts, labels = sample_points(gen, body, n_points, sigma=sigma)
    return {"image": image, "points": pts, "labels": labels,
            "calib": torch.eye(4, device=gen.device)}


def synth_train_batch(gen: torch.Generator, batch: int, size: int,
                      n_points: int, sigma: float = 0.035,
                      flat_prob: float = 0.25) -> dict:
    return stack_items([synth_item(gen, size, n_points, sigma, flat_prob)
                        for _ in range(batch)])


def mixed_train_batch(gen: torch.Generator, batch: int, size: int,
                      n_points: int, sigma: float | None = None,
                      flat_prob: float = 0.15) -> dict:
    """The cross-family curriculum batch: max(1, batch // 2) hard-capsule
    items, then superquadric ones, each with a ``flat_prob`` shading-free
    share."""
    n_caps = max(1, batch // 2)
    items = [capsule_item(gen, size, n_points, hard=True, sigma=sigma,
                          flat_prob=flat_prob) for _ in range(n_caps)]
    items += [synth_item(gen, size, n_points,
                         sigma if sigma is not None else 0.035, flat_prob)
              for _ in range(batch - n_caps)]
    return stack_items(items)
