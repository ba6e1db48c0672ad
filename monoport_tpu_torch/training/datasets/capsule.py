"""3D capsule-human dataset — image + exact occupancy pairs, on the device
(port of ``monoport_tpu/training/datasets/capsule.py``).

A randomized articulated capsule body is rendered orthographically by a
first-crossing ray march along z, so the image and the 3D occupancy labels
are exactly consistent; occupancy samples follow the reference's
surface + uniform scheme (ppl_dynamic.py:262-298). Batches are made on the
training device, with no host transfer.

Every random generator is split in two: a draw from a ``torch.Generator``
(on the generator's device) and a deterministic builder from those draws
(``skeleton3d`` = ``skeleton_from_uniforms`` of 20 uniforms;
``clothe_from_uniforms``, ``appearance_from_uniforms``,
``points_from_draws``, ``surface_points_from_draws``). The builders take
the JAX package's own draws in the tests. Uniforms are mapped as JAX maps
them, ``u * (hi - lo) + lo`` in f32.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ...ops.constants import device_constant, float_array

_DEFAULT_BASE = (0.8, 0.65, 0.55)
_TWO_PI = 2.0 * math.pi
N_SEGMENTS = 10          # torso, head, two segments for each of 4 limbs


def _uniform(u: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    lo32, hi32 = np.float32(lo), np.float32(hi)
    return u * float(hi32 - lo32) + float(lo32)


def _rand(gen: torch.Generator, *shape) -> torch.Tensor:
    return torch.rand(shape, generator=gen, device=gen.device)


def _randn(gen: torch.Generator, *shape) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=gen.device)


def _randint(gen: torch.Generator, high: int, n: int) -> torch.Tensor:
    return torch.randint(0, high, (n,), generator=gen, device=gen.device)


def _norm(v: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(v, dim=-1, keepdim=True)


# -- bodies ----------------------------------------------------------------
def skeleton_from_uniforms(u: torch.Tensor, scale_range=(0.6, 1.0),
                           pose_spread: float = 1.0,
                           z_spread: float = 0.25):
    """20 uniforms in [0, 1) -> humanoid capsules (a [K,3], b [K,3], r [K])
    in [-1,1]^3. The defaults are the plain distribution the committed
    weights were first trained on; the "hard" curriculum widens
    scale_range, pose_spread and z_spread."""
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
        z1 = U(k0 + 2, -z_spread, z_spread)              # out of plane
        z2 = z1 + U(k0 + 3, -z_spread, z_spread)
        d1 = torch.stack([torch.cos(a1), torch.sin(a1), z1])
        d2 = torch.stack([torch.cos(a2), torch.sin(a2), z2])
        j1 = root + d1 / torch.linalg.vector_norm(d1) * (l1 * scale)
        j2 = j1 + d2 / torch.linalg.vector_norm(d2) * (l2 * scale)
        return [(root, j1, r * scale), (j1, j2, r * scale)]

    down = -math.pi / 2 + lean
    side = torch.stack([up[1], -up[0], zero])
    segs = [(pelvis, neck, torso_r), (head_c, head_c, head_r)]
    segs += limb(7, neck - side * (0.10 * scale), down - 0.5, 0.9,
                 0.26, 0.24, 0.05)
    segs += limb(11, neck + side * (0.10 * scale), down + 0.5, 0.9,
                 0.26, 0.24, 0.05)
    segs += limb(15, pelvis - side * (0.07 * scale), down - 0.1, 0.3,
                 0.30, 0.30, 0.065)
    # the second leg reuses uniforms 17-19 (the 20-draw budget)
    a1 = down + 0.1 + U(19, -0.3, 0.3)
    d1 = torch.stack([torch.cos(a1), torch.sin(a1), U(18, -0.25, 0.25)])
    hip = pelvis + side * (0.07 * scale)
    j1 = hip + d1 / torch.linalg.vector_norm(d1) * (0.30 * scale)
    j2 = j1 + torch.stack([torch.cos(a1 + 0.2), torch.sin(a1 + 0.2),
                           U(17, -0.25, 0.25)]) * (0.30 * scale)
    segs += [(hip, j1, 0.065 * scale), (j1, j2, 0.065 * scale)]

    a = torch.stack([s[0] for s in segs])
    b = torch.stack([s[1] for s in segs])
    r = torch.stack([s[2] for s in segs])
    return a, b, r


def skeleton3d(gen: torch.Generator, scale_range=(0.6, 1.0),
               pose_spread: float = 1.0, z_spread: float = 0.25):
    """Random humanoid capsules (``skeleton_from_uniforms``)."""
    return skeleton_from_uniforms(_rand(gen, 20), scale_range, pose_spread,
                                  z_spread)


def capsule_occupancy(pts: torch.Tensor, caps, sharpness: float = 200.0):
    """[..., 3] points x capsules -> soft occupancy in [0, 1].

    ``caps`` is (a, b, r) or the clothed 4-tuple of ``clothe``, whose 4th
    element (amp, freq, phase) modulates each capsule's radius along its
    axis (cloth-like folds; image and labels both come from here)."""
    a, b, r = caps[0], caps[1], caps[2]
    p = pts[..., None, :] - a                        # [..., K, 3]
    ab = b - a                                       # [K, 3]
    denom = torch.clamp((ab * ab).sum(-1), min=1e-9)
    t = torch.clamp((p * ab).sum(-1) / denom, 0.0, 1.0)
    r_eff = r
    if len(caps) == 4:
        amp, freq, phase = caps[3]
        r_eff = r * (1.0 + amp * torch.sin(freq * t + phase))
    d = torch.linalg.vector_norm(p - t[..., None] * ab, dim=-1) - r_eff
    return torch.sigmoid(-d.min(dim=-1).values * sharpness)


def clothe_from_uniforms(caps, u: torch.Tensor, amp=(0.0, 0.30)):
    """[3, K] uniforms -> the skeleton with radial displacement (clothing
    folds): relative amplitude in ``amp``, frequency 4-14 rad along the
    axis, phase 0-2 pi."""
    a, b, r = caps
    return (a, b, r, (_uniform(u[0], *amp), _uniform(u[1], 4.0, 14.0),
                      _uniform(u[2], 0.0, _TWO_PI)))


def clothe(gen: torch.Generator, caps, amp=(0.0, 0.30)):
    return clothe_from_uniforms(caps, _rand(gen, 3, caps[2].shape[0]), amp)


def _shade(z):
    """Depth-cue shading used by both the render and the colour labels."""
    return 0.35 + 0.65 * (z + 1.0) / 2.0


def appearance_from_uniforms(u: torch.Tensor) -> dict:
    """8 uniforms -> a body appearance: base colour and a world-(x, y)
    sinusoidal texture (amp may be ~0, so the plain look stays in the
    distribution). ``render_front`` and ``surface_color`` both read it."""
    return {"base": _uniform(u[0:3], 0.35, 0.9),
            "amp": _uniform(u[3], 0.0, 0.3),
            "freq": _uniform(u[4:6], 3.0, 15.0),
            "phase": _uniform(u[6:8], 0.0, _TWO_PI)}


def sample_appearance(gen: torch.Generator) -> dict:
    return appearance_from_uniforms(_rand(gen, 8))


def _pattern(xy, app):
    """Multiplicative texture over world (x, y) (front ortho view: image
    position == world position, so the pattern is view-consistent)."""
    if app is None:
        return 1.0
    return 1.0 + app["amp"] * (
        torch.sin(xy[..., 0:1] * app["freq"][0] + app["phase"][0])
        * torch.sin(xy[..., 1:2] * app["freq"][1] + app["phase"][1]))


def default_base(device) -> torch.Tensor:
    """The plain look's base colour on ``device`` (uploaded once: a
    per-call upload would synchronise the stream)."""
    return device_constant(float_array, (_DEFAULT_BASE,), device,
                           torch.float32)


def _base(base_color, appearance, device) -> torch.Tensor:
    if base_color is None:
        return (appearance["base"] if appearance is not None
                else default_base(device))
    if isinstance(base_color, torch.Tensor):
        return base_color
    return device_constant(float_array, (tuple(base_color),), device,
                           torch.float32)


def _flat_shade(flat, z: torch.Tensor):
    """1 where ``flat`` (a bool or a bool tensor), else the depth cue."""
    if isinstance(flat, torch.Tensor):
        return torch.where(flat, 1.0, _shade(z))
    return torch.ones_like(z) if flat else _shade(z)


def render_front_occ(occ_fn, size: int, n_march: int = 48, base_color=None,
                     appearance=None, flat=False, device=None):
    """Orthographic front render of any soft-occupancy field by
    first-crossing ray march along z. ``flat`` (a bool or a bool tensor)
    drops the depth-cue shading: a constant-colour silhouette.

    Returns (image [S,S,3] normalised to [-1,1] with the background 0 after
    masking, the netG input contract, and mask [S,S])."""
    ax = torch.linspace(-1.0, 1.0, size, device=device)
    yy, xx = torch.meshgrid(-ax, ax, indexing="ij")      # row 0 = top (+y)
    hit = torch.zeros((size, size), dtype=torch.bool, device=device)
    depth = torch.zeros((size, size), device=device)
    for z in torch.linspace(1.0, -1.0, n_march).tolist():
        occ = occ_fn(torch.stack([xx, yy, torch.full_like(xx, z)], -1)) > 0.5
        depth = torch.where(occ & ~hit, z, depth)        # first crossing
        hit = hit | occ
    shade = torch.where(hit, _flat_shade(flat, depth), 0.0)
    pat = _pattern(torch.stack([xx, yy], -1), appearance)
    base = _base(base_color, appearance, hit.device)
    image = torch.clamp(shade[..., None] * base * pat, 0.0, 1.0) * 2.0 - 1.0
    return image * hit[..., None], hit.float()


def render_front(caps, size: int, n_march: int = 48, base_color=None,
                 appearance=None, flat=False):
    """Capsule-body front render (``render_front_occ`` of
    ``capsule_occupancy``)."""
    return render_front_occ(lambda pts: capsule_occupancy(pts, caps),
                            size, n_march=n_march, base_color=base_color,
                            appearance=appearance, flat=flat,
                            device=caps[0].device)


def surface_color(pts, base_color=None, appearance=None, flat=False):
    """Ground-truth surface colour at [..., 3] points, normalised to
    [-1, 1]: the shading model ``render_front`` painted. ``flat`` drops
    the depth cue, as ``render_front_occ(flat=True)`` does."""
    base = _base(base_color, appearance, pts.device)
    pat = _pattern(pts[..., :2], appearance)
    shade = _flat_shade(flat, pts[..., 2:3])
    return torch.clamp(shade * base * pat, 0.0, 1.0) * 2.0 - 1.0


# -- point samples ---------------------------------------------------------
def surface_points_from_draws(caps, seg, t, noise):
    """Points on the capsule surfaces: capsule ``seg`` [n], axis position
    ``t`` [n, 1] in [0, 1), direction ``noise`` [n, 3] (normal draws)."""
    a, b, r = caps[0], caps[1], caps[2]
    on_axis = a[seg] + t * (b[seg] - a[seg])
    dirs = noise / torch.clamp(_norm(noise), min=1e-9)
    return on_axis + dirs * r[seg][:, None]


def sample_surface_points(gen: torch.Generator, caps, n: int):
    """n points on the capsule surfaces (colour supervision sites)."""
    return surface_points_from_draws(caps, _randint(gen, caps[0].shape[0], n),
                                     _rand(gen, n, 1), _randn(gen, n, 3))


def point_draws(gen: torch.Generator, n: int, k: int) -> dict:
    """The draws of ``sample_points``: 4/5 of n near the surface (capsule,
    axis position, direction, radial normal), the rest uniform."""
    n_surf = (n * 4) // 5
    return {"seg": _randint(gen, k, n_surf), "t": _rand(gen, n_surf, 1),
            "noise": _randn(gen, n_surf, 3),
            "radial": _randn(gen, n_surf, 1),
            "unif": _rand(gen, n - n_surf, 3)}


def points_from_draws(caps, draws: dict, sigma: float = 0.05):
    """Surface + uniform occupancy samples, 50/50 in/out in expectation
    (the ppl_dynamic.py:262-298 scheme, without host-side rejection):
    surface points moved +- a normal of ``sigma`` along their direction,
    and uniforms in [-1, 1]^3. -> (points [n, 3], labels [n, 1])."""
    a, b, r = caps[0], caps[1], caps[2]
    seg, noise = draws["seg"], draws["noise"]
    on_axis = a[seg] + draws["t"] * (b[seg] - a[seg])
    dirs = noise / torch.clamp(_norm(noise), min=1e-9)
    surf = on_axis + dirs * (r[seg][:, None] + draws["radial"] * sigma)
    unif = _uniform(draws["unif"], -1.0, 1.0)
    pts = torch.cat([surf, unif], dim=0)
    labels = (capsule_occupancy(pts, caps) > 0.5).float()
    return pts, labels[:, None]


def sample_points(gen: torch.Generator, caps, n: int, sigma: float = 0.05):
    return points_from_draws(caps, point_draws(gen, n, caps[0].shape[0]),
                             sigma)


def gt_texture_canvas(depth, valid, resolution: int, base_color=None,
                      appearance=None, flat=False):
    """Ground-truth texture canvas for an engine ray-map pair: the GT
    surface colours at the reconstructed surface points, white background
    (the voxel -> world map of ``depth_peel.surface_world_points``)."""
    r = resolution
    sr = 2.0 / r
    a = torch.arange(r, dtype=torch.float32, device=depth.device) * sr - 1.0
    pts = torch.stack([a[:, None].expand(r, r), a[None, :].expand(r, r),
                       (float(r) - depth) * sr - 1.0], -1)
    gt = surface_color(pts, base_color, appearance, flat=flat) * 0.5 + 0.5
    return torch.where(valid[..., None], gt, 1.0)


# -- items and batches -----------------------------------------------------
def synth_item(gen: torch.Generator, size: int, n_points: int,
               hard: bool = False, sigma: float | None = None,
               flat_prob: float = 0.0) -> dict:
    """-> dict(image [S,S,3], points [N,3], labels [N,1], calib [4,4]).

    hard=True: the curriculum of the committed netG: wider scales
    (0.45-1.0), harder poses, more out-of-plane motion, clothing folds and
    a textured appearance, with surface sigma 0.035 (else 0.05).
    flat_prob: the share rendered without depth shading."""
    if hard:
        caps = skeleton3d(gen, scale_range=(0.45, 1.0), pose_spread=1.35,
                          z_spread=0.35)
        caps = clothe(gen, caps, amp=(0.0, 0.30))
        app = sample_appearance(gen)
        sigma = 0.035 if sigma is None else sigma
    else:
        caps = skeleton3d(gen)
        app = None
        sigma = 0.05 if sigma is None else sigma
    flat = (_rand(gen) < flat_prob) if flat_prob > 0 else False
    image, _ = render_front(caps, size, appearance=app, flat=flat)
    pts, labels = sample_points(gen, caps, n_points, sigma=sigma)
    return {"image": image, "points": pts, "labels": labels,
            "calib": torch.eye(4, device=gen.device)}


def stack_items(items: list) -> dict:
    """Items -> the train-step batch dict (images/points/calibs/labels)."""
    return {"images": torch.stack([it["image"] for it in items]),
            "points": torch.stack([it["points"] for it in items]),
            "calibs": torch.stack([it["calib"] for it in items]),
            "labels": torch.stack([it["labels"] for it in items])}


def synth_train_batch(gen: torch.Generator, batch: int, size: int,
                      n_points: int, hard: bool = False,
                      sigma: float | None = None) -> dict:
    """Train-step batch dict, made on the generator's device."""
    return stack_items([synth_item(gen, size, n_points, hard=hard,
                                   sigma=sigma) for _ in range(batch)])
